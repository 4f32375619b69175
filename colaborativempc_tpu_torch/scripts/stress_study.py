"""Closed-loop robustness studies: full course, perturbed starts, latency
and the Jacobi / Gauss-Seidel trade-off; the port of the JAX package's
``scripts/stress_study.py``.

The reference validates its planners only on the canonical golden starts
(``planner/scripts/*_main.py`` with the x0 database); these studies keep
the hard-window behaviour (the Highway k=0.35 curve congestion), the
stressed-start boundary and the long-horizon latency schedule
reproducible:

- ``full-course``: one flagship run to course completion (LPV or NL-OCD,
  any coupling), reporting bad steps (solves above the feasibility
  tolerance — held, not executed, when hold_on_infeasible), plan-hold
  counts, completion and latency percentiles.
- ``perturbed``: jittered cold starts at the curve-2 entry (s ~ 15-16.5),
  one run per start, or with ``--batched`` all starts as one batch of
  fleets rolled out in chunks of ``--chunk`` steps.
- ``latency``: warm per-step latency percentiles of the single-fleet
  schedule.
- ``gs-tradeoff``: Jacobi against Gauss-Seidel over a batch of fleets that
  share one gain set: mean OCD iterations and fleet-steps/s.

Each study prints one JSON line per run with the JAX script's keys;
``backend`` is the torch device type, ``dispatch_floor_ms`` the
synchronised time of a trivial operation on the device. On a CUDA device
every ADMM epoch is the epoch kernel, whatever ``--variant`` says:
``assoc`` and ``seq`` differ only on the CPU.

    python -m colaborativempc_tpu_torch.scripts.stress_study full-course \\
        --family nl-eu --n 125 --steps 700
    python -m colaborativempc_tpu_torch.scripts.stress_study perturbed \\
        --starts 8 --steps 550 --batched
    python -m colaborativempc_tpu_torch.scripts.stress_study latency \\
        --family nl-eu --n 125 --steps 100

``--device`` defaults to ``cuda`` and raises when there is no card;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def _mk_cfg(family: str, N: int, steps: int, admm_iters=None,
            assoc=None, eps=1e-4, hold=True, ladder=True,
            sep_filter=True, vx_pass=True):
    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, OCDConfig, SolverConfig, lpv_gains, nl_gains,
    )
    # sqp_iters=2 for the NL families, as nl_main and monte_carlo: a 3-deep
    # SQP with 0.7 mixing keeps the trajectory jittering just above the OCD
    # tolerance and the loop runs to its cap
    solver = SolverConfig(admm_iters=admm_iters, assoc=assoc, eps=eps,
                          sqp_iters=2 if family.startswith("nl") else 3)
    base = dict(N=N, n_agents=3, dt=0.025, map_type="Highway",
                max_it=steps, laps=1, hold_on_infeasible=hold,
                hold_reset_k=3 if ladder else None,
                hold_cold_k=6 if ladder else None,
                exec_sep_frac=0.7 if sep_filter else None,
                hold_vx_frac=0.6 if vx_pass else None,
                solver=solver)
    if family == "lpv":
        return ExperimentConfig(**base, gains=lpv_gains())
    coupling = {"nl-eu": "eu", "nl-hp": "hp", "nl-hp_opt": "hp_opt"}[family]
    return ExperimentConfig(**base, gains=nl_gains(), coupling=coupling,
                            ocd=OCDConfig(max_it_ocd=30))


def _variant_cfg(args, **kw):
    return _mk_cfg(args.family, args.n, args.steps,
                   assoc=None if args.variant == "auto"
                   else (args.variant == "assoc"),
                   sep_filter=not args.no_filter,
                   vx_pass=not args.no_vxpass, **kw)


def _run(family: str, cfg, device, x0s=None):
    from colaborativempc_tpu_torch.runtime import (
        run_lpv_experiment, run_nl_experiment,
    )
    if family.startswith("nl"):
        return run_nl_experiment(cfg, x0s=x0s, device=device)
    return run_lpv_experiment(cfg, x0s=x0s, device=device)


def dispatch_floor_ms(device) -> float:
    """Synchronised milliseconds of a trivial operation on ``device``: the
    mean of 5 calls after a warm one (the per-step floor of launch and
    synchronisation)."""
    from colaborativempc_tpu_torch.utils import synchronize
    z = torch.zeros((), device=device) + 1.0
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(5):
        z = z + 1.0
        synchronize(device)
    return (time.perf_counter() - t0) / 5 * 1e3


def _track_length(cfg, device) -> float:
    from colaborativempc_tpu_torch.geometry import make_track
    return float(make_track(cfg.map_type, device=device)
                 .track_length[cfg.lane])


def _report(name, cfg, res, t_wall, device):
    L = _track_length(cfg, device)
    s_final = np.asarray(res.states[-1][:, 6]) if res.steps else np.zeros(3)
    feas = np.asarray(res.feasible)
    bad = int((~feas.all(axis=1)).sum())
    holds = bad if cfg.hold_on_infeasible else 0
    times = np.asarray(res.step_times)
    warm = times[3:] if len(times) > 6 else times
    # the LPV result records ADMM iterations; the NL result, OCD iterations
    iters = getattr(res, "iterations", None)
    beta, wall = np.asarray(res.exec_beta), np.asarray(res.wall_clip)
    out = {
        "study": name,
        "backend": device.type,
        "steps": int(res.steps),
        "finished": bool(res.finished),
        "complete_all": bool(res.finished
                             and np.isfinite(s_final).all()
                             and (s_final >= 0.8 * L).all()),
        "s_final": [round(float(s), 2) for s in s_final],
        "bad_steps": bad,
        "held_steps": holds,
        "min_dist_exec": round(float(np.asarray(res.min_dist_exec).min()), 4)
        if res.steps else None,
        "p50_ms": round(float(np.percentile(warm, 50)) * 1e3, 1),
        "p95_ms": round(float(np.percentile(warm, 95)) * 1e3, 1),
        "max_ms": round(float(warm.max()) * 1e3, 1),
        "dispatch_floor_ms": round(dispatch_floor_ms(device), 4),
        "wall_s": round(t_wall, 1),
        # separation-filter activity: steps where any agent was braked
        "filter_steps": int((beta < 1.0).any(axis=1).sum())
        if beta.size else 0,
        "min_beta": round(float(beta.min()), 3) if beta.size else 1.0,
        "wall_steps": int(wall.any(axis=1).sum()) if wall.size else 0,
    }
    if iters is not None and np.asarray(iters).size:
        it_arr = np.asarray(iters, float)
        out["it_mean"] = round(float(it_arr.mean()), 1)
        out["it_max"] = int(it_arr.max())
    print(json.dumps(out), flush=True)
    return out


def full_course(args, device):
    cfg = _variant_cfg(args, hold=not args.no_hold, ladder=not args.no_ladder)
    t0 = time.time()
    res = _run(args.family, cfg, device)
    return _report(f"full-course/{args.family}/N={args.n}", cfg, res,
                   time.time() - t0, device)


def _perturbed_x0s(cfg, rng):
    from colaborativempc_tpu_torch.config import x0_database
    x0s = np.asarray(x0_database(cfg.n_agents)).copy()
    x0s[:, 6] = 15.0 + rng.uniform(0.0, 1.5, size=cfg.n_agents)
    return x0s


def perturbed_batched(args, cfg, device):
    """All jittered starts as one batch of fleets, rolled out in chunks of
    ``--chunk`` steps with the state carried between them (the trajectory
    of one long rollout). Completion is evaluated from the s-history: a
    start completes when at some step one agent has crossed the lap length
    while all agents are finite and past 0.8 L — NaNs after a completed lap
    on the open Highway do not undo it, matching the host loop's
    stop-at-finish semantics."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.runtime import (
        init_lpv_fleet, init_nl_fleet, make_lpv_fleet_rollout,
        make_nl_ocd_rollout, resolve_single_fleet_schedule,
    )
    from colaborativempc_tpu_torch.utils import synchronize
    nl = args.family.startswith("nl")
    cfg = resolve_single_fleet_schedule(cfg)
    track = make_track(cfg.map_type, device=device)
    rng = np.random.default_rng(args.seed)
    chunk = max(1, min(args.steps, args.chunk))
    n_chunks = -(-args.steps // chunk)
    init, make = ((init_nl_fleet, make_nl_ocd_rollout) if nl
                  else (init_lpv_fleet, make_lpv_fleet_rollout))
    starts = [init(track, cfg, x0s=_perturbed_x0s(cfg, rng), device=device)
              for _ in range(args.starts)]
    state = type(starts[0])(*(torch.stack(f) for f in zip(*starts)))
    roll = make(track, cfg, chunk)
    t0 = time.time()
    hists = []
    for _ in range(n_chunks):
        state, hist = roll(state)
        hists.append(hist)
    synchronize(device)
    x0h = np.concatenate([h[0].cpu().numpy() for h in hists], axis=1)
    m = type(hists[0][2])(*(
        np.concatenate([h[2][i].cpu().numpy() for h in hists], axis=1)
        for i in range(len(hists[0][2]))))
    # trim the chunk-padded tail so a non-dividing --chunk reports exactly
    # --steps (metrics stay comparable to the host-loop study)
    x0h = x0h[:, :args.steps]
    m = type(m)(*(v[:, :args.steps] for v in m))
    steps_run = min(n_chunks * chunk, args.steps)
    t_wall = time.time() - t0
    L = float(track.track_length[cfg.lane])
    s = x0h[..., 6]                                  # (S, steps, n_ag)
    finite = np.isfinite(x0h).all(axis=(2, 3))       # (S, steps)
    done = (finite & (s.max(axis=2) >= L * cfg.laps)
            & (s.min(axis=2) >= 0.8 * L))            # (S, steps)
    complete = done.any(axis=1)
    t_done = np.where(complete, done.argmax(axis=1), steps_run)
    feas = m.feasible                                # (S, steps, n_ag)
    alive = np.arange(steps_run)[None, :] <= t_done[:, None]
    held = ((~feas.all(axis=2)) & alive).sum(axis=1)
    # mask non-finite rows (a diverged incomplete start carries NaN) so the
    # min stays finite and the JSON stays strict-parser-valid
    mde = np.where(alive & np.isfinite(m.min_dist_exec), m.min_dist_exec,
                   np.inf).min(axis=1)
    out = {
        "study": f"perturbed-batched/{args.family}/{args.variant}",
        "backend": device.type,
        "starts": args.starts, "steps": steps_run, "N": cfg.N,
        "chunk": chunk,
        "complete": int(complete.sum()),
        "t_complete": t_done.tolist(),
        "held_steps": held.tolist(),
        "min_dist_exec": [round(float(d), 4) if np.isfinite(d) else None
                          for d in mde],
        "filter_steps": ((m.exec_beta < 1.0).any(axis=2)
                         & alive).sum(axis=1).tolist(),
        # worst lateral excursion while alive: an agent ejected from the
        # corridor can still "complete" by arc progress
        "max_abs_ey": [round(float(e), 2) for e in np.where(
            alive[:, :, None], np.abs(x0h[..., 3]), 0.0).max(axis=(1, 2))],
        "wall_steps": (m.wall_clip.any(axis=2) & alive).sum(axis=1).tolist(),
        "wall_s": round(t_wall, 1),
    }
    print(json.dumps(out), flush=True)
    return out


def perturbed(args, device):
    """Jittered cold starts at the curve-2 entry (the stressed boundary):
    base x0 rows with s shifted to 15 + U(0, 1.5) per agent."""
    cfg = _variant_cfg(args, hold=not args.no_hold, ladder=not args.no_ladder)
    if args.batched:
        return perturbed_batched(args, cfg, device)
    rng = np.random.default_rng(args.seed)
    rows = []
    for k in range(args.starts):
        x0s = _perturbed_x0s(cfg, rng)
        t0 = time.time()
        res = _run(args.family, cfg, device, x0s=x0s)
        rows.append(_report(
            f"perturbed[{k}]/{args.family}/{args.variant}", cfg, res,
            time.time() - t0, device))
    print(json.dumps({"study": f"perturbed/{args.family}/{args.variant}",
                      "complete": sum(int(r["complete_all"]) for r in rows),
                      "starts": args.starts,
                      "held_steps": [r["held_steps"] for r in rows]}),
          flush=True)
    return rows


def latency(args, device):
    cfg = dataclasses.replace(_variant_cfg(args), laps=10**6)  # fixed-step
    t0 = time.time()
    res = _run(args.family, cfg, device)
    return _report(f"latency/{args.family}/N={args.n}/{args.variant}", cfg,
                   res, time.time() - t0, device)


def gs_tradeoff(args, device):
    """Jacobi vs Gauss-Seidel over a batch of fleets: Gauss-Seidel
    serialises the agents within a coordination iteration but uses fresher
    neighbour plans, so it needs fewer OCD iterations; Jacobi solves all
    agents as one batch. Prints both sides: mean OCD iterations and time
    per control step of the batch, every fleet sharing one gain set."""
    from colaborativempc_tpu_torch.config import OCDConfig, nl_gains
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.parallel import batch_fleet_state
    from colaborativempc_tpu_torch.runtime import (
        init_nl_fleet, make_nl_ocd_rollout_gains,
    )
    from colaborativempc_tpu_torch.utils import synchronize
    steps, B = args.steps, args.batch
    rows = []
    for sweep in ("jacobi", "gauss_seidel"):
        cfg = _mk_cfg(args.family if args.family.startswith("nl")
                      else "nl-eu", args.n, steps)
        cfg = dataclasses.replace(cfg, ocd=OCDConfig(max_it_ocd=30,
                                                     sweep=sweep))
        track = make_track(cfg.map_type, device=device)
        rollout = make_nl_ocd_rollout_gains(track, cfg, steps)
        state = batch_fleet_state(init_nl_fleet(track, cfg, device=device),
                                  B, device=device)
        gains = cfg.gains if cfg.gains is not None else nl_gains()
        rollout(gains, state)                                  # warm
        synchronize(device)
        t0 = time.time()
        reps = max(args.reps, 1)
        for _ in range(reps):
            _, (_, _, m) = rollout(gains, state)
        synchronize(device)
        dt_step = (time.time() - t0) / (reps * steps)
        iters = m.ocd_iterations.double()
        rows.append({
            "study": f"gs-tradeoff/{sweep}",
            "batch": B, "steps": steps, "N": args.n,
            "ocd_iters_mean": round(float(iters.mean()), 2),
            "ms_per_fleet_step_batch": round(dt_step * 1e3, 1),
            "fleet_steps_per_s": round(B / dt_step, 1),
            "feasible": bool(m.feasible.all()),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--family", default="lpv",
                       choices=["lpv", "nl-eu", "nl-hp", "nl-hp_opt"])
        p.add_argument("--n", type=int, default=125, help="horizon N")
        p.add_argument("--variant", default="auto",
                       choices=["auto", "assoc", "seq"],
                       help="Riccati path (auto = the resolved schedule); "
                       "on a CUDA device every epoch is the epoch kernel "
                       "whatever this says, so it matters on the CPU only")
        p.add_argument("--no-hold", action="store_true",
                       help="disable hold_on_infeasible (raw semantics)")
        p.add_argument("--no-ladder", action="store_true",
                       help="disable the recovery escalation ladder")
        p.add_argument("--no-filter", action="store_true",
                       help="disable the executed-separation safety "
                            "filter (exec_sep_frac=None); as in the JAX "
                            "script, the track-limits wall (exec_ey_wall) "
                            "and the degraded-execution escape "
                            "(hold_exec_k) stay armed")
        p.add_argument("--no-vxpass", action="store_true",
                       help="disable the hold-recovery vx_ref "
                            "feasibility pass (hold_vx_frac=None)")
        p.add_argument("--device", default="cuda",
                       help="torch device (default: cuda, which raises "
                       "without a card; --device cpu runs on the CPU)")

    p = sub.add_parser("full-course")
    common(p)
    p.add_argument("--steps", type=int, default=700)
    p.set_defaults(fn=full_course)

    p = sub.add_parser("perturbed")
    common(p)
    p.add_argument("--steps", type=int, default=550)
    p.add_argument("--starts", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=50,
                   help="steps per rollout call (batched)")
    p.add_argument("--batched", action="store_true",
                   help="all starts as one batch of fleets (no per-run "
                        "latency rows)")
    p.set_defaults(fn=perturbed)

    p = sub.add_parser("latency")
    common(p)
    p.add_argument("--steps", type=int, default=100)
    p.set_defaults(fn=latency)

    p = sub.add_parser("gs-tradeoff")
    common(p)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=gs_tradeoff)

    args = ap.parse_args(argv)
    from colaborativempc_tpu_torch.utils import resolve_device
    return args.fn(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
