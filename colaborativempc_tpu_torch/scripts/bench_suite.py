"""Benchmark suite over the BASELINE.json configurations; the port of the
JAX package's ``scripts/bench_suite.py``.

Prints one JSON line per configuration, with the JAX script's names, keys
and ``protocol`` strings, so that its lines compare with the JAX script's
line for line (``bench.py`` stays the JAX package's single-line headline
benchmark). Each row is also returned by the function that prints it.

    python -m colaborativempc_tpu_torch.scripts.bench_suite [--quick]
        [--tiny] [--saturation [--batches 64,128,256,512,1024]]
        [--mxu] [--mpcc-assoc] [--device cuda]

Timing (``timeit``) is the best of 10 calls of one step from the same
warm state, each ending in a synchronise of the device; ``dispatch_floor_ms`` is the best of 10 synchronised calls of a
trivial device operation (the JAX suite's protocol; ``stress_study``'s
floor is a mean of 5, another protocol).

Studies:

- ``--mxu``: would the card's matrix units help the Riccati products? The
  batched 11x11 stage products and the same products packed into
  block-diagonal 121x121 operands, each with TF32 off (float32 on the
  CUDA cores, the port's pin: the JAX script's HIGHEST) and on (TF32
  tensor cores allowed: its DEFAULT), then the knee step end to end under
  both settings. The hand-written kernels are float32 whatever the flag,
  so the end-to-end A/B moves only the torch products around them. The
  variant names say TF32 where the JAX script's say bf16/MXU. Both
  studies restore the float32 pins in a ``finally``.
- ``--mpcc-assoc``: the MPCC race at N=60, ``seq`` against
  ``assoc-blocked+epoch15``. On the card every epoch is the epoch kernel
  whatever ``assoc`` says (the kernel wins over the associative epoch), so
  there the A/B is ``epoch_len`` 15 against the default; on the CPU the
  second arm also runs the associative epoch.

The JAX script's ``--unroll-sweep`` has no counterpart: the port has no
``unroll`` (ROADMAP queue 1). ``--device`` defaults to ``cuda`` and raises
when there is no card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from colaborativempc_tpu_torch.utils import resolve_device, synchronize


def timeit(fn, *args, reps=10, device="cuda"):
    """Best-of-``reps`` wall time of ``fn(*args)`` after one warm call,
    each rep ending in a synchronise of ``device`` (the JAX suite's
    round-5 protocol: the minimum over the reps tracks the floor of
    compute and dispatch, not the tail of the host's jitter). Returns the
    time and the last rep's output."""
    out = fn(*args)
    synchronize(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


_FLOOR_MS = {}


def dispatch_floor_ms(device="cuda") -> float:
    """The per-step floor of launch and synchronisation on ``device``: the
    best of 10 synchronised calls of a trivial operation, measured once per
    process and device, in ms to two decimals."""
    dev = torch.device(device)
    if dev not in _FLOOR_MS:
        z = torch.zeros((), device=dev) + 1.0
        synchronize(dev)
        best = float("inf")
        for _ in range(10):
            t0 = time.perf_counter()
            z = z + 1.0
            synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        _FLOOR_MS[dev] = round(best * 1e3, 2)
    return _FLOOR_MS[dev]


def _print(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def fleet_bench(name, n_agents, N, B, steps_warm=3, admm_iters=300,
                map_type="Highway", eps=1e-4, device="cuda", reps=10):
    """LPV throughput: B perturbed fleets of ``n_agents`` advance one
    control step (``make_lpv_fleet_step`` on ``batch_fleet_state``), timed
    by :func:`timeit` from the state after ``steps_warm`` steps."""
    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, SolverConfig, lpv_gains,
    )
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.parallel import batch_fleet_state
    from colaborativempc_tpu_torch.runtime.simulate import (
        init_lpv_fleet, make_lpv_fleet_step,
    )
    dev = resolve_device(device)
    cfg = ExperimentConfig(
        n_agents=n_agents, N=N, dt=0.02, map_type=map_type,
        gains=lpv_gains(),
        solver=SolverConfig(admm_iters=admm_iters, eps=eps))
    track = make_track(cfg.map_type, device=dev)
    state = batch_fleet_state(init_lpv_fleet(track, cfg, device=dev), B,
                              device=dev)
    rng = np.random.default_rng(0)
    state = state._replace(x0=state.x0 + torch.tensor(
        rng.normal(size=tuple(state.x0.shape)) * 0.02,
        dtype=state.x0.dtype, device=dev))
    step = make_lpv_fleet_step(track, cfg)
    for _ in range(steps_warm):          # reach warm-started steady state
        state, _ = step(state)
    dt_step, (state, metrics) = timeit(step, state, reps=reps, device=dev)
    return _print({
        "config": name, "agents": n_agents, "N": N, "batch": B,
        "ms_per_step": round(dt_step * 1e3, 2),
        "solves_per_sec": round(B * n_agents / dt_step, 1),
        "feasible": bool(metrics.feasible.all()),
        "dispatch_floor_ms": dispatch_floor_ms(dev),
        "protocol": f"best-of-{reps}",
    })


def nl_fleet_bench(name, n_agents, N, B, steps_warm=2, device="cuda",
                   reps=10):
    """Batched NL-OCD throughput: B perturbed fleets run the full
    coordination loop (SQP solves, dual ascent, each fleet's own stop) for
    one control step (``make_nl_ocd_step``), timed by :func:`timeit` from
    the state after ``steps_warm`` steps."""
    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, OCDConfig, SolverConfig, nl_gains,
    )
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.parallel import batch_fleet_state
    from colaborativempc_tpu_torch.runtime.ocd import (
        init_nl_fleet, make_nl_ocd_step,
    )
    dev = resolve_device(device)
    cfg = ExperimentConfig(
        n_agents=n_agents, N=N, dt=0.02, map_type="Highway",
        gains=nl_gains(), ocd=OCDConfig(max_it_ocd=30),
        solver=SolverConfig(admm_iters=200, sqp_iters=2))
    track = make_track(cfg.map_type, device=dev)
    state = batch_fleet_state(init_nl_fleet(track, cfg, device=dev), B,
                              device=dev)
    rng = np.random.default_rng(0)
    dx = rng.normal(size=tuple(state.x0.shape)) * 0.02
    dx[..., 3:] = 0.0
    state = state._replace(x0=state.x0 + torch.tensor(
        dx, dtype=state.x0.dtype, device=dev))
    step = make_nl_ocd_step(track, cfg)
    for _ in range(steps_warm):
        state, m = step(state)
    dt_step, (state, m) = timeit(step, state, reps=reps, device=dev)
    its = m.ocd_iterations.double().cpu().numpy()
    return _print({
        "config": name, "agents": n_agents, "N": N, "batch": B,
        "ms_per_step": round(dt_step * 1e3, 2),
        "fleet_steps_per_sec": round(B / dt_step, 1),
        "ocd_it_mean": round(float(its.mean()), 1),
        "feasible": bool(m.feasible.all()),
        "dispatch_floor_ms": dispatch_floor_ms(dev),
        "protocol": f"best-of-{reps}",
    })


def _float32_pins(tf32: bool) -> None:
    """TF32 on (the matrix units allowed) or off (the port's pin: float32
    on the CUDA cores) for every float32 matrix product."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def mxu_study(B_lanes=768, N=20, nz=11, device="cuda", reps=10):
    """Would the matrix units help the Riccati products? The solver's
    products are batched nz x nz stage products in the Riccati recursion
    (``P <- F' (P F) + Q`` over N stages here). Four measured routes at the
    knee's lanes (256 scenarios x 3 agents = 768): the batched products
    with TF32 off (the shipped float32) and on; the lanes packed g = nz at a
    time into block-diagonal (g nz) x (g nz) operands (identical algebra,
    g times the operations on the off-diagonal zeros; packing excluded),
    TF32 off and on. Each row's error is relative to the shipped route.
    Restores the float32 pins. Returns the rows."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    g = nz
    nb = -(-B_lanes // g)   # groups, identity-padded to a multiple of g

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    F = t(rng.normal(size=(N, B_lanes, nz, nz)) * 0.3 + np.eye(nz))
    Q = t(np.broadcast_to(np.eye(nz), (N, B_lanes, nz, nz)).copy())
    P0 = t(np.broadcast_to(np.eye(nz), (B_lanes, nz, nz)).copy())

    def riccati_like(P, F, Q):
        for k in range(F.shape[0]):
            P = torch.matmul(F[k].transpose(-1, -2),
                             torch.matmul(P, F[k])) + Q[k]
        return P

    def pack_bd(M):   # (..., B, nz, nz) -> (..., nb, g nz, g nz)
        shp, pad = M.shape[:-3], nb * g - M.shape[-3]
        if pad:
            eye = torch.eye(nz, dtype=M.dtype, device=dev).expand(
                shp + (pad, nz, nz))
            M = torch.cat([M, eye], dim=-3)
        Mg = M.reshape(shp + (nb, g, nz, nz))
        out = torch.zeros(shp + (nb, g * nz, g * nz), dtype=M.dtype,
                          device=dev)
        for i in range(g):
            out[..., i * nz:(i + 1) * nz, i * nz:(i + 1) * nz] = Mg[..., i, :, :]
        return out

    Fb, Qb, P0b = pack_bd(F), pack_bd(Q), pack_bd(P0)
    flops = 2 * 2 * N * B_lanes * nz ** 3   # two products per stage
    rows, ref = [], None
    try:
        for name, tf32, args in (
                ("batched-11x11 HIGHEST (shipped)", False, (P0, F, Q)),
                ("batched-11x11 DEFAULT (TF32 allowed)", True, (P0, F, Q)),
                ("blockdiag-121x121 HIGHEST", False, (P0b, Fb, Qb)),
                ("blockdiag-121x121 DEFAULT (TF32 tensor cores)", True,
                 (P0b, Fb, Qb))):
            _float32_pins(tf32)
            dt, out = timeit(riccati_like, *args, reps=reps, device=dev)
            out = out.double().cpu()
            if out.shape[-1] == g * nz:     # the diagonal blocks, unpacked
                out = torch.stack([out[:, i * nz:(i + 1) * nz,
                                       i * nz:(i + 1) * nz]
                                   for i in range(g)], dim=1).reshape(
                    nb * g, nz, nz)[:B_lanes]
            if ref is None:
                ref = out
            err = float((out - ref).abs().max() / ref.abs().max())
            executed = flops * ((g * nz) ** 3 / (g * nz ** 3)
                                if "blockdiag" in name else 1)
            rows.append(_print({
                "mxu_variant": name, "lanes": B_lanes, "N": N,
                "us_per_pass": round(dt * 1e6, 1),
                "useful_gflops": round(flops / dt / 1e9, 1),
                "executed_gflops": round(executed / dt / 1e9, 1),
                "rel_err_vs_shipped": float(f"{err:.2e}"),
            }))
    finally:
        _float32_pins(False)
    return rows


def mxu_end_to_end(B=256, N=20, device="cuda", reps=10):
    """The knee step end to end (3 agents, ``N``, B fleets) with TF32 off
    (shipped) and on: the hand-written kernels are float32 either way, so
    only the torch products around them move. Restores the float32 pins.
    Returns the two rows."""
    rows = []
    try:
        for tag, tf32 in (("HIGHEST (shipped)", False),
                          ("DEFAULT (TF32)", True)):
            _float32_pins(tf32)
            _print({"mxu_end_to_end": tag})
            rows.append(fleet_bench(f"knee 3-agent H={N} B={B} [{tag}]", 3,
                                    N, B, device=device, reps=reps))
    finally:
        _float32_pins(False)
    return rows


def mpcc_assoc_study(steps=80, N=60, device="cuda", warm=10):
    """The MPCC race at the reference's N=60: ``seq`` against
    ``assoc-blocked+epoch15``, each from the same start, ``warm`` warm-in
    steps then ``steps`` timed ones (host clock per synchronised step). On
    the card both arms run the epoch kernel, so the A/B is ``epoch_len``
    15 against the default. Returns the two rows."""
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
    from colaborativempc_tpu_torch.runtime.racing import (
        init_mpcc, load_mpcc_track, make_mpcc_step,
    )
    dev = resolve_device(device)
    rows = []
    for name, kw in (("seq", dict(assoc=False)),
                     ("assoc-blocked+epoch15",
                      dict(assoc=True, epoch_len=15))):
        cfg = MPCCConfig(N=N, dt=0.05, n_sim=steps, **kw)
        track = load_mpcc_track(cfg, device=dev)
        state = init_mpcc(track, cfg, device=dev)
        step = make_mpcc_step(track, cfg)
        for _ in range(warm):
            state, m = step(state)
        synchronize(dev)
        ts, feas = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state)
            synchronize(dev)
            ts.append(time.perf_counter() - t0)
            feas.append(bool(m.feasible.all()))
        ts = np.asarray(ts)
        rows.append(_print({
            "mpcc_assoc_variant": name, "N": N, "steps": steps,
            "p50_ms": round(float(np.percentile(ts, 50)) * 1e3, 2),
            "min_ms": round(float(ts.min()) * 1e3, 2),
            "p95_ms": round(float(np.percentile(ts, 95)) * 1e3, 2),
            "s_final": round(float(state.x[0, 6]), 2),
            "feasible_frac": round(float(np.mean(feas)), 3),
            "dispatch_floor_ms": dispatch_floor_ms(dev),
        }))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test shapes (test suite / CI)")
    ap.add_argument("--saturation", action="store_true",
                    help="batch-saturation study: solves/s vs batch for the "
                    "headline and N=125 shapes")
    ap.add_argument("--batches", default="64,128,256,512,1024",
                    help="batch sizes for --saturation")
    ap.add_argument("--mxu", action="store_true",
                    help="would the matrix units help the Riccati products: "
                    "batched 11x11 vs block-diagonal 121x121 stage "
                    "products with TF32 off and on, then the knee step end "
                    "to end under both (the hand-written kernels are "
                    "float32 whatever the flag, so the end-to-end A/B "
                    "moves only the torch products around them)")
    ap.add_argument("--mpcc-assoc", action="store_true",
                    help="MPCC N=60 race: seq vs blocked-assoc with epoch "
                    "15 (on the card both arms run the epoch kernel, so "
                    "the A/B is epoch_len 15 against the default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which raises without "
                    "a card; --device cpu runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kw = dict(device=dev)

    if args.mxu:
        return mxu_study(**kw) + mxu_end_to_end(**kw)
    if args.mpcc_assoc:
        return mpcc_assoc_study(device=dev)
    if args.tiny:
        return [fleet_bench("tiny LPV smoke", 2, 8, 4, admm_iters=100, **kw),
                nl_fleet_bench("tiny NL smoke", 2, 8, 2, **kw)]
    if args.saturation:
        batches = [int(b) for b in args.batches.split(",")]
        rows = [fleet_bench(f"headline 3-agent H=20 B={B}", 3, 20, B, **kw)
                for B in batches]
        # N=125 past B=512: a working set past any sane device budget
        return rows + [fleet_bench(f"long-horizon 3-agent N=125 B={B}", 3,
                                   125, B, admm_iters=600, eps=5e-4, **kw)
                       for B in batches if B <= 512]

    # the BASELINE.json configurations, scaled to one card
    rows = [fleet_bench("1-agent LPV H=10 oval", 1, 10, 256,
                        map_type="oval", **kw),
            fleet_bench("1-agent H=20 constrained warm", 1, 20, 256, **kw),
            fleet_bench("2-agent collaborative", 2, 20, 128, **kw),
            fleet_bench("8-agent shared lane", 8, 20, 32, **kw)]
    if not args.quick:
        rows.append(fleet_bench("16 agents x 64 scenarios (monte-carlo)", 16,
                                20, 64, **kw))
        # eps=5e-4, throughput only: closed-loop full courses need 1e-4
        # (run_lpv_experiment keeps it); the batch pays the slowest
        # problem's iterations, and the last digit below 5e-4 costs ~2x
        rows.append(fleet_bench("3-agent long horizon N=125", 3, 125, 64,
                                admm_iters=600, eps=5e-4, **kw))
        rows.append(nl_fleet_bench("3-agent NL-OCD Monte-Carlo", 3, 20, 64,
                                   **kw))
    return rows


if __name__ == "__main__":
    main()
