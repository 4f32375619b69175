"""Behavioural parity against the reference's recorded golden runs
(``planner/scripts/data/experiments_paper/`` of the reference checkout, the
de-facto regression baselines); the port of the JAX package's
``scripts/compare_reference.py``.

Closed-loop trajectories diverge chaotically between any two solvers, so
parity is measured on behaviour, not samplewise states:
  - short-horizon state deviation (first K steps, before divergence)
  - velocity profile statistics (mean/max vx)
  - lateral-error statistics (RMS ey)
  - progress rate (ds/dt) and completion
  - minimum executed inter-agent distance

The run configuration (N, dt, gains, min_dist, OCD knobs) is parsed from
the golden run's own ``settings.csv`` (the reference's ``save_config``
output), so every recorded experiment replays under its own recorded
hyperparameters, through the port's runners on ``--device``:

    python -m colaborativempc_tpu_torch.scripts.compare_reference
        --ref NL_3agents_mh [--device cuda]
    python -m colaborativempc_tpu_torch.scripts.compare_reference
        --ref /path/to/LPV3r_agent_laptop [--steps 150]

A bare name is looked up under ``GOLDEN_ROOT``, the golden runs' directory
of a reference checkout in the working directory; for a checkout elsewhere
give ``--ref`` the run's absolute path.

Flags override anything parsed. ``--device`` defaults to ``cuda`` and
raises when there is no card; ``--device cpu`` runs on the CPU.
"""

import argparse
import csv
import os

import numpy as np

# the golden runs' directory of a reference checkout, relative to the
# working directory
GOLDEN_ROOT = os.path.join("reference", "planner", "scripts", "data",
                           "experiments_paper")
STATE_NAMES = ["vx", "vy", "wz", "ey", "epsi", "theta", "s", "X", "Y"]


def parse_matrix(text):
    """Parse a numpy-printed matrix string ('[[1.0 2.0]\\n [3.0 4.0]]')."""
    rows = [r for r in text.replace("[", " ").replace("]", " ").split("\n")
            if r.strip()]
    return np.asarray([[float(v) for v in r.split()] for r in rows])


def load_settings(path):
    """Parse the reference's settings.csv into a plain dict."""
    out = {}
    fn = os.path.join(path, "settings.csv")
    if not os.path.exists(fn):
        return out
    with open(fn) as fh:
        for row in csv.reader(fh):
            if len(row) < 2:
                continue
            k, v = row[0], ",".join(row[1:])
            if k in ("Q", "Qs", "R", "dR"):
                out[k] = parse_matrix(v)
            elif k in ("n_agents", "max_it", "N", "it_conv", "max_it_OCD",
                       "min_it_OCD"):
                out[k] = int(v)
            elif k in ("dt", "vx_ref", "min_dist", "wq"):
                out[k] = float(v)
            elif k == "map_type":
                out[k] = v
    return out


def load_reference(path, n_agents=3):
    return np.stack([
        np.loadtxt(os.path.join(path, "csv", str(a), "states.dat"))
        for a in range(n_agents)], axis=1)  # (T, n_ag, 9)


def stats(states, dt, label):
    vx = states[:, :, 0]
    ey = states[:, :, 3]
    s = states[:, :, 6]
    xy = states[:, :, 7:9]
    n_ag = states.shape[1]
    dmin = np.inf
    for i in range(n_ag):
        for j in range(i + 1, n_ag):
            d = np.hypot(*(xy[:, i] - xy[:, j]).T)
            dmin = min(dmin, d.min())
    out = dict(
        mean_vx=float(vx[20:].mean()), max_vx=float(vx.max()),
        rms_ey=float(np.sqrt((ey ** 2).mean())),
        progress_rate=float((s[-1] - s[0]).mean() / (dt * (len(s) - 1))),
        min_pair_dist=float(dmin))
    print(f"{label:>10}: " + "  ".join(f"{k}={v:.3f}" for k, v in out.items()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", default="LPV3r_agent_laptop",
                    help="golden run directory (absolute path or a name "
                    f"under {GOLDEN_ROOT})")
    ap.add_argument("--planner", choices=["lpv", "nl"], default=None,
                    help="default: nl for NL_* runs, lpv otherwise")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--N", type=int, default=None)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--max-ocd", type=int, default=30,
                    help="OCD iteration cap (divergence guard; the "
                    "reference's recorded runs average ~4)")
    ap.add_argument("--short", type=int, default=40,
                    help="short-horizon deviation window")
    ap.add_argument("--open-loop", type=int, default=0, metavar="K",
                    help="open-loop parity: compare the first K executed "
                    "inputs per agent against the golden u.dat rows 0..K-1 "
                    "(the cold-start warm trajectories are deterministic, "
                    "utils/warmstart.py, so the first recorded solves are "
                    "reference-solver outputs on knowable inputs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which raises without "
                    "a card; --device cpu runs on the CPU)")
    args = ap.parse_args(argv)
    from colaborativempc_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)

    ref_path = (args.ref if os.path.isabs(args.ref)
                else os.path.join(GOLDEN_ROOT, args.ref))
    name = os.path.basename(ref_path.rstrip("/"))
    settings = load_settings(ref_path)
    planner = args.planner or ("nl" if name.startswith("NL") else "lpv")

    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, Gains, OCDConfig, SolverConfig, SysLimits,
        lpv_gains, nl_gains,
    )
    from colaborativempc_tpu_torch.runtime import (
        run_lpv_experiment, run_nl_experiment,
    )

    if "Q" in settings:
        def diag(k):
            return np.diag(settings[k]).astype(np.float32)
        gains = Gains(q=diag("Q"), qs=diag("Qs"), r=diag("R"), dr=diag("dR"),
                      wq=settings.get("wq", 5.0))
    else:
        gains = nl_gains() if planner == "nl" else lpv_gains()

    N = args.N or settings.get("N", 125 if planner == "lpv" else 20)
    dt = args.dt or settings.get("dt", 0.025)
    limits = SysLimits(vx_ref=settings.get("vx_ref", 3.0),
                       min_dist=settings.get("min_dist", 0.25))
    print(f"golden run {name}: planner={planner} N={N} dt={dt} "
          f"q={np.asarray(gains.q)[[0, 3, 4]]} "
          f"r={np.asarray(gains.r)} dr={np.asarray(gains.dr)}")

    ref = load_reference(ref_path, settings.get("n_agents", 3))
    T = min(args.steps, len(ref))

    if planner == "lpv":
        cfg = ExperimentConfig(
            n_agents=ref.shape[1], N=N, dt=dt, max_it=T,
            map_type=settings.get("map_type", "Highway"),
            limits=limits, gains=gains,
            solver=SolverConfig(admm_iters=1000))
        res = run_lpv_experiment(cfg, device=device)
    else:
        cfg = ExperimentConfig(
            n_agents=ref.shape[1], N=N, dt=dt, max_it=T,
            map_type=settings.get("map_type", "Highway"),
            limits=limits, gains=gains,
            ocd=OCDConfig(max_it_ocd=args.max_ocd,
                          it_conv=settings.get("it_conv", 2),
                          min_it_ocd=settings.get("min_it_OCD", 2)),
            solver=SolverConfig(admm_iters=300, sqp_iters=2))
        res = run_nl_experiment(cfg, device=device)
        print(f"OCD iterations: mean {res.ocd_iterations.mean():.2f}")
        ocd_dat = os.path.join(ref_path, "csv", "0", "OCD_it.dat")
        if os.path.exists(ocd_dat):
            print(f"  (reference {name} OCD_it.dat mean: "
                  f"{np.loadtxt(ocd_dat).mean():.2f})")
    ours = res.states

    Tc = min(len(ours), T)
    print(f"comparing {Tc} control steps "
          f"(ref run has {len(ref)}, ours {len(ours)}) on {device}")
    r = stats(ref[:Tc], dt, "reference")
    o = stats(ours[:Tc], dt, "ours")

    K = min(args.short, Tc)
    dev = np.abs(ours[:K] - ref[:K])
    print(f"\nshort-horizon (first {K} steps) max abs deviation per state:")
    for i, nm in enumerate(STATE_NAMES):
        print(f"  {nm:>5}: {dev[:, :, i].max():.4f}")

    print("\nbehavioural deltas (ours - reference):")
    for k in r:
        print(f"  {k}: {o[k] - r[k]:+.3f}")

    if args.open_loop:
        K = min(args.open_loop, len(res.inputs), len(ref))
        ref_u = np.stack([
            np.loadtxt(os.path.join(ref_path, "csv", str(a), "u.dat"))
            for a in range(ref.shape[1])], axis=1)     # (T, n_ag, 2)
        du = np.abs(np.asarray(res.inputs[:K]) - ref_u[:K])
        print(f"\nopen-loop parity: first {K} executed inputs vs the "
              f"golden u.dat (identical deterministic cold start):")
        print("  step | max|d_steer| [rad] | max|d_accel| [m/s^2]")
        for k in range(K):
            print(f"  {k:4d} | {du[k, :, 0].max():12.4f}       | "
                  f"{du[k, :, 1].max():10.4f}")
        print(f"  mean | {du[:, :, 0].mean():12.4f}       | "
              f"{du[:, :, 1].mean():10.4f}")
    return dict(reference=r, ours=o, short_deviation=dev.max(axis=(0, 1)))


if __name__ == "__main__":
    main()
