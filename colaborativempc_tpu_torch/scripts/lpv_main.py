"""Decentralised LPV collaborative-MPC experiment (reference
``planner/scripts/LPV_HP_N_main.py`` with ``config_files/config_LPV.py``);
the port of the JAX package's ``scripts/lpv_main.py``.

Runs the reference's flagship LPV configuration — 3 agents, N=125,
dt=0.025, Highway, 1000 ADMM iterations — writes the reference's csv/pck
schema under ``--out``, then the trajectory and performance figures.

    python -m colaborativempc_tpu_torch.scripts.lpv_main [--agents 3]
        [--N 125] [--steps 600] [--map Highway] [--out data/LPV3r]
        [--no-plot] [--device cuda]

``--device`` defaults to ``cuda`` and raises when there is no card;
``--device cpu`` runs on the CPU. ``--no-plot`` skips the figures (for a
machine without matplotlib); without it the script checks for matplotlib
before the run.
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--N", type=int, default=125)
    ap.add_argument("--dt", type=float, default=0.025)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--map", default="Highway")
    ap.add_argument("--out", default="data/LPV3r")
    ap.add_argument("--verb", type=int, default=1)
    ap.add_argument("--admm-iters", type=int, default=1000)
    ap.add_argument("--no-plot", action="store_true",
                    help="write no figures (no matplotlib needed)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which raises without "
                    "a card; --device cpu runs on the CPU)")
    args = ap.parse_args(argv)
    from colaborativempc_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)
    from colaborativempc_tpu_torch.runtime import plotting
    if not args.no_plot:
        plotting.require_matplotlib("pass --no-plot to run without plots")

    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, SolverConfig, lpv_gains,
    )
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.runtime import (
        ExperimentIO, run_lpv_experiment,
    )

    cfg = ExperimentConfig(
        n_agents=args.agents, N=args.N, dt=args.dt, max_it=args.steps,
        map_type=args.map, gains=lpv_gains(), path=args.out, verb=args.verb,
        solver=SolverConfig(admm_iters=args.admm_iters))
    io = ExperimentIO(cfg)
    res = run_lpv_experiment(cfg, io=io, device=device)
    io.save_all()

    if not args.no_plot:
        track = make_track(cfg.map_type, device="cpu")
        plotting.plot_experiment(track, res.states, path=args.out)
        plotting.plot_performance(res.states, cfg.dt, path=args.out)
    warm = res.step_times[3:] if len(res.step_times) > 3 else res.step_times
    print(f"steps={res.steps} finished={res.finished} "
          f"feasible={res.feasible.all()} "
          f"min_dist_exec={res.min_dist_exec.min():.3f} "
          f"mean_step={np.mean(warm) * 1e3:.1f}ms device={device}")
    return res


if __name__ == "__main__":
    main()
