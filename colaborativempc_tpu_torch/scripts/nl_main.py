"""Distributed NL-OCD collaborative-MPC experiment (reference
``planner/scripts/NL_EU_N_main.py`` / ``NL_HP_N_main.py`` with
``config_files/config_NL.py``); the port of the JAX package's
``scripts/nl_main.py``.

    python -m colaborativempc_tpu_torch.scripts.nl_main [--coupling eu|hp|hp_opt]
        [--agents 3] [--N 20] [--steps 1500] [--out data/NL_3agents_eu]
        [--lambdas data/NL_3agents_eu/pck/ini_lambdas.pkl] [--no-plot]
        [--device cuda]

Writes the reference's csv/pck schema under ``--out``, the trajectory and
performance figures (skipped with ``--no-plot``, for a machine without
matplotlib; without it the script checks for matplotlib before the run)
and prints a summary line. ``--device`` defaults to ``cuda`` and raises
when there is no card; ``--device cpu`` runs on the CPU.
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coupling", choices=["eu", "hp", "hp_opt"],
                    default="eu")
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--N", type=int, default=20)
    ap.add_argument("--dt", type=float, default=0.02)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--map", default="Highway")
    ap.add_argument("--out", default=None)
    ap.add_argument("--lambdas", default=None,
                    help="ini_lambdas.pkl warm start")
    ap.add_argument("--verb", type=int, default=1)
    ap.add_argument("--verb-ocd", action="store_true",
                    help="time every coordination iteration (reference "
                    "verb_OCD; one synchronisation per iteration)")
    ap.add_argument("--sweep", choices=["jacobi", "gauss_seidel"],
                    default="jacobi")
    ap.add_argument("--lane", type=int, default=0)
    ap.add_argument("--dynamic-lane", action="store_true",
                    help="per-step lane re-selection (reference checkLane)")
    ap.add_argument("--no-plot", action="store_true",
                    help="write no figures (no matplotlib needed)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which raises without "
                    "a card; --device cpu runs on the CPU)")
    args = ap.parse_args(argv)
    out = args.out or f"data/NL_{args.agents}agents_{args.coupling}"
    from colaborativempc_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)
    from colaborativempc_tpu_torch.runtime import plotting
    if not args.no_plot:
        plotting.require_matplotlib("pass --no-plot to run without plots")

    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, OCDConfig, SolverConfig, nl_gains,
    )
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.runtime import (
        ExperimentIO, load_lambdas, run_nl_experiment,
    )

    cfg = ExperimentConfig(
        n_agents=args.agents, N=args.N, dt=args.dt, max_it=args.steps,
        map_type=args.map, coupling=args.coupling, gains=nl_gains(),
        path=out, verb=args.verb, verb_ocd=args.verb_ocd,
        lane=args.lane, dynamic_lane=args.dynamic_lane,
        ocd=OCDConfig(max_it_ocd=50, sweep=args.sweep),
        solver=SolverConfig(admm_iters=200, sqp_iters=2))
    lam0 = (load_lambdas(args.lambdas, args.agents, args.N)
            if args.lambdas else None)
    io = ExperimentIO(cfg)
    res = run_nl_experiment(cfg, lambdas0=lam0, io=io, device=device)
    io.save_all(lambdas=res.lambdas)

    if not args.no_plot:
        track = make_track(cfg.map_type, device="cpu")
        plotting.plot_experiment(track, res.states, path=out)
        plotting.plot_performance(res.states, cfg.dt, path=out)
    warm = res.step_times[3:] if len(res.step_times) > 3 else res.step_times
    print(f"steps={res.steps} finished={res.finished} "
          f"feasible={res.feasible.all()} "
          f"OCD mean={res.ocd_iterations.mean():.1f} "
          f"min_dist_exec={res.min_dist_exec.min():.3f} "
          f"mean_step={np.mean(warm) * 1e3:.1f}ms device={device}")


if __name__ == "__main__":
    main()
