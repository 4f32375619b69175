"""Gain-grid sweep as one batch of fleets (reference
``planner/scripts/experiment_battery.py``, which runs the grid serially
through the NL-OCD pipeline by re-invoking ``NL_EU_N_main.main`` per
combination, :15-38); the port of the JAX package's
``scripts/experiment_battery.py``.

    python -m colaborativempc_tpu_torch.scripts.experiment_battery
        [--pipeline nl|lpv|mpcc] [--steps 80] [--horizons 20,40]
        [--device cuda]

``nl`` sweeps 12 gain combinations through the full OCD loop (with
``--horizons`` as an outer loop over N), ``lpv`` 18 through the
decentralised LPV step, ``mpcc`` races 18 at once. ``--device`` defaults
to ``cuda`` and raises when there is no card; ``--device cpu`` runs on the
CPU.
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", choices=("nl", "lpv", "mpcc"),
                    default="nl",
                    help="nl: full OCD coordination per step (reference "
                         "battery); lpv: decentralised LPV step; mpcc: "
                         "racing gain sweep (the whole grid races at once)")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--N", type=int, default=20)
    ap.add_argument("--horizons", default=None,
                    help="comma-separated N values for the outer horizon "
                    "sweep (the reference battery's N axis, "
                    "experiment_battery.py:15-20); shapes change per N, so "
                    "each value is its own batch")
    ap.add_argument("--map", default="Highway")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which raises without "
                    "a card; --device cpu runs on the CPU)")
    args = ap.parse_args(argv)
    from colaborativempc_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)

    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, OCDConfig, SolverConfig, lpv_gains, nl_gains,
    )
    from colaborativempc_tpu_torch.runtime import (
        gain_grid, mpcc_gain_grid, run_lpv_battery, run_mpcc_battery,
        run_nl_battery,
    )

    if args.pipeline == "mpcc":
        from colaborativempc_tpu_torch.planners.mpcc import (
            MPCCConfig, MPCCGains,
        )
        cfg = MPCCConfig(N=args.N, dt=0.05, map_type=args.map
                         if args.map != "Highway" else "oval_mt")
        grid = mpcc_gain_grid(MPCCGains(),
                              q_contour=[20.0, 50.0, 120.0],
                              q_progress=[0.5, 1.0, 2.0],
                              dr_scale=[0.5, 1.0])
        print(f"racing {len(grid)} gain combinations x {args.steps} steps "
              f"in one batch on {device}")
        res = run_mpcc_battery(cfg, grid, steps=args.steps, device=device)
        for i, g in enumerate(grid):
            lap = (f"lap={res.lap_time[i]:.2f}s"
                   if np.isfinite(res.lap_time[i]) else "no lap")
            print(f"cfg {i:2d}: qc={g.q_contour:6.1f} qp={g.q_progress:4.1f}"
                  f" dr={g.dr_delta:5.1f} -> progress={res.progress[i]:.2f}m"
                  f" |ey|max={np.abs(res.ey_hist[:, i]).max():.3f}"
                  f" feas={res.feasible_frac[i]:.2f} {lap}")
        return res

    if args.pipeline == "nl":
        horizons = ([int(x) for x in args.horizons.split(",")]
                    if args.horizons else [args.N])
        grid = gain_grid(nl_gains(),
                         q_vx=[-0.2, -0.6, -1.2],
                         q_ey=[150.0, 300.0],
                         wq=[0.0, 0.2])
        results = {}
        for N in horizons:
            cfg = ExperimentConfig(
                n_agents=args.agents, N=N, dt=0.02, map_type=args.map,
                gains=nl_gains(), ocd=OCDConfig(),
                solver=SolverConfig(admm_iters=200, sqp_iters=2))
            print(f"N={N}: sweeping {len(grid)} gain combinations x "
                  f"{args.steps} NL-OCD steps in one batch on {device}")
            res = results[N] = run_nl_battery(cfg, grid, steps=args.steps,
                                              device=device)
            ok = res.feasible.all(axis=(0, 2))
            for i, g in enumerate(grid):
                print(f"  N={N} cfg {i:2d}: qvx={float(g.q[0]):6.2f} "
                      f"qey={float(g.q[3]):6.1f} wq={float(g.wq):4.2f}"
                      f" -> progress={res.progress[i]:.2f}m"
                      f" min_dist={res.min_dist_exec[:, i].min():.3f}"
                      f" OCD_it={res.ocd_iterations[:, i].mean():.1f}"
                      f" feasible={bool(ok[i])}")
        return results

    cfg = ExperimentConfig(
        n_agents=args.agents, N=args.N, dt=0.025, map_type=args.map,
        gains=lpv_gains(), solver=SolverConfig(admm_iters=300))
    grid = gain_grid(lpv_gains(),
                     q_vx=[5.0, 10.0, 25.0],
                     q_ey=[25.0, 100.0],
                     dr_scale=[0.5, 1.0, 2.0])
    print(f"sweeping {len(grid)} gain combinations x {args.steps} steps "
          f"in one batch on {device}")
    res = run_lpv_battery(cfg, grid, steps=args.steps, device=device)
    ok = res.feasible.all(axis=(0, 2))
    for i, g in enumerate(grid):
        print(f"cfg {i:2d}: qvx={float(g.q[0]):6.1f} qey={float(g.q[3]):6.1f}"
              f" dr0={float(g.dr[0]):6.1f} -> progress={res.progress[i]:.2f}m"
              f" min_dist={res.min_dist_exec[:, i].min():.3f}"
              f" feasible={bool(ok[i])}")
    return res


if __name__ == "__main__":
    main()
