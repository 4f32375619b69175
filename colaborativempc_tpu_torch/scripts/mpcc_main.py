"""MPCC closed-loop racing experiment (reference
``Matlab-tests/MPCC-master/C++/main.cpp:30-86``); the port of the JAX
package's ``scripts/mpcc_main.py``.

    python -m colaborativempc_tpu_torch.scripts.mpcc_main
        [--config Params/config.json] [--map oval_mt | --track-json track.json]
        [--N 20] [--steps 400] [--laps 1] [--out data/mpcc] [--no-normalize]
        [--plot] [--device cuda]

``--config`` takes the reference's master ``config.json`` layout or the
flat JSON schema (``planners/mpcc.py mpcc_config_from_json``). ``--plot``
writes the trajectory figure under the run's path (it needs matplotlib,
checked before the run). ``--device`` defaults to ``cuda`` and raises when
there is no card; ``--device cpu`` runs on the CPU.
"""

import argparse
import dataclasses

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="JSON config (reference master layout or flat)")
    ap.add_argument("--map", default=None, help="named analytic track")
    ap.add_argument("--track-json", default=None,
                    help="reference-format track JSON to fit and race")
    ap.add_argument("--N", type=int, default=None)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--steps", type=int, default=None, help="n_sim")
    ap.add_argument("--laps", type=int, default=None,
                    help="terminate after this many laps (0 = run n_sim)")
    ap.add_argument("--sqp", type=int, default=None, help="n_sqp")
    ap.add_argument("--no-normalize", action="store_true",
                    help="solve in raw variables (skip the reference's "
                    "T_x/T_u normalisation, params.h:31-58)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--verb", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which raises without "
                    "a card; --device cpu runs on the CPU)")
    args = ap.parse_args(argv)
    from colaborativempc_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)
    from colaborativempc_tpu_torch.runtime import plotting
    if args.plot:
        plotting.require_matplotlib("leave out --plot to run without it")

    from colaborativempc_tpu_torch.planners.mpcc import (
        MPCCConfig, mpcc_config_from_json,
    )
    from colaborativempc_tpu_torch.runtime.racing import (
        load_mpcc_track, run_mpcc_experiment,
    )

    cfg = (mpcc_config_from_json(args.config) if args.config
           else MPCCConfig())
    over = {}
    if args.map is not None:
        over.update(map_type=args.map, track_json=None)
    if args.track_json is not None:
        over["track_json"] = args.track_json
    if args.N is not None:
        over["N"] = args.N
    if args.dt is not None:
        over["dt"] = args.dt
    if args.steps is not None:
        over["n_sim"] = args.steps
    if args.laps is not None:
        over["laps"] = args.laps
    if args.sqp is not None:
        over["n_sqp"] = args.sqp
    if args.no_normalize:
        over["normalize"] = False
    if args.out is not None:
        over["path"] = args.out
    if args.save:
        over["save_data"] = True
    over["verb"] = args.verb
    cfg = dataclasses.replace(cfg, **over)

    track = load_mpcc_track(cfg, device=device)
    res = run_mpcc_experiment(cfg, track=track, device=device)

    if args.plot:
        plotting.plot_experiment(track, res.states[:, None, :], path=cfg.path)
    warm = res.step_times[3:] if len(res.step_times) > 3 else res.step_times
    lap = f" lap_time={res.lap_time:.2f}s" if res.lap_time else ""
    print(f"steps={res.steps} finished={res.finished} "
          f"s={res.states[-1, 6]:.2f} vx_mean={res.states[:, 0].mean():.2f} "
          f"feasible={res.feasible.mean() * 100:.0f}% "
          f"resets={int(res.resets.sum())}{lap} "
          f"mean_step={np.mean(warm) * 1e3:.1f}ms device={device}")


if __name__ == "__main__":
    main()
