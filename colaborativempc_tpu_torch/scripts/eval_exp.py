"""Replay a recorded experiment and regenerate its figures (reference
``planner/scripts/eval_exp.py`` + ``exp_gen_figs.py``); the port of the JAX
package's ``scripts/eval_exp.py``. Host plotting: the track is built on the
CPU and matplotlib is required.

    python -m colaborativempc_tpu_torch.scripts.eval_exp data/NL_3agents_eu
        [--map Highway] [--gif] [--every 2]
"""

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--map", default="Highway")
    ap.add_argument("--agents", type=int, default=None)
    ap.add_argument("--gif", action="store_true",
                    help="also render the step-by-step animation "
                    "(reference live plotter, headless GIF)")
    ap.add_argument("--every", type=int, default=2,
                    help="animate every k-th control step")
    args = ap.parse_args(argv)

    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.runtime.io import load_experiment
    from colaborativempc_tpu_torch.runtime.plotting import (
        animate_experiment, plot_experiment, plot_performance,
    )

    n_agents = args.agents
    if n_agents is None:
        n_agents = len(os.listdir(os.path.join(args.path, "pck"))) - (
            1 if os.path.exists(os.path.join(args.path, "pck",
                                             "ini_lambdas.pkl")) else 0)

    # executed states = row 0 of each stored prediction
    all_states, all_preds = [], []
    for a in range(n_agents):
        s_hist, _ = load_experiment(args.path, a)
        all_states.append(np.stack([s[0] for s in s_hist]))
        all_preds.append(np.stack(s_hist))
    states = np.stack(all_states, axis=1)   # (T, n_agents, 9)
    preds = np.stack(all_preds, axis=1)     # (T, n_agents, N+1, 9)

    track = make_track(args.map, device="cpu")
    out1 = plot_experiment(track, states, path=args.path, name="replay.png")
    out2 = plot_performance(states, 0.02, path=args.path,
                            name="replay_perf.png")
    print("wrote", out1, "and", out2)
    if args.gif:
        out3 = animate_experiment(track, states, path=args.path,
                                  preds=preds, every=args.every)
        print("wrote", out3)


if __name__ == "__main__":
    main()
