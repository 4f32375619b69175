"""Paper-style comparison figures from recorded experiments (reference
``planner/scripts/exp_gen_figs.py`` + ``paper_gen_figs.py``); the port of
the JAX package's ``scripts/paper_figs.py``. Overlays all agents of one
experiment, and compares experiments (LPV against NL) when several
directories are given. Host plotting: matplotlib is required.

    python -m colaborativempc_tpu_torch.scripts.paper_figs data/LPV3r
        [data/NL_3agents_eu] [--map Highway] [--out drawings]
"""

import argparse
import os

import numpy as np


def executed_states(path):
    """``(T, n_agents, 9)``: row 0 of each stored prediction."""
    from colaborativempc_tpu_torch.runtime.io import load_experiment
    n_agents = 0
    while os.path.isdir(os.path.join(path, "pck", str(n_agents))):
        n_agents += 1
    return np.stack([np.stack([s[0] for s in load_experiment(path, a)[0]])
                     for a in range(n_agents)], axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--map", default="Highway")
    ap.add_argument("--out", default="drawings")
    args = ap.parse_args(argv)

    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.runtime.plotting import (
        plot_track, save_figure,
    )

    ax = plot_track(make_track(args.map, device="cpu"))
    styles = ["-", "--", ":"]
    for p_i, path in enumerate(args.paths):
        st = executed_states(path)
        label = os.path.basename(os.path.normpath(path))
        for a in range(st.shape[1]):
            ax.plot(st[:, a, 7], st[:, a, 8], styles[p_i % 3], lw=1.3,
                    label=f"{label} agent {a}" if a == 0 else None)
    ax.legend(fontsize=8)
    print("wrote", save_figure(ax.figure, args.out, "comparison.png",
                               dpi=140))


if __name__ == "__main__":
    main()
