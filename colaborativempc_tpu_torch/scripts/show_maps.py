"""Render named tracks to PNG (reference ``planner/scripts/show_maps.py``);
the port of the JAX package's ``scripts/show_maps.py``. Host plotting:
tracks are built on the CPU and matplotlib is required.

    python -m colaborativempc_tpu_torch.scripts.show_maps [track ...]
        [--out drawings]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tracks", nargs="*", default=None)
    ap.add_argument("--out", default="drawings")
    args = ap.parse_args(argv)

    from colaborativempc_tpu_torch.geometry import TRACK_NAMES, make_track
    from colaborativempc_tpu_torch.runtime.plotting import (
        plot_track, save_figure,
    )

    for name in args.tracks or list(TRACK_NAMES):
        ax = plot_track(make_track(name, device="cpu"))
        ax.set_title(name)
        print("wrote", save_figure(ax.figure, args.out, f"{name}.png"))


if __name__ == "__main__":
    main()
