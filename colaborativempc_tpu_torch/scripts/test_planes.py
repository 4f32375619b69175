"""Visual separating-hyperplane check (reference
``planner/scripts/test_planes.py``); the port of the JAX package's
``scripts/test_planes.py``. Draws random point pairs, computes their planes
with ``compute_hyperplanes``, asserts with ``plane_signed_distance`` that
each plane separates its pair symmetrically, and saves the figure. Host
work on CPU tensors; matplotlib is required.

    python -m colaborativempc_tpu_torch.scripts.test_planes [--out drawings]
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="drawings")
    args = ap.parse_args(argv)

    import torch
    from colaborativempc_tpu_torch.geometry import (
        compute_hyperplanes, plane_signed_distance,
    )
    from colaborativempc_tpu_torch.runtime.plotting import (
        pyplot, save_figure,
    )
    plt = pyplot()

    rng = np.random.default_rng(0)
    ego_np = rng.uniform(-2, 2, size=(6, 2))
    neigh_np = ego_np[:, None, :] + rng.uniform(0.5, 2.0, size=(6, 1, 2))
    ego, neigh = torch.tensor(ego_np), torch.tensor(neigh_np)
    planes = compute_hyperplanes(ego, neigh)

    fig, ax = plt.subplots(figsize=(7, 7))
    xs = np.linspace(-4, 4, 2)
    for h in range(6):
        a, b = planes[h, 0, :2].numpy(), float(planes[h, 0, 2])
        ax.plot(ego_np[h, 0], ego_np[h, 1], "bo")
        ax.plot(neigh_np[h, 0, 0], neigh_np[h, 0, 1], "rx")
        if abs(a[1]) > 1e-6:
            ax.plot(xs, (-b - a[0] * xs) / a[1], "k-", lw=0.7)
        de = float(plane_signed_distance(planes[h, 0], ego[h]))
        dn = float(plane_signed_distance(planes[h, 0], neigh[h, 0]))
        print(f"pair {h}: d(ego)={de:+.3f} d(neigh)={dn:+.3f} "
              f"(must be -, + and symmetric)")
        assert de < 0 < dn and abs(de + dn) < 1e-5
    ax.set_xlim(-4, 4)
    ax.set_ylim(-4, 4)
    ax.set_aspect("equal")
    out = save_figure(fig, args.out, "planes.png")
    print("wrote", out, "- planes separate correctly")


if __name__ == "__main__":
    main()
