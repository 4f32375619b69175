"""How far the ADMM epoch kernel and its float32 twin each lie from the
twin in float64, at long horizons and many rows or controls, with every
spill level's bits (card only).

Per shape and seed: the epoch kernel (``cuda_lqr.admm_epoch_batched``)
and its plain twin in float32 and in float64, all on the card, from
``scripts/epoch_data_split.py stage_qps`` inputs; for each output (z, c,
w, y, r_prim, r_dual) the kernel's max |error| from the float32 twin, and
the kernel's and the twin's max |error| from the float64 twin, over the
batch and in the mean over the QPs of each QP's max (``f64_distances``;
``chip_smoke.py`` holds the residuals of its spill shapes to the latter).
Also the entries whose bits differ between every spill level of
``kernel_plan`` that fits the shape (at the plan's ring) and the first:

    python -m colaborativempc_tpu_torch.scripts.epoch_f64 [--seeds 0,1]
"""

from __future__ import annotations

import argparse
import json

import torch

from colaborativempc_tpu_torch.scripts.clock_split import card

# (P, N, nc, mr): NL hp_opt 16, 29, 30 and 32 agents and LPV 196 agents at
# N=125 and LPV 744 at N=20, which fit shared memory; NL hp_opt 31 and 36
# agents and LPV 200 at N=125, hp_opt 48 and LPV 760 at N=20, which spill
SHAPES = ((8, 125, 32, 49), (29, 125, 58, 88), (30, 125, 60, 91),
          (1, 125, 64, 97), (196, 125, 2, 199), (744, 20, 2, 747),
          (31, 125, 62, 94), (36, 125, 72, 109), (200, 125, 2, 203),
          (48, 20, 96, 145), (760, 20, 2, 763))
EPOCH_LEN, ALPHA = 20, 1.6
FIELDS = ("z", "c", "w", "y", "rp", "rd")


def f64_distances(got, ref, ref64) -> dict:
    """Per output field: the kernel's max |error| from the float32 twin
    (``kernel_twin``), and the kernel's and the twin's from the float64
    twin over the batch (``kernel_f64``, ``twin_f64``) and in the mean
    over the QPs (axis 0) of each QP's max (``..._mean``)."""
    out = {}
    for f, g, r, q in zip(FIELDS, got, ref, ref64):
        g, r, q = g.double(), r.double(), q.double()
        red = tuple(range(1, g.dim()))
        out[f] = dict(
            kernel_twin=float((g - r).abs().max()),
            kernel_f64=float((g - q).abs().max()),
            twin_f64=float((r - q).abs().max()),
            kernel_f64_mean=float((g - q).abs().amax(dim=red).mean()),
            twin_f64_mean=float((r - q).abs().amax(dim=red).mean()))
    return out


def measure(P, N, nc, mr, seed, dev) -> dict:
    """One shape and seed on the card: ``f64_distances`` and the bits of
    every spill level that fits."""
    from colaborativempc_tpu_torch.ops import cuda_lqr
    from colaborativempc_tpu_torch.ops.admm import admm_epoch_inputs_plain
    from colaborativempc_tpu_torch.scripts.epoch_data_split import stage_qps
    qp, rs = stage_qps(P, N, 11, nc, mr, dev, seed=seed)
    data = admm_epoch_inputs_plain(qp, 10.0, rs)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    z0 = torch.randn((P, 11), device=dev, generator=gen)
    w0 = torch.clamp(0.1 * torch.randn((P, N, mr), device=dev,
                                       generator=gen), qp.lo, qp.hi)
    y0 = 0.05 * torch.randn((P, N, mr), device=dev, generator=gen)
    kw = dict(epoch_len=EPOCH_LEN, alpha=ALPHA)
    plan = cuda_lqr.kernel_plan(P, N, 11, nc, mr)
    outs = {}
    for level in range(len(cuda_lqr.SPILLS)):
        try:
            pinned = cuda_lqr.kernel_plan(P, N, 11, nc, mr, ring=plan.ring,
                                          spill=level)
        except ValueError:
            continue
        outs[level] = cuda_lqr.admm_epoch_batched(data, z0, w0, y0,
                                                  plan=pinned, **kw)
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0, **kw)
    ref64 = cuda_lqr.admm_epoch_batched_plain(
        type(data)(*(t.double() for t in data)), z0.double(), w0.double(),
        y0.double(), **kw)
    torch.cuda.synchronize()
    first = outs[min(outs)]
    return dict(P=P, N=N, nc=nc, mr=mr, seed=seed, spilled=plan.spilled,
                levels_differing={lv: sum(int((a != b).sum())
                                          for a, b in zip(o, first))
                                  for lv, o in outs.items()},
                **f64_distances(outs[plan.spill], ref, ref64))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("epoch_f64: needs a CUDA device")
    dev = torch.device("cuda", 0)
    info = card()
    print(info, flush=True)
    rows = []
    for P, N, nc, mr in SHAPES:
        for seed in (int(s) for s in args.seeds.split(",")):
            r = measure(P, N, nc, mr, seed, dev)
            rows.append(r)
            print(f"P={P} N={N} nc={nc} mr={mr} seed {seed} "
                  f"({r['spilled'] or 'fits'}; levels differing "
                  f"{r['levels_differing']}): " + "; ".join(
                      f"{f} kernel-twin {r[f]['kernel_twin']:.3g}, vs "
                      f"float64 kernel {r[f]['kernel_f64']:.3g} / mean "
                      f"{r[f]['kernel_f64_mean']:.3g}, twin "
                      f"{r[f]['twin_f64']:.3g} / mean "
                      f"{r[f]['twin_f64_mean']:.3g}"
                      for f in ("z", "rp", "rd")), flush=True)
    print(json.dumps({"card": info, "rows": rows}))


if __name__ == "__main__":
    main()
