"""Time the ADMM epoch kernel and the affine kernel (``csrc/lqr_kernels.cu``)
of this tree against another checkout's, in turns, and count the entries
whose bits differ (card only).

``--parent DIR`` takes another checkout of the repo (for instance an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); each of its turns runs in a process of its own, in
the order it, this, this, it (``scripts/clock_split.py turns``):

    python -m colaborativempc_tpu_torch.scripts.epoch_turns \\
        --parent _scratch/parent

Without ``--parent`` it prints this tree's times alone. The shapes are
``chip_smoke.py`` phase 3's and 13's (:data:`SHAPES`): the LPV headline,
N=125, a ragged block, the NL hp_opt QPs and the MPCC race and battery.
The inputs are ``scripts/epoch_data_split.py stage_qps`` from a seed, their
epoch data the plain version's (``admm_epoch_inputs_plain``), so both
checkouts' kernels read the same data; each kernel runs under the launch
plan ``kernel_plan`` chooses (the same in both checkouts at these
shapes), or the one pinned.
"""

from __future__ import annotations

import argparse
import json

import torch

from colaborativempc_tpu_torch.scripts.clock_split import (
    card, event_ms, turns,
)

# name: (P, N, nc, mr, pinned plan arguments); nz = 11
SHAPES = {
    "headline": (768, 20, 2, 6, {}),
    "n125": (768, 125, 2, 6, {}),
    "p7": (7, 20, 2, 6, dict(qps_per_block=4)),
    "nl_hp_opt": (192, 20, 6, 10, {}),
    "mpcc_p1_n60": (1, 60, 2, 7, {}),
    "mpcc_p18_n20": (18, 20, 2, 7, {}),
}
EPOCH_LEN, ALPHA = 20, 1.6


def kernel_times(names, dev) -> dict:
    """Per shape name, for ``epoch:<name>`` and ``affine:<name>``: the
    kernel's device ms (``clock_split.event_ms``) and its outputs (on the
    CPU), in the package that ``sys.path`` finds."""
    from colaborativempc_tpu_torch.ops import cuda_lqr
    from colaborativempc_tpu_torch.ops.admm import admm_epoch_inputs_plain
    from colaborativempc_tpu_torch.scripts.epoch_data_split import stage_qps
    out = {}
    for name in names:
        kind, shape = name.split(":")
        P, N, nc, mr, pin = SHAPES[shape]
        qp, rs = stage_qps(P, N, 11, nc, mr, dev, seed=3)
        data = admm_epoch_inputs_plain(qp, 10.0, rs)
        gen = torch.Generator(device=dev).manual_seed(5)
        z0 = torch.randn((P, 11), device=dev, generator=gen)
        if kind == "epoch":
            w0 = torch.clamp(0.1 * torch.randn((P, N, mr), device=dev,
                                               generator=gen), qp.lo, qp.hi)
            y0 = 0.05 * torch.randn((P, N, mr), device=dev, generator=gen)
            plan = cuda_lqr.kernel_plan(P, N, 11, nc, mr, **pin)

            def fn():
                return cuda_lqr.admm_epoch_batched(
                    data, z0, w0, y0, epoch_len=EPOCH_LEN, alpha=ALPHA,
                    plan=plan)
        else:
            plan = cuda_lqr.kernel_plan(P, N, 11, nc, 0, **pin)
            args = (data.F, data.G, data.d, data.K, data.Quu_inv, data.Qxu,
                    data.m, data.q, data.r, z0)

            def fn():
                return cuda_lqr.lqr_affine_solve_batched(*args, plan=plan)
        got = [t.cpu() for t in fn()]
        out[name] = {"ms": event_ms(fn, reps=5 if N > 100 else 20),
                     "out": got}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout of the repo whose kernels are "
                         "timed against this tree's in turns")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated names of " + ", ".join(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("epoch_turns: needs a CUDA device")
    dev = torch.device("cuda", 0)
    names = [f"{k}:{s}" for s in args.shapes.split(",")
             for k in ("epoch", "affine")]
    info = card()
    print(info, flush=True)
    if args.parent:
        report = turns(__file__, args.parent, names,
                       lambda n: kernel_times(n, dev))
    else:
        report = {n: {"ms": r["ms"]}
                  for n, r in kernel_times(names, dev).items()}
        for n, r in report.items():
            print(f"{n}: {r['ms']:.4f} ms", flush=True)
    print(json.dumps({"card": info, "shapes": report}))


if __name__ == "__main__":
    main()
