"""Split the ADMM epoch kernel's time into the parts of an iteration (card
only).

The kernel (``csrc/lqr_kernels.cu``) is built a second time with
``-DCMPC_ADMM_EPOCH_CLOCKS`` (``ops/_build.py load_admm_epoch_clocks``, a
library of its own; the port runs the default build, which has no
stamps). That build stamps ``clock64()`` in each QP's warp, once the warp
has converged, after each part of its solve: the first load of the ring,
and per visit of a chunk the ring feed (the next chunk's copies issued),
the backward pre-pass (t and q + D't), the backward chain, the forward
chain, the row pass (rows, prox, dual update, residuals, outputs) and the
ring wait (the fed chunk's arrival). An interval's cycles are its stamp
less the stamp before. This script prints, per shape, the mean cycles of
each part per QP, the cycles per stage step of each chain (a chain's
cycles over N stages and ``epoch_len`` iterations), and the kernel's time
in the default and the clocked build (CUDA events, a spin kernel queued
ahead of the calls so that the host's queueing stays outside the
window), with the clocked build's outputs held to the default build's bit
for bit:

    python -m colaborativempc_tpu_torch.scripts.admm_epoch_split

The shapes are the benchmark's (:data:`SHAPES`): the LPV Monte-Carlo's
192 QPs and one LPV fleet's 3 at N=125 (``epoch_len`` 15), the NL
Monte-Carlo's 192 QPs at N=20 (``epoch_len`` 20); nz 11, nc 2, mr 6. Each
QP's last stamp row holds its SM and its start and end on the global
timer: the script also prints how many QPs ran at once on one SM and the
launch's wall time.

``--source`` reads another copy of ``lqr_kernels.cu`` that exports the
same clocked entry (``cmpc_admm_epoch_clocked``,
``cmpc_admm_epoch_clock_stamps``, ``cmpc_admm_epoch_clock_names``), for
instance an earlier design, at the same shapes. The kernel's times and
bits against another checkout, in turns: ``scripts/epoch_turns.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from colaborativempc_tpu_torch.scripts.clock_split import (
    card, differing, event_ms, split,
)
from colaborativempc_tpu_torch.scripts.epoch_turns import epoch_inputs

# name: (P, N, nc, mr, epoch_len); nz = 11
SHAPES = {
    "lpv_mc64": (192, 125, 2, 6, 15),
    "lpv_fleet1": (3, 125, 2, 6, 15),
    "nl_mc64": (192, 20, 2, 6, 20),
}
ALPHA = 1.6
CHAINS = ("backward chain", "forward chain")


def per_stage_step(res: dict, N: int, epoch_len: int) -> dict:
    """Cycles per stage step of each chain: its cycles per QP over the N
    stages of ``epoch_len`` iterations."""
    return {k: res["intervals"][k]["cycles_per_block"] / (N * epoch_len)
            for k in CHAINS if k in res["intervals"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=None,
                    help="another lqr_kernels.cu with the clocked entry "
                         "(default: the package's)")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated names of " + ", ".join(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("admm_epoch_split: needs a CUDA device")
    dev = torch.device("cuda", 0)
    from colaborativempc_tpu_torch.ops import cuda_lqr
    info = card()
    src = args.source or "csrc/lqr_kernels.cu"
    print(info, f"source {src}", flush=True)
    report = {"card": info, "source": src, "shapes": {}}
    for name in args.shapes.split(","):
        P, N, nc, mr, el = SHAPES[name]
        data, z0, w0, y0 = epoch_inputs(P, N, nc, mr, dev)
        kw = dict(epoch_len=el, alpha=ALPHA)
        got, clocks, labels, plan = cuda_lqr.admm_epoch_clocked(
            data, z0, w0, y0, source=args.source, **kw)
        torch.cuda.synchronize()
        res = split(clocks.cpu().numpy(), labels, N * el)
        res["cycles_per_stage_step"] = per_stage_step(res, N, el)
        res["plan"] = plan._asdict()
        res["clocked_ms"] = event_ms(lambda: cuda_lqr.admm_epoch_clocked(
            data, z0, w0, y0, source=args.source, **kw), reps=5)
        if args.source is None:
            ref = cuda_lqr.admm_epoch_batched(data, z0, w0, y0, **kw)
            res["kernel_ms"] = event_ms(
                lambda: cuda_lqr.admm_epoch_batched(data, z0, w0, y0, **kw),
                reps=5)
            res["equal_to_default_build"] = differing(got, ref) == 0
        report["shapes"][name] = res
        steps = ", ".join(f"{k} {v:.0f}" for k, v in
                          res["cycles_per_stage_step"].items())
        print(f"{name} P={P} N={N} nc={nc} mr={mr} epoch_len={el}: "
              f"{res['span_cycles']:.0f} cycles per QP; per stage step "
              f"{steps}; clocked build {res['clocked_ms']:.4f} ms"
              + (f", default build {res['kernel_ms']:.4f} ms, outputs equal"
                 f" {res['equal_to_default_build']}" if args.source is None
                 else "") + f"; plan {res['plan']}; QPs at once per SM "
              f"{res.get('blocks_at_once_per_sm')}, wall "
              f"{res.get('wall_us')} us", flush=True)
        for k, v in res["intervals"].items():
            print(f"  {k}: {v['cycles_per_block']:.0f} cycles per QP "
                  f"({100 * v['cycles_per_block'] / res['span_cycles']:.1f}%"
                  f"), {v['count_per_block']} x {v['mean_cycles']:.0f} "
                  f"(max {v['max_cycles']:.0f})", flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    sys.exit(main())
