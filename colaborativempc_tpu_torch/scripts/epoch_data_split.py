"""Split the epoch-data kernel's time into its barrier intervals (card
only).

The kernel (``csrc/epoch_data.cu``) is built a second time with
``-DCMPC_EPOCH_DATA_CLOCKS`` (``ops/_build.py load_epoch_data_clocks``, a
library of its own; the port runs the default build, which has no stamps).
That build stamps ``clock64()`` at each barrier of each block: the clock
at which thread 0 arrives and the clock at which the block's last warp
arrives, which is when the barrier releases. An interval's cycles are the
last warp's arrival at its barrier less the last warp's arrival at the
barrier before; ``thread 0 early`` is how long before the last warp
thread 0 arrived (0 when thread 0 is the straggler). This script prints,
per shape, the mean cycles of each interval kind over the blocks and the
stages, the cycles per stage, and the kernel's time in the default and the
clocked build (CUDA events, a spin kernel queued ahead of the calls so
that the host's queueing stays outside the window):

    python -m colaborativempc_tpu_torch.scripts.epoch_data_split

Each block's last stamp row holds its SM and its start and end on the
global timer: the script also prints how many blocks ran at once on one
SM and the launch's wall time.

``--source`` reads another copy of ``epoch_data.cu`` that exports the
same clocked entry (``cmpc_epoch_data_clocked``,
``cmpc_epoch_data_clock_stamps``, ``cmpc_epoch_data_clock_names``), for
instance an earlier design, at the same shapes. ``--parent DIR`` takes
another checkout of the repo (for instance an earlier commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists) and
times its package's ``epoch_data_batched`` against this tree's in turns
(it, this, this, it), each of its turns in a process of its own that
builds and imports that checkout (``scripts/clock_split.py turns``), with
the entries whose bits differ between the two:

    python -m colaborativempc_tpu_torch.scripts.epoch_data_split \
        --parent _scratch/parent

Random stage QPs from a seed (rows as the LPV planner's: row 0 soft,
row 1 one-sided, the rest hard).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from colaborativempc_tpu_torch.scripts.clock_split import (
    card, differing, event_ms, print_split, split, turns,
)

# (P, N, nz, nc, mr): the LPV headline, a ragged few QPs, the long horizon
# at the headline's batch and at one NL fleet's 3 agents, the NL
# Monte-Carlo's hp_opt QPs (64 fleets x 3 agents), the MPCC race and the
# MPCC battery; then the NL Monte-Carlo's hp_opt QPs at 5, 8 and 9 agents
# (64 fleets; nc = 10, 16 and 18)
SHAPES = {
    "headline": (768, 20, 11, 2, 6),
    "p7": (7, 20, 11, 2, 6),
    "n125": (768, 125, 11, 2, 6),
    "n125_fleet": (3, 125, 11, 2, 6),
    "nl_hp_opt": (192, 20, 11, 6, 10),
    "mpcc_p1_n60": (1, 60, 11, 2, 7),
    "mpcc_p18_n20": (18, 20, 11, 2, 7),
    "hp_opt_5_agents": (320, 20, 11, 10, 16),
    "hp_opt_8_agents": (512, 20, 11, 16, 25),
    "hp_opt_9_agents": (576, 20, 11, 18, 28),
}


def stage_qps(P, N, nz, nc, mr, dev, seed=0):
    """P random well-conditioned stage QPs on ``dev`` (float32) and a
    per-problem rho_scale."""
    from colaborativempc_tpu_torch.ops import LQRCost, LQRDynamics, StageQP
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(P, N + 1, nz, nz))
    Rm = rng.normal(size=(P, N, nc, nc))
    lo = -rng.uniform(0.05, 0.5, size=(P, N, mr))
    hi = rng.uniform(0.05, 0.5, size=(P, N, mr))
    hi[:, :, 1] = np.inf
    soft = np.full((P, N, mr), np.inf)
    soft[:, :, 0] = 50.0

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    qp = StageQP(
        dyn=LQRDynamics(t(np.eye(nz) + 0.05 * rng.normal(size=(P, N, nz, nz))),
                        t(0.2 * rng.normal(size=(P, N, nz, nc))),
                        t(0.01 * rng.normal(size=(P, N, nz)))),
        cost=LQRCost(t(0.1 * A @ np.swapaxes(A, -1, -2) + np.eye(nz)),
                     t(rng.normal(size=(P, N + 1, nz))),
                     t(0.1 * Rm @ np.swapaxes(Rm, -1, -2) + np.eye(nc)),
                     t(rng.normal(size=(P, N, nc))),
                     t(0.05 * rng.normal(size=(P, N, nz, nc)))),
        D=t(0.5 * rng.normal(size=(P, N, mr, nz))),
        E=t(0.5 * rng.normal(size=(P, N, mr, nc))), lo=t(lo), hi=t(hi),
        soft_lo=t(soft), soft_hi=t(soft))
    return qp, t(rng.uniform(0.5, 2.0, size=(P, mr)))


def kernel_times(names, dev) -> dict:
    """``epoch_data_batched`` of the package that ``sys.path`` finds, at
    each named shape: its device ms and its outputs (the kernel's fields
    K .. fac_hi, on the CPU)."""
    from colaborativempc_tpu_torch.ops import cuda_lqr
    out = {}
    for name in names:
        qp, rs = stage_qps(*SHAPES[name], dev)
        fields = cuda_lqr.epoch_data_batched(qp, 10.0, rs)
        kept = [fields[i].cpu() for i in (3, 4, 5, 6, 9, 10, 13, 14, 15)]
        out[name] = {"ms": event_ms(
            lambda: cuda_lqr.epoch_data_batched(qp, 10.0, rs)), "out": kept}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=None,
                    help="another epoch_data.cu with the clocked entry "
                         "(default: the package's)")
    ap.add_argument("--parent", default=None,
                    help="another checkout of the repo whose "
                         "epoch_data_batched is timed against this tree's "
                         "in turns")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated names of " + ", ".join(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("epoch_data_split: needs a CUDA device")
    names = args.shapes.split(",")
    dev = torch.device("cuda", 0)
    from colaborativempc_tpu_torch.ops import cuda_lqr
    info = card()
    print(info, f"source {args.source or 'csrc/epoch_data.cu'}", flush=True)
    report = {"card": info, "source": args.source or "csrc/epoch_data.cu",
              "shapes": {}}
    if args.parent:
        report["shapes"] = turns(__file__, args.parent, names,
                                 lambda n: kernel_times(n, dev))
    for name in names:
        P, N, nz, nc, mr = SHAPES[name]
        qp, rs = stage_qps(P, N, nz, nc, mr, dev)
        fields, clocks, labels, plan = cuda_lqr.epoch_data_clocked(
            qp, 10.0, rs, source=args.source)
        torch.cuda.synchronize()
        res = split(clocks.cpu().numpy(), labels, N)
        res["plan"] = plan._asdict()
        res["clocked_ms"] = event_ms(lambda: cuda_lqr.epoch_data_clocked(
            qp, 10.0, rs, source=args.source))
        if args.source is None:
            ref = cuda_lqr.epoch_data_batched(qp, 10.0, rs)
            res["kernel_ms"] = event_ms(
                lambda: cuda_lqr.epoch_data_batched(qp, 10.0, rs))
            res["equal_to_default_build"] = differing(fields, ref) == 0
        report["shapes"].setdefault(name, {}).update(res)
        print(f"{name} P={P} N={N} nz={nz} nc={nc} mr={mr}: "
              f"{res['cycles_per_stage']:.0f} cycles per stage "
              f"(span {res['span_cycles']:.0f}), clocked build "
              f"{res['clocked_ms']:.4f} ms"
              + (f", default build {res['kernel_ms']:.4f} ms, outputs equal"
                 f" {res['equal_to_default_build']}" if args.source is None
                 else "") + f"; plan {res['plan']}; blocks at once per SM "
              f"{res.get('blocks_at_once_per_sm')}, wall "
              f"{res.get('wall_us')} us", flush=True)
        print_split(res)
    print(json.dumps(report))


if __name__ == "__main__":
    sys.exit(main())
