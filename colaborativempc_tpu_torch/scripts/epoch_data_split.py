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
builds and imports that checkout, with the entries whose bits differ
between the two:

    python -m colaborativempc_tpu_torch.scripts.epoch_data_split \
        --parent _scratch/parent

Random stage QPs from a seed (rows as the LPV planner's: row 0 soft,
row 1 one-sided, the rest hard).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# (P, N, nz, nc, mr): the LPV headline, a ragged few QPs, the long horizon
# at the headline's batch and at one NL fleet's 3 agents, the NL
# Monte-Carlo's hp_opt QPs (64 fleets x 3 agents), the MPCC race and the
# MPCC battery
SHAPES = {
    "headline": (768, 20, 11, 2, 6),
    "p7": (7, 20, 11, 2, 6),
    "n125": (768, 125, 11, 2, 6),
    "n125_fleet": (3, 125, 11, 2, 6),
    "nl_hp_opt": (192, 20, 11, 6, 10),
    "mpcc_p1_n60": (1, 60, 11, 2, 7),
    "mpcc_p18_n20": (18, 20, 11, 2, 7),
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


def blocks_at_once(sm, start, end) -> int:
    """The most blocks that ran on one SM at the same time."""
    most = 0
    for s in np.unique(sm):
        ev = sorted([(t, 1) for t in start[sm == s]]
                    + [(t, -1) for t in end[sm == s]], key=lambda e: (e[0],
                                                                       e[1]))
        most = max(most, int(np.max(np.cumsum([d for _, d in ev]))))
    return most


def split(clocks: np.ndarray, names, N: int) -> dict:
    """Mean cycles per interval kind from the stamps ``(P, stamps, 3)``
    (label, thread 0's clock, the last warp's clock), the first stamp of
    each block being the reference. A last row of label <= -2 per block
    is the block's own (-2 - SM, start, end in ns of the global timer)."""
    info = {}
    if bool((clocks[:, -1, 0] <= -2).all()):
        sm = -2 - clocks[:, -1, 0]
        start, end = clocks[:, -1, 1], clocks[:, -1, 2]
        info = {"wall_us": float(end.max() - start.min()) / 1e3,
                "blocks_at_once_per_sm": blocks_at_once(sm, start, end)}
        clocks = clocks[:, :-1]
    label, t0, last = clocks[..., 0], clocks[..., 1], clocks[..., 2]
    used = label[0] >= 0
    label, t0, last = label[:, used], t0[:, used], last[:, used]
    dur = np.diff(last, axis=1)
    early = (last - t0)[:, 1:]
    kinds = label[0, 1:]
    out = {}
    for k in sorted(set(kinds.tolist())):
        sel = kinds == k
        out[names[k]] = {
            "count_per_block": int(sel.sum()),
            "mean_cycles": float(dur[:, sel].mean()),
            "max_cycles": float(dur[:, sel].max()),
            "thread0_early_cycles": float(early[:, sel].mean()),
            "cycles_per_block": float(dur[:, sel].sum(axis=1).mean()),
        }
    span = (last[:, -1] - last[:, 0]).astype(np.float64)
    return {"intervals": out, "span_cycles": float(span.mean()),
            "cycles_per_stage": float(span.mean() / N), **info}


def event_ms(fn, reps=20):
    """Mean device ms per call over ``reps`` calls after one warm-up; a
    spin kernel (twice the host's time to queue the calls, 5 to 500 ms)
    ahead of them keeps the device busy while the host queues."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(0.5, max(0.005, 2.0 * host * reps)) * 2.0e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def parent_times(parent: str, names) -> dict:
    """:func:`kernel_times` of the checkout ``parent``, in a process of its
    own (this file run with ``--times``)."""
    parent = os.path.abspath(parent)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "times.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--times", path, "--root", parent, "--shapes",
                        ",".join(names)], check=True, cwd=parent)
        return torch.load(path)


def differing(a, b) -> int:
    """Entries whose bits differ (NaN against NaN counts as equal)."""
    return sum(int((x != y).sum()) - int((x.isnan() & y.isnan()).sum())
               for x, y in zip(a, b))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=None,
                    help="another epoch_data.cu with the clocked entry "
                         "(default: the package's)")
    ap.add_argument("--parent", default=None,
                    help="another checkout of the repo whose "
                         "epoch_data_batched is timed against this tree's "
                         "in turns")
    ap.add_argument("--times", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated names of " + ", ".join(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("epoch_data_split: needs a CUDA device")
    names = args.shapes.split(",")
    dev = torch.device("cuda", 0)
    if args.times:
        # one turn of --parent, in the other checkout's own process
        sys.path.insert(0, os.path.abspath(args.root))
        import colaborativempc_tpu_torch as pkg
        assert os.path.abspath(pkg.__file__).startswith(
            os.path.abspath(args.root)), pkg.__file__
        torch.save(kernel_times(names, dev), args.times)
        return 0
    from colaborativempc_tpu_torch.ops import cuda_lqr
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    clocks_sm = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card, f"(SM clock now, max: {clocks_sm.strip()})",
          f"source {args.source or 'csrc/epoch_data.cu'}", flush=True)
    report = {"card": card, "source": args.source or "csrc/epoch_data.cu",
              "shapes": {}}
    if args.parent:
        turns = [parent_times(args.parent, names), kernel_times(names, dev),
                 kernel_times(names, dev), parent_times(args.parent, names)]
        for name in names:
            t = [turn[name]["ms"] for turn in turns]
            res = {"parent_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                   "parent_entries_differing": differing(
                       turns[0][name]["out"], turns[1][name]["out"])}
            report["shapes"][name] = res
            print(f"{name}: parent {t[0]:.4f} / {t[3]:.4f} ms, this tree "
                  f"{t[1]:.4f} / {t[2]:.4f} ms, "
                  f"{(t[0] + t[3]) / (t[1] + t[2]):.2f}x, "
                  f"{res['parent_entries_differing']} entries differ",
                  flush=True)
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
        for k, v in res["intervals"].items():
            print(f"  {k}: {v['mean_cycles']:.0f} cycles (max "
                  f"{v['max_cycles']:.0f}) x {v['count_per_block']} per "
                  f"block, thread 0 arrives {v['thread0_early_cycles']:.0f} "
                  f"cycles before the last warp", flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    sys.exit(main())
