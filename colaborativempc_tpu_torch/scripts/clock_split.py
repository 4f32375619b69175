"""What the split scripts share (``scripts/epoch_data_split.py``,
``scripts/sqp_qp_split.py``; card only): reading a kernel's clock stamps,
timing a call on the card, and timing another checkout's kernel in turns
with this tree's.

A clock-stamped build of a kernel writes, per block, rows of (label,
thread 0's ``clock64()``, the block's last warp's ``clock64()``) at fixed
points, and a last row with the block's SM and its start and end on the
global timer. :func:`split` turns them into cycles per interval kind.

:func:`turns` times a kernel of another checkout (for instance an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists) against this tree's, in turns (it, this, this, it). Each of its
turns runs in a process of its own: this file run as a program, which puts
the other checkout first on ``sys.path``, imports its package, and calls
the split script's ``kernel_times`` (this tree's code, loaded from its
file) on it. The split script's ``kernel_times(names, dev)`` returns per
shape name ``{"ms": ..., "out": [tensors on the CPU], ...}``.

Imports nothing of the package at module level, so that a turn can import
the other checkout's.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def card() -> str:
    """The card's name and power limit, and its SM clock now and at most."""
    def smi(query):
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    return (f"{smi('name,power.limit')} (SM clock now, max: "
            f"{smi('clocks.sm,clocks.max.sm')})")


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
    """Mean cycles per interval kind from the stamps ``(blocks, stamps,
    3)`` (label, thread 0's clock, the last warp's clock), the first stamp
    of each block being the reference: an interval is the last warp's
    arrival at its stamp less the last warp's arrival at the stamp before.
    A last row of label <= -2 per block is the block's own (-2 - SM, start,
    end in ns of the global timer). ``N`` stages per problem give the
    cycles per stage."""
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


def print_split(res: dict, indent: str = "  "):
    for k, v in res["intervals"].items():
        print(f"{indent}{k}: {v['mean_cycles']:.0f} cycles (max "
              f"{v['max_cycles']:.0f}) x {v['count_per_block']} per "
              f"block, thread 0 arrives {v['thread0_early_cycles']:.0f} "
              f"cycles before the last warp", flush=True)


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


def host_us(fn, calls=50, batches=8):
    """The host's microseconds per call of ``fn``, queued without a
    synchronise (after one warm-up call): the best of ``batches`` batches
    of ``calls`` calls, each batch after a synchronise (the host's other
    work only ever adds time)."""
    fn()
    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def differing(a, b) -> int:
    """Entries whose bits differ (NaN against NaN counts as equal)."""
    return sum(int((x != y).sum()) - int((x.isnan() & y.isnan()).sum())
               for x, y in zip(a, b))


def _load(script: str):
    spec = importlib.util.spec_from_file_location("_split_script", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_times(script: str, root: str, names) -> dict:
    """``kernel_times(names, dev)`` of the split script ``script`` (this
    tree's file) on the package of the checkout ``root``, in a process of
    its own."""
    root = os.path.abspath(root)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "times.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        os.path.abspath(script), path, root, ",".join(names)],
                       check=True, cwd=root)
        return torch.load(path)


def turns(script: str, parent: str, names, here) -> dict:
    """The kernel of the checkout ``parent`` against this tree's in turns
    (it, this, this, it): per shape name both ms readings of each (and of
    any other number ``kernel_times`` gives) and the entries whose bits
    differ between the two; ``here(names)`` is this tree's
    ``kernel_times``."""
    t = [other_times(script, parent, names), here(names),
         here(names), other_times(script, parent, names)]
    out = {}
    for name in names:
        ms = [turn[name]["ms"] for turn in t]
        out[name] = {
            "parent_ms": [ms[0], ms[3]], "this_ms": [ms[1], ms[2]],
            "speedup": (ms[0] + ms[3]) / (ms[1] + ms[2]),
            "parent_entries_differing": differing(t[0][name]["out"],
                                                  t[1][name]["out"]),
            **{f"parent_{k}": [v, t[3][name][k]]
               for k, v in t[0][name].items() if k not in ("ms", "out")},
            **{f"this_{k}": [v, t[2][name][k]]
               for k, v in t[1][name].items() if k not in ("ms", "out")}}
        host = ("" if "host_us" not in t[0][name] else
                "; host us per call: parent {:.1f} / {:.1f}, this tree "
                "{:.1f} / {:.1f}".format(*(t[i][name]["host_us"]
                                           for i in (0, 3, 1, 2))))
        print(f"{name}: parent {ms[0]:.4f} / {ms[3]:.4f} ms, this tree "
              f"{ms[1]:.4f} / {ms[2]:.4f} ms, {out[name]['speedup']:.2f}x, "
              f"{out[name]['parent_entries_differing']} entries differ"
              + host, flush=True)
    return out


if __name__ == "__main__":
    # one turn of the other checkout: script, output path, root, shapes
    script, out_path, root, shapes = sys.argv[1:]
    sys.path.insert(0, root)
    import colaborativempc_tpu_torch as pkg
    assert os.path.abspath(pkg.__file__).startswith(root), pkg.__file__
    # the split script imports this module by its package name, which the
    # other checkout may not have: this file stands in for it
    sys.modules["colaborativempc_tpu_torch.scripts.clock_split"] = \
        sys.modules["__main__"]
    torch.save(_load(script).kernel_times(shapes.split(","),
                                          torch.device("cuda", 0)), out_path)
