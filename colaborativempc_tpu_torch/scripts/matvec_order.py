"""Read the card's order of operations for the batched matrix-vector
products of the NL and MPCC SQP builds (card only).

The plain builds (``planners/nl.py build_nl_qp_plain``,
``planners/mpcc.py build_mpcc_qp_plain``) form ``A @ x[..., None]`` over a
batch of problems x stages: 9 x 9 and 3 x 9 matrices by 9-vectors, 9 x 2
and 3 x 2 by 2-vectors; the NL matrices are row-major, torch.func's MPCC
Jacobians column-major. cuBLAS picks a routine by layout, shape and batch,
and each routine sums the terms in its own order. The build kernel
(``csrc/sqp_qp.cu``) reproduces that order, as ``ops/cuda_sqp.py
matvec_order`` records it. This script compares the library's results,
bit for bit, with emulations of the candidate orders (fused multiply-adds
through float64), prints the orders each layout, shape and batch size
matches, and bisects every batch size at which the order changes:

    python -m colaborativempc_tpu_torch.scripts.matvec_order

Candidates for an n-term row: ``halves`` (two fused multiply-add chains
from zero over [0, ceil(n/2)) and the rest, then their sum), ``even_odd``
(chains over the even and the odd terms), ``quarters`` (chains over [0,
4), [4, 8), [8, ...) summed as a butterfly, (q0 + q2) + (q1 + q3)),
``sequential`` (one chain) and ``products`` (each product rounded, then
summed in order).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

SHAPES = ((9, 9), (3, 9), (9, 2), (3, 2))


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _chain(A, x, idx):
    acc = torch.zeros(A.shape[:-1], device=A.device)
    for l in idx:
        acc = _fma(A[..., l], x[..., None, l], acc)
    return acc


def _products(A, x, k):
    acc = A[..., 0] * x[..., None, 0]
    for l in range(1, k):
        acc = acc + A[..., l] * x[..., None, l]
    return acc


def candidates(k: int) -> dict:
    h = (k + 1) // 2

    def quarters(A, x):
        q = [_chain(A, x, range(4 * c, min(k, 4 * c + 4)))
             for c in range(4)]
        return (q[0] + q[2]) + (q[1] + q[3])
    return {
        "halves": lambda A, x: _chain(A, x, range(h)) + _chain(
            A, x, range(h, k)),
        "even_odd": lambda A, x: _chain(A, x, range(0, k, 2)) + _chain(
            A, x, range(1, k, 2)),
        "quarters": quarters,
        "sequential": lambda A, x: _chain(A, x, range(k)),
        "products": lambda A, x: _products(A, x, k),
    }


def order_of(layout: str, m: int, k: int, batch: int, gen, dev,
             rows: int = 6_000):
    """The candidates whose results equal the library's for a batch of
    ``batch`` products of an m x k matrix (``row``- or ``col``-major) by a
    k-vector, as the plain builds write them, over at least ``rows``
    rows."""
    miss, total = None, 0
    cs = candidates(k)
    for _ in range(max(1, rows // (batch * m))):
        if layout == "col":
            A = torch.randn((batch, 1, k, m), device=dev,
                            generator=gen).transpose(-1, -2)
        else:
            A = torch.randn((batch, 1, m, k), device=dev, generator=gen)
        x = torch.randn((batch, 1, k), device=dev, generator=gen)
        y = (A @ x[..., None])[..., 0]
        miss = miss or {c: 0 for c in cs}
        for c, f in cs.items():
            miss[c] += int((f(A, x) != y).sum())
        total += y.numel()
    return tuple(sorted(c for c, n in miss.items() if n == 0)), total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches",
                    default="20,40,60,120,160,200,360,1000,2000,3840,"
                            "12997,12998,15360,20000,60000",
                    help="batch sizes (problems x stages) to read; every "
                         "change of order between two neighbours is "
                         "bisected")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("matvec_order: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = sorted(int(v) for v in args.batches.split(","))
    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "orders": {}, "switches": {}}
    for layout in ("row", "col"):
        for m, k in SHAPES:
            tag = f"{layout} {m}x{k}"
            seen = {b: order_of(layout, m, k, b, gen, dev)[0]
                    for b in batches}
            out["orders"][tag] = {b: list(o) for b, o in seen.items()}
            print(f"{tag}: " + ", ".join(f"{b} {list(o)}"
                                         for b, o in seen.items()),
                  flush=True)
            if k != 9:
                continue
            for lo, hi in zip(batches, batches[1:]):
                if seen[lo] == seen[hi]:
                    continue
                olo = seen[lo]
                while hi - lo > 1:
                    mid = (lo + hi) // 2
                    if order_of(layout, m, k, mid, gen, dev)[0] == olo:
                        lo = mid
                    else:
                        hi = mid
                out["switches"].setdefault(tag, []).append(
                    [lo, list(olo), hi,
                     list(order_of(layout, m, k, hi, gen, dev)[0])])
                print(f"{tag}: {list(olo)} up to batch {lo}, then from "
                      f"{hi} {out['switches'][tag][-1][3]}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
