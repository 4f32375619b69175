"""Read the card's order of operations for the library routines that the
plain epoch data and the plain SQP builds call (card only).

The epoch-data kernel (``csrc/epoch_data.cu``) and the NL build kernel
(``csrc/sqp_qp.cu``) hold their plain versions bit for bit, so they follow
the order in which the card's libraries sum: cuBLAS's batched GEMM
(``build_admm_cost``'s ``Dw'D``, ``Ew'E``, ``Dw'E``, summed over the mr
rows; ``lqr_factorize``'s ``P F``, ``F'(P F)``, ``G'(P G)``, ``F'(P G)``
and ``Qxu K``, the last summed over the nc controls), the batched Cholesky
of ``torch.linalg.cholesky_ex`` and the batched solves of
``torch.cholesky_solve`` (``K`` with nz right-hand sides, ``Quu_inv`` with
nc), ``torch.sum`` over the neighbours (the NL build's price on the
position, eu and hp), and cuBLAS's batched matrix-vector products of the
NL and MPCC builds (``A @ x[..., None]`` over problems x stages: 9 x 9
and 3 x 9 matrices by 9-vectors, 9 x 2 and 3 x 2 by 2-vectors, the NL
matrices row-major, torch.func's MPCC Jacobians column-major; the build
kernel follows the order ``ops/cuda_sqp.py matvec_order`` records). A
fleet of more agents makes mr, nc and the neighbour count larger, and a
library may take another routine there; cuBLAS picks a matrix-vector
routine by layout, shape and batch.
This script compares the library's results, bit for bit, with emulations
of candidate orders (fused multiply-adds exact through float64) at the
shapes large fleets give, and prints, per shape, the entries each
candidate misses and, for the factor and the solves, the first column or
row where the sequential order parts from the library:

    python -m colaborativempc_tpu_torch.scripts.library_order

Candidates, each with the order read off the card first. GEMM, per entry
over k terms: ``sequential`` (one chain of fused multiply-adds from zero
in index order: read), ``split2`` (two halves, a chain each, summed),
``lanes<w>`` (term l on chain l mod w, the chains summed as a
butterfly). Cholesky, column by column: ``panels`` (read: the columns of
the current panel of 16 as fused multiply-adds onto the entry, each
earlier panel of 16 within the block of 64, and each earlier block of
64, as a sum of its own from zero, subtracted; then times 1 / L_jj) and
``unblocked``. Solves: ``split`` (read: the rows split recursively, the
bottom part the largest 16 * 2^k below them, down to blocks of 16,
forward in index order and back in reverse, each row times 1 / L_ii; a
part's rows take the other part's terms as a chain from zero,
subtracted) and ``sequential``. Sum over n terms: ``torch_tree`` (a
contiguous last axis: w lanes, w the largest power of two below n, lane
l summing terms l, l + w, ..., the lanes as a butterfly from w / 2 down),
``accumulators`` (an axis off the fastest stride, as the NL build's
price: four accumulators per output) and ``sequential``. Matrix-vector
product, per n-term row: ``halves`` (two chains from zero over [0,
ceil(n/2)) and the rest, then their sum), ``even_odd`` (chains over the
even and the odd terms), ``quarters`` (chains over [0, 4), [4, 8), [8,
...) summed as a butterfly, (q0 + q2) + (q1 + q3)), ``sequential`` (one
chain) and ``products`` (each product rounded, then summed in order);
every batch size at which the order changes is bisected. ``--dump PATH``
saves the routines' inputs and results for reading further orders
elsewhere.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

INF = float("inf")


def fma(a, b, c):
    """float32 fused multiply-add, exact: the product is exact in float64,
    the sum's rounding error is carried (TwoSum) to decide a float32
    tie."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, INF))
    dn = torch.nextafter(r, torch.full_like(r, -INF))
    rd = r.double()
    r = torch.where((s == (rd + up.double()) / 2) & (e > 0), up, r)
    r = torch.where((s == (rd + dn.double()) / 2) & (e < 0), dn, r)
    return r


# --- GEMM -------------------------------------------------------------------

def _gemm_chain(A, B, idx):
    acc = torch.zeros(A.shape[:-1] + B.shape[-1:], device=A.device)
    for l in idx:
        acc = fma(A[..., :, l, None], B[..., None, l, :], acc)
    return acc


def gemm_candidates(k: int) -> dict:
    def split(s):
        w = -(-k // s)

        def f(A, B):
            acc = _gemm_chain(A, B, range(0, min(w, k)))
            for c in range(1, s):
                acc = acc + _gemm_chain(A, B, range(c * w, min(k, c * w + w)))
            return acc
        return f

    def lanes(w):
        def f(A, B):
            vals = [_gemm_chain(A, B, range(l, k, w)) for l in range(w)]
            while len(vals) > 1:
                vals = [vals[i] + vals[i + 1] for i in range(0, len(vals), 2)]
            return vals[0]
        return f
    out = {"sequential": lambda A, B: _gemm_chain(A, B, range(k))}
    if k >= 4:
        out["split2"] = split(2)
    for w in (2, 32):
        if k >= w:
            out[f"lanes{w}"] = lanes(w)
    return out


def gemm_cases(P, N, nz, nc, mr, gen, dev):
    """The plain epoch data's products at one shape, built as the plain
    version builds them (layouts and batch strides alike)."""
    def rn(*s):
        return torch.randn(s, device=dev, generator=gen)
    D, E = rn(P, N, mr, nz), rn(P, N, mr, nc)
    rv = torch.rand((P, N, mr), device=dev, generator=gen) * 10
    Dw = D * rv[..., None]
    yield "Dw'D", Dw.transpose(-1, -2), D
    yield "Ew'E", (E * rv[..., None]).transpose(-1, -2), E
    yield "Dw'E", Dw.transpose(-1, -2), E
    Fs, Gs = rn(P, N, nz, nz), rn(P, N, nz, nc)
    Pm = rn(P, nz, nz)
    Pm = 0.5 * (Pm + Pm.transpose(-1, -2))
    F, G = Fs[:, N - 1], Gs[:, N - 1]
    PF, PG = Pm @ F, Pm @ G
    yield "P F", Pm, F
    yield "P G", Pm, G
    yield "F'(PF)", F.transpose(-1, -2), PF
    yield "G'(PG)", G.transpose(-1, -2), PG
    yield "F'(PG)", F.transpose(-1, -2), PG
    Qxu = rn(P, nz, nc)
    M = rn(P, nc, nc)
    Quu = M @ M.transpose(-1, -2) + nc * torch.eye(nc, device=dev)
    L, _ = torch.linalg.cholesky_ex(Quu)
    K = -torch.cholesky_solve(Qxu.transpose(-1, -2), L)
    yield "Qxu K", Qxu, K


def read_gemm(shapes, gen, dev, keep: int = 64):
    """Per shape and product: the entries each GEMM candidate misses over
    the first ``keep`` matrices of the batch."""
    out = {}
    for P, N, nc, mr in shapes:
        for name, A, B in gemm_cases(P, N, 11, nc, mr, gen, dev):
            C = A @ B
            A2 = A.reshape((-1,) + A.shape[-2:])[:keep]
            B2 = B.reshape((-1,) + B.shape[-2:])[:keep]
            C2 = C.reshape((-1,) + C.shape[-2:])[:keep]
            k = A.shape[-1]
            miss = {c: int((f(A2, B2) != C2).sum())
                    for c, f in gemm_candidates(k).items()}
            tag = (f"P={P} N={N} nc={nc} mr={mr} {name} "
                   f"({A.shape[-2]}x{k} @ {k}x{B.shape[-1]}, batch "
                   f"{C.numel() // (C.shape[-1] * C.shape[-2])})")
            out[tag] = dict(miss=miss, entries=C2.numel())
            ok = [c for c, n in miss.items() if n == 0]
            print(f"gemm {tag}: matches {ok}; misses "
                  f"{ {c: n for c, n in miss.items() if n} }", flush=True)
    return out


# --- Cholesky and the solves -------------------------------------------------

def chol_emulate(A, panels: bool):
    """The Cholesky factor of A (batch, n, n), lower, a column at a time
    (the rows of a column at once), each entry's earlier columns as fused
    multiply-adds onto it, then times 1 / L_jj; with ``panels`` (the
    library's order) the columns of each earlier panel of 16 within the
    current block of 64, and of each earlier block of 64, as a sum of
    their own from zero, subtracted. Returns the factor and 1 / L_jj."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    rcp = torch.zeros(A.shape[:-1], device=A.device)
    for j in range(n):
        v = A[:, j:, j]
        Li, Lj = L[:, j:, :], L[:, j, None, :]
        J0, O = ((j // 16) * 16, (j // 64) * 64) if panels else (0, 0)
        for P0 in list(range(0, O, 64)) + list(range(O, J0, 16)):
            s = torch.zeros_like(v)
            for l in range(P0, P0 + (64 if P0 < O else 16)):
                s = fma(Li[..., l], Lj[..., l], s)
            v = v - s
        for l in range(J0, j):
            v = fma(-Li[..., l], Lj[..., l], v)
        d = torch.sqrt(v[:, 0].double()).float()  # correctly rounded
        rcp[:, j] = 1.0 / d
        L[:, j, j] = d
        L[:, j + 1:, j] = v[:, 1:] * rcp[:, j, None]
    return L, rcp


def _split(m: int) -> int:
    """Rows of the top part of a triangular solve of m > 16 rows: the
    bottom part is the largest 16 * 2^k below m."""
    b = 16
    while 2 * b < m:
        b *= 2
    return m - b


def solve_emulate(L, rcp, B, split: bool = True):
    """cholesky_solve(B, L): L L' X = B, forward in index order and back in
    reverse, each row times 1 / L_ii; with ``split`` (the library's order,
    read off the card) the rows split recursively (:func:`_split`) down to
    blocks of at most 16, a part's rows taking the other part's terms as
    one chain from zero in index order, subtracted."""
    return _solve_blocks(L, rcp, B, 16 if split else L.shape[-1])


def _solve_blocks(L, rcp, B, leaf: int):
    n = L.shape[-1]
    Y = B.clone()
    for i in range(n):
        v, s, e = Y[:, i, :], 0, n
        while e - s > leaf:
            m1 = _split(e - s)
            if i >= s + m1:
                acc = torch.zeros_like(v)
                for j in range(s, s + m1):
                    acc = fma(L[:, i, j, None], Y[:, j, :], acc)
                v = v - acc
                s += m1
            else:
                e = s + m1
        for j in range(s, i):
            v = fma(-L[:, i, j, None], Y[:, j, :], v)
        Y[:, i, :] = v * rcp[:, i, None]
    X = Y.clone()
    for i in range(n - 1, -1, -1):
        v, s, e = X[:, i, :], 0, n
        while e - s > leaf:
            m1 = _split(e - s)
            if i < s + m1:
                acc = torch.zeros_like(v)
                for j in range(s + m1, e):
                    acc = fma(L[:, j, i, None], X[:, j, :], acc)
                v = v - acc
                e = s + m1
            else:
                s += m1
        for j in range(e - 1, i, -1):
            v = fma(-L[:, j, i, None], X[:, j, :], v)
        X[:, i, :] = v * rcp[:, i, None]
    return X


def _first(mask):
    """The first column of an (n, n) mask with a miss in it."""
    cols = mask.any(0).nonzero()
    return int(cols[0]) if len(cols) else None


def read_cholesky(sizes, batches, gen, dev, nz: int = 11):
    out = {}
    for n in sizes:
        for batch in batches:
            M = torch.randn((batch, n, n), device=dev, generator=gen)
            A = M @ M.transpose(-1, -2) + n * torch.eye(n, device=dev)
            A = 0.5 * (A + A.transpose(-1, -2))
            L, info = torch.linalg.cholesky_ex(A)
            Bk = torch.randn((batch, n, nz), device=dev, generator=gen)
            eye = torch.eye(n, device=dev).expand(batch, n, n)
            Xk = torch.cholesky_solve(Bk, L)
            Xi = torch.cholesky_solve(eye, L)
            row = {}
            for name, panels in (("panels", True), ("unblocked", False)):
                Le, _ = chol_emulate(A, panels)
                miss = (Le != L).tril()
                row[f"factor {name}"] = [int(miss.sum()),
                                         _first(miss.any(0))]
            # the solves from the library's own factor and 1 / its diagonal
            rl = 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)
            for name, split in (("split", True), ("sequential", False)):
                for what, Bm, X in (("K", Bk, Xk), ("inv", eye.clone(), Xi)):
                    miss = solve_emulate(L, rl, Bm, split) != X
                    rows = miss.any(0).any(-1).nonzero()
                    first = int(rows[0]) if len(rows) else None
                    row[f"solve {what} {name}"] = [int(miss.sum()), first]
            tag = f"n={n} batch={batch} (info {int(info.abs().sum())})"
            out[tag] = row
            print(f"cholesky {tag}: " + "; ".join(
                f"{k} {v[0]}" + (f" (from {v[1]})" if v[1] is not None else "")
                for k, v in row.items()), flush=True)
    return out


# --- torch.sum over the neighbours ------------------------------------------

def torch_tree_sum(x):
    """PyTorch's CUDA sum over a contiguous last dimension of n terms, as
    read off the card: w lanes, w the largest power of two below n (at
    most 32), lane l summing terms l, l + w, ... in turn, then a butterfly
    from the widest offset down (w / 2, ..., 1)."""
    n = x.shape[-1]
    w = 1
    while 2 * w < n and w < 32:
        w *= 2
    lanes = []
    for l in range(w):
        v = x[..., l]
        for e in range(l + w, n, w):
            v = v + x[..., e]
        lanes.append(v)
    off = w // 2
    while off >= 1:
        lanes = [lanes[i] + lanes[i + off] if i < off else lanes[i]
                 for i in range(w)]
        off //= 2
    return lanes[0]


def accumulator_sum(x):
    """PyTorch's CUDA sum over a dimension that is not the fastest (the NL
    build's price, whose neighbours' axis has stride N), as read off the
    card: one thread per output, four accumulators, term 4g + i into
    accumulator i while whole groups of four remain, the rest into
    accumulators 0, 1, ..., then ((a0 + a1) + a2) + a3."""
    n = x.shape[-1]
    acc = [torch.zeros(x.shape[:-1], device=x.device) for _ in range(4)]
    j = 0
    while j + 3 < n:
        for i in range(4):
            acc[i] = acc[i] + x[..., j + i]
        j += 4
    for i, e in enumerate(range(j, n)):
        acc[i] = acc[i] + x[..., e]
    return ((acc[0] + acc[1]) + acc[2]) + acc[3]


def read_sum(counts, batches, gen, dev):
    """Per count of terms and batch: the sums each model misses, over a
    contiguous last dimension (``torch_tree``) and over the NL build's
    layout, the summed axis of stride N (``accumulators``)."""
    out = {}
    for n in counts:
        for batch in batches:
            a = torch.randn((batch, n), device=dev, generator=gen)
            b = torch.randn((batch, n), device=dev, generator=gen)
            x = a * b
            y = torch.sum(x, dim=-1)
            seq = torch.zeros(batch, device=dev)
            for j in range(n):
                seq = seq + x[:, j]
            # the build's product: (P, N, nb) with the nb axis of stride N
            N = 20
            lam = torch.rand((batch // N + 1, n, N), device=dev,
                             generator=gen).transpose(1, 2)
            g = torch.randn((batch // N + 1, N, n, 2), device=dev,
                            generator=gen)
            xb = lam * g[..., 0]
            yb = torch.sum(xb, dim=-1)
            seqb = torch.zeros_like(yb)
            for j in range(n):
                seqb = seqb + xb[..., j]
            miss = {"sequential": int((seq != y).sum()),
                    "torch_tree": int((torch_tree_sum(x) != y).sum()),
                    "build_layout_sequential": int((seqb != yb).sum()),
                    "build_layout_accumulators": int(
                        (accumulator_sum(xb) != yb).sum())}
            out[f"n={n} batch={batch}"] = miss
            print(f"sum n={n} batch={batch}: misses {miss}", flush=True)
    return out


# --- batched matrix-vector products of the SQP builds ------------------------

MATVEC_SHAPES = ((9, 9), (3, 9), (9, 2), (3, 2))


def _mv_chain(A, x, idx):
    acc = torch.zeros(A.shape[:-1], device=A.device)
    for l in idx:
        acc = fma(A[..., l], x[..., None, l], acc)
    return acc


def matvec_candidates(k: int) -> dict:
    """The candidate orders of an n-term row of ``A @ x``: name -> f(A, x)
    (the module's docstring)."""
    h = (k + 1) // 2

    def quarters(A, x):
        q = [_mv_chain(A, x, range(4 * c, min(k, 4 * c + 4)))
             for c in range(4)]
        return (q[0] + q[2]) + (q[1] + q[3])

    def products(A, x):
        acc = A[..., 0] * x[..., None, 0]
        for l in range(1, k):
            acc = acc + A[..., l] * x[..., None, l]
        return acc
    return {
        "halves": lambda A, x: _mv_chain(A, x, range(h)) + _mv_chain(
            A, x, range(h, k)),
        "even_odd": lambda A, x: _mv_chain(A, x, range(0, k, 2)) + _mv_chain(
            A, x, range(1, k, 2)),
        "quarters": quarters,
        "sequential": lambda A, x: _mv_chain(A, x, range(k)),
        "products": products,
    }


def matvec_order_of(layout: str, m: int, k: int, batch: int, gen, dev,
                    rows: int = 6_000):
    """The candidates whose results equal the library's for a batch of
    ``batch`` products of an m x k matrix (``row``- or ``col``-major) by a
    k-vector, as the plain builds write them, over at least ``rows``
    rows."""
    miss = None
    cs = matvec_candidates(k)
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
    return tuple(sorted(c for c, n in miss.items() if n == 0))


def read_matvec(batches, gen, dev):
    """Per layout and shape: the orders each batch size matches, and for
    the 9-term rows every batch size at which the order changes, bisected
    between two neighbours of ``batches``."""
    out = {"orders": {}, "switches": {}}
    for layout in ("row", "col"):
        for m, k in MATVEC_SHAPES:
            tag = f"{layout} {m}x{k}"
            seen = {b: matvec_order_of(layout, m, k, b, gen, dev)
                    for b in batches}
            out["orders"][tag] = {b: list(o) for b, o in seen.items()}
            print(f"matvec {tag}: " + ", ".join(
                f"{b} {list(o)}" for b, o in seen.items()), flush=True)
            if k != 9:
                continue
            for lo, hi in zip(batches, batches[1:]):
                if seen[lo] == seen[hi]:
                    continue
                olo = seen[lo]
                while hi - lo > 1:
                    mid = (lo + hi) // 2
                    if matvec_order_of(layout, m, k, mid, gen, dev) == olo:
                        lo = mid
                    else:
                        hi = mid
                ohi = list(matvec_order_of(layout, m, k, hi, gen, dev))
                out["switches"].setdefault(tag, []).append(
                    [lo, list(olo), hi, ohi])
                print(f"matvec {tag}: {list(olo)} up to batch {lo}, then "
                      f"from {hi} {ohi}", flush=True)
    return out


def read_solve_batches(sizes, batches, gen, dev, nz: int = 11):
    """The solve order's misses (:func:`solve_emulate`) by size and batch,
    K's right-hand sides (nz) and Quu_inv's (n)."""
    out = {}
    for n in sizes:
        for batch in batches:
            M = torch.randn((batch, n, n), device=dev, generator=gen)
            A = M @ M.transpose(-1, -2) + n * torch.eye(n, device=dev)
            L, _ = torch.linalg.cholesky_ex(0.5 * (A + A.transpose(-1, -2)))
            B = torch.randn((batch, n, nz), device=dev, generator=gen)
            eye = torch.eye(n, device=dev).expand(batch, n, n).clone()
            rl = 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)
            k = min(batch, 64)
            row = {}
            for what, Bm in (("K", B), ("inv", eye)):
                X = torch.cholesky_solve(Bm, L)
                row[what] = int((solve_emulate(L[:k], rl[:k], Bm[:k])
                                 != X[:k]).sum())
            out[f"n={n} batch={batch}"] = row
            print(f"solve n={n} batch={batch}: misses {row}", flush=True)
    return out


def dump(path, gen, dev, keep: int = 8):
    """Inputs and results of the library routines at the shapes above, the
    first ``keep`` problems of each batch, for reading orders off the card
    elsewhere: torch.save of a dict."""
    out = {"has_magma": bool(torch.cuda.has_magma),
           "linalg": str(torch.backends.cuda.preferred_linalg_library())}
    for n in (3, 4, 5, 6, 7, 8, 9, 12, 16, 17, 31, 33, 40):
        x = torch.randn((440, n), device=dev, generator=gen)
        out[f"sum {n}"] = (x[:64].cpu(), torch.sum(x, dim=-1)[:64].cpu())
    for n in (8, 16, 17, 18, 22, 32, 33, 34, 48, 64, 66, 80, 97):
        for batch in (2, 2048, 704):
            M = torch.randn((batch, n, n), device=dev, generator=gen)
            A = M @ M.transpose(-1, -2) + n * torch.eye(n, device=dev)
            A = 0.5 * (A + A.transpose(-1, -2))
            L, _ = torch.linalg.cholesky_ex(A)
            B = torch.randn((batch, n, 11), device=dev, generator=gen)
            eye = torch.eye(n, device=dev).expand(batch, n, n)
            X = torch.cholesky_solve(B, L)
            Xi = torch.cholesky_solve(eye, L)
            out[f"chol {n} {batch}"] = tuple(
                t[:keep].cpu() for t in (A, L, B, X, Xi))
    torch.save(out, path)
    print(f"dumped to {path}: magma {out['has_magma']}, {out['linalg']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts",
                    default="sum,gemm,cholesky,solve_batches,matvec",
                    help="what to read: sum, gemm, cholesky, "
                         "solve_batches, matvec")
    ap.add_argument("--batches",
                    default="20,40,60,120,160,200,360,1000,2000,3840,"
                            "12997,12998,15360,20000,60000",
                    help="batch sizes (problems x stages) of the "
                         "matrix-vector products to read")
    ap.add_argument("--dump", default=None,
                    help="also save the routines' inputs and results to "
                         "this path (torch.save)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("library_order: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    parts = args.parts.split(",") if args.parts else []
    if args.dump:
        dump(args.dump, gen, dev)
    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if "sum" in parts:
        # up to 200 terms: eu / hp from 49 agents (48 neighbours and more),
        # eu 64 agents' 63, at the builds' batches (fleet x N outputs)
        out["sum"] = read_sum(list(range(1, 34)) + [48, 49, 63, 64, 70, 96,
                                                    99, 100, 128, 200],
                              [40, 440, 1280, 2000, 40_960], gen, dev)
    if "gemm" in parts:
        # (P, N, nc, mr): eu / LPV 10, 32 and 64 agents, hp_opt 9, 11, 16,
        # 17 and 32 agents at the batches the paths give, and the
        # boundaries 32 / 33
        # boundaries 32 / 33; the spilled epoch data's fleets: hp_opt 36
        # and 48 agents (nc 72, 96), at N=125 too, LPV 1000 agents (1003
        # rows) and hp_opt 100 agents (nc 200, mr 301)
        shapes = [(20, 20, 2, 13), (256, 20, 2, 35), (2048, 20, 2, 35),
                  (64, 20, 2, 67), (18, 20, 18, 28), (22, 20, 22, 34),
                  (32, 20, 32, 49), (34, 20, 34, 52), (64, 20, 64, 97),
                  (7, 20, 32, 32), (7, 20, 33, 33), (3, 125, 32, 49),
                  (352, 20, 22, 34), (36, 20, 72, 109), (48, 20, 96, 145),
                  (36, 125, 72, 109), (1000, 20, 2, 1003),
                  (100, 20, 200, 301)]
        out["gemm"] = read_gemm(shapes, gen, dev)
    if "solve_batches" in parts:
        out["solve_batches"] = read_solve_batches(
            [18, 20, 22, 24, 26, 28, 30, 32, 34, 40, 64, 72, 96, 98, 128,
             200], [22, 64, 256, 704, 720, 960, 1024, 2048, 4500], gen, dev)
    if "cholesky" in parts:
        # past 97 columns: hp_opt from 49 agents (nc 98 to 200)
        out["cholesky"] = read_cholesky(
            [2, 8, 18, 22, 32, 33, 34, 40, 48, 64, 66, 72, 96, 98, 128, 144,
             200], [2, 2048], gen, dev)
    if "matvec" in parts:
        out["matvec"] = read_matvec(
            sorted(int(v) for v in args.batches.split(",")), gen, dev)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
