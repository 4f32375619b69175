"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's main paths through the hand-written CUDA kernels — the
collaborative LPV fleet rollout of ``bench.py`` (Highway, 3 agents, H=20,
256 scenarios, 20 control steps, admm_iters=300), the NL-OCD Monte-Carlo of
``scripts/monte_carlo.py --pipeline nl`` (64 fleets), the MPCC race and
gain battery, the long-horizon single fleet and the dynamic-lane rollout —
and checks them. It checks and does not time the paths: their rates and
latencies are the benchmark's (``benchmark/run.py``); the kernel times of
phases 3-3d and 13 are each kernel's isolated record. The phases:

1. a CUDA device is present; prints the card's name and power limit;
2. builds the kernels from ``colaborativempc_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch twin on the card, with the time of
   each beside its bound (bytes over 3.35 TB/s or FP32 operations over 67
   TFLOP/s, whichever is larger) and the launch plan (QPs per block, ring
   depth): at the headline shape (768 QPs, N=20, nz=11, nc=2, mr=6,
   epoch_len=20), at N=125 (a ring shorter than the horizon, streamed) and
   at N=125 with the horizon pinned resident, at P=7 with 4 QPs per
   block (a ragged block), and at the large fleets' widths
   (``WIDE_SHAPES``: LPV 32 agents, 35 rows; 32 and 33 controls and rows;
   NL hp_opt 11, 16, 17 and 32 agents, up to 64 controls and 97 rows, the
   last at a ring of one stage; LPV 32 agents at N=125);
3b. the epoch kernel against its twin on the NL planner's own QPs (256
   fleets x 3 agents, N=20): eu (nc=2, mr=6) and hp_opt (nc=6, mr=10), the
   latter under its plan and with the horizon pinned resident;
3c. the epoch-data kernel (``csrc/epoch_data.cu``: the rho-augmented cost,
   its Riccati factorisation and the prox factors, ``admm_epoch_inputs`` on
   the card) against its plain version on the card, field by field, each
   within 1e-4 of the larger of 1 and the field's max |value|: on phase
   3's QPs (the headline, N=125, P=7 with unbounded rows added), phase
   3b's NL QPs and phase 13's MPCC QPs (P=18/N=20, P=1/N=60, the single
   QP compared as a batch of two), with the kernel's time, the plain
   version's, the bound, the plan and the entries whose bits differ (none
   expected: the kernel follows the order of the card's batched library
   routines that the plain version calls, and the torch and CUDA versions
   are printed beside the check); both also read against the plain
   version in float64 on the card; and at every phase-3 large-fleet
   shape and at hp_opt 16 agents at N=125 (rows past 32 with the factor
   in registers, the factor in shared memory from 9 controls). The check
   fails on any entry whose bits
   differ, and at the MPCC shapes when the kernel lies more than 1.5x as
   far from float64 as the float32 plain version does. At hp_opt 11
   agents in a batch of 14,080 stage matrices (704 fleets' QPs, N=20),
   where the card's batched solve takes another order than the kernel
   follows, the bits may differ and the 1.5x rule holds instead. Each
   shape prints the wrapper's host microseconds per call beside the
   kernel's device time. Phases 3, 3b and 13 feed the epoch kernel the
   plain version's data, as before;
3d. the SQP build kernels (``csrc/sqp_qp.cu``: ``build_nl_qp`` and
   ``build_mpcc_qp`` on the card) against their plain versions on the card,
   field by field, each within 1e-4 of the larger of 1 and the field's max
   |value|, failing on any entry whose bits differ (the kernels follow the
   plain versions' order of operations, the card's cuBLAS order for the
   matrix-vector products and torch.func's forward-mode rules), both read
   against the plain version in float64: NL eu, hp and hp_opt (192 QPs,
   N=20), eu at N=125, eu with per-problem lanes on Oval2, eu and hp_opt
   at the velocity gate's edges with a NaN, eu either side of the row
   layout's order boundaries (P=649/650, 1864/1865), hp_opt at 4, 5 and 9
   agents (3, 4 and 8 neighbours), MPCC P=1/N=60 (as a batch of two),
   P=18/N=20, at the slip floor's edges with a NaN and either side of the
   column layout's boundaries (P=9/10, 66/67, 142/143), each family
   on a fitted track of 3000 segments (more than the kernels stage in
   shared memory) and the large fleets (``LARGE_FLEET_BUILDS``: eu 4, 10
   and 32 agents, hp 10, hp_opt 11, 16, 17, 21, 22 and 32 agents, the
   last two with fewer stages per block, eu 32 and hp_opt 16 agents at
   N=125); with each kernel's time beside
   the plain version's and the bound, and the wrapper's host microseconds
   per call;
4. the LPV path: launch counts reset, one 20-step rollout, every state
   finite, the epoch kernel and the epoch-data kernel each launched once
   per ADMM epoch the solves ran;
5. end to end, kernel vs plain: the same config at B=4 for 5 steps on the
   card and on the CPU (plain twins) agree; each problem's ADMM iteration
   counts on both paths are printed where they differ;
6. the NL path: the NL-OCD Monte-Carlo (64 fleets x 3 agents, N=20,
   eu, Jacobi) for 20 control steps: launch counts reset, every state
   finite, the epoch kernel launched once per ADMM epoch its solves ran;
7. NL end to end, kernel vs plain: B=2 fleets x 3 steps on the card and
   on the CPU, for eu/Jacobi and hp_opt/Gauss-Seidel — plans within 1e-3,
   equal feasible flags and OCD iteration counts;
8. one fleet's closed loop (``run_nl_experiment``, 20 steps): finite
   states, the kernels launched once per epoch and per SQP build;
9. (removed);
10. the MPCC single race at the reference's N=60 (oval_mt, dt 0.05, the
   associative schedule with epoch 15): launch counts reset, 10 warm-in
   steps, then 80 steps: every state finite, the epoch kernel launched
   once per ADMM epoch the solves ran;
11. the MPCC gain battery: 18 races (q_contour {20, 50, 120} x q_progress
   {0.5, 1, 2} x dr_scale {0.5, 1}) at N=20 for 160 steps after 10
   warm-in steps: finite states, launches equal to the epochs; laps
   completed, feasible share;
12. MPCC kernel vs plain: B=2 races x 5 steps at N=20 on the card and on
   the CPU (plain twins): states within 1e-3 with equal reset flags, each
   race's ADMM iteration counts printed where they differ;
13. the epoch kernel vs its twin on MPCC's own QPs (the first SQP QPs of
   cold-started races, normalised): P=18/N=20/mr=7 and P=1/N=60/mr=7;
14. the associative path on the card: ``lqr_affine_solve_assoc`` against
   ``lqr_affine_solve`` at N=60 and N=125 in float32 (within 1e-3 of the
   solution's scale);
15. single-fleet LPV at N=125 with default settings (``run_lpv_experiment``,
   Highway, 3 agents, 10 steps: assoc, epoch 15, 1000 iterations): finite
   states, launches equal to the epochs;
16. dynamic lanes: the LPV fleet rollout with ``dynamic_lane`` on Oval2,
   B=64 x 10 steps (agent 1 of every other fleet starting on the inner
   lane): finite states, launches equal to the epochs, the lane switches
   seen; then B=2 x 3 steps card vs CPU within 1e-3.

Phases 17-20 drive the scripts users start, through their ``main(argv)``
on the card (default ``--device``), with the launch counters reset before
each and the solver's epochs counted (the launches of the epoch kernel and
of the epoch-data kernel must each equal the epochs):

17. ``lpv_main`` at its defaults (3 agents, N=125, dt 0.025, 1000 ADMM
   iterations) for 8 steps with ``--no-plot``: the csv/pck files written,
   finite states; ``eval_lpv_model`` on that run, its
   Euler rollout on the card against the same rollout on the CPU within
   1e-4, and the other open-loop tools on that run card vs CPU
   (``rollout_rk4``, ``regression``, ``gbellmf``,
   ``plane_signed_distance``); ``compare_reference`` against a mock golden
   run made from it; a tiny run (2 agents, N=8, 4 steps) of ``lpv_main`` on the card and on the
   CPU writing states within 1e-3;
18. ``stress_study`` at full width: ``latency --family nl-eu --n 125`` (the
   NL-OCD step at N=125) and ``perturbed --batched --family lpv --n 125``
   (8 starts x 5 steps, one chunk);
19. ``experiment_battery --pipeline nl --horizons 20,40`` (12 fleets, 5
   steps per horizon) and ``--pipeline lpv`` (18 fleets, 10 steps);
20. ``stress_study gs-tradeoff`` (N=20, 16 fleets, 8 steps): Jacobi against
   Gauss-Seidel, mean OCD iterations and fleet-steps/s.

Phase 21 drives the sharded paths (``parallel/``):

21. (a) over NCCL at world size 1, on a (1, 1) mesh: phase 4's LPV
   rollout through ``make_sharded_lpv_rollout`` and phase 6's NL-OCD
   Monte-Carlo through ``monte_carlo.setup(mesh=...)``, i.e.
   ``make_sharded_nl_ocd_rollout``, from the same starts: launches equal
   to the epochs, final states against phases 4 and 6 (bit for bit
   expected; held to 1e-3); (b) real
   collectives on the one card: ranks that share it over gloo, each a
   process of its own with a deadline, the LPV headline split (2, 1) for
   3 steps and 16 NL hp_opt fleets split (1, 3), one agent per rank, for
   2 steps, each gathered result within 1e-3 of the single-process
   rollout from the same start, launches equal to each rank's epochs.

Phase 22 drives fleets past the kernels' earlier limits:

22. large fleets (``LARGE_FLEETS``): LPV 32 agents on the Highway, B=8,
   N=20, 5 steps; NL-OCD eu 10 agents, B=2, N=20, 3 steps, Jacobi; NL-OCD
   hp_opt 11 agents, B=2, N=20, 3 steps: each on the card (launch counts
   reset, each kernel once per ADMM epoch and the NL build once per SQP
   build) and on the CPU's plain twins from the same start, finite, the
   plans within 1e-3; LPV 32 agents, whose loop carries float32 rounding
   past that (solves an epoch apart), within 1e-3 or else no farther from
   the CPU's float64 loop than 1.5x the CPU's float32 loop, in the mean
   over the scenarios of each one's max |dx| (``scripts/fleet_f64.py``
   reads that ratio over seeds); the feasible
   share and min_dist_exec printed.

23. ``scripts/bench_suite.py`` through its ``main``: the default rows and
   ``--tiny``, every row feasible.

Phase 24 holds the card's solutions against the repository's float64 C++
twin of the engine (``colaborativempc_tpu_torch/native``, built from
``native/src`` with the host's C++ compiler), an implementation that
shares no code with the port. Each solve runs through the port's entry
points on the card with the launch counters reset and the solver's epochs
counted (each kernel of the path launched once per epoch or SQP build, and
at least once), and the card's max |dx_pred| and |du_pred| from the twin
are printed:

24. (a) ``lpv_solve`` against ``lpv_solve_native``: tests/test_native.py's
   oval 1 agent N=15 (x and u within 3e-3) and Highway 3 agents N=12 (x
   within 5e-3); the headline QP (Highway, agent 0 of 3, N=20, 600
   iterations, eps 1e-6), the same at N=125 and agent 0 of 197 at N=125
   (196 neighbours, the epoch launch spilled past shared memory), each
   also solved on the CPU's plain path and held to the larger of 3e-3 and
   1.5x the CPU's distance (``TOL_ORACLE_FLOOR``, ``TOL_ORACLE_CPU``);
   the ADMM iterations of the card, the CPU and the twin printed;
   (b) ``nl_solve`` (eu) against ``nl_solve_native``: the test's shape
   within 1e-2 and the NL-OCD headline's N=20 QP under (a)'s rule; (c)
   ``mpcc_solve`` against ``mpcc_solve_native`` within 5e-3, and
   ``run_mpcc_experiment`` against ``mpcc_race_native`` (50 steps: the
   same steps, every step feasible, progress within 2%); (d)
   ``_sep_filter_beta`` on the card against ``sep_filter_native`` on 100
   random fleets within 2e-3.

Kernel times come from ``cuda_ms``: CUDA events around the calls, with a
spin kernel queued first so that the host's queueing stays outside the
window.

Wherever a phase holds the epoch kernel's launches to the epochs the
solves ran, it holds the epoch-data kernel's launches to them too, and
on the NL and MPCC paths (phases 6-8, 10-12, 18-21) each build kernel's
launches to the SQP builds the solves ran (one per NL or MPCC solve; none
of the other family's, and none on the CPU runs of phases 7 and 12).

The seconds of every phase are printed. No phase imports matplotlib.

Prints a JSON line with each kernel's record, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, on
any failure or when no CUDA device is available.

Usage: ``python3 chip_smoke.py`` from the repository root.
"""

import concurrent.futures
import functools
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HEADLINE = dict(P=768, N=20, nz=11, nc=2, mr=6)
EPOCH_LEN = 20
ALPHA = 1.6
TOL_AFFINE = 5e-5          # tests/test_ops.py:348
TOL_EPOCH = 1e-3           # tests/test_ops.py:401-404 (z, c, w, y)
TOL_RESID = 1e-4           # tests/test_ops.py:405-408 (r_prim, r_dual)
TOL_ROLLOUT = 1e-3         # tests/test_ops.py:506 (x_pred)
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s, FP32 FLOP/s off the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def random_epoch_problems(rng, P, N, nz, nc, mr):
    """P random stage QPs with bounds banded around a feasible rollout:
    row 0 soft on both sides, row 1 one-sided (hi = +inf), the rest hard —
    the row kinds of the LPV planner. Float64 numpy."""
    F = np.eye(nz) + 0.05 * rng.normal(size=(P, N, nz, nz))
    G = 0.2 * rng.normal(size=(P, N, nz, nc))
    d = 0.01 * rng.normal(size=(P, N, nz))
    A = rng.normal(size=(P, N + 1, nz, nz))
    Q = 0.1 * A @ np.swapaxes(A, -1, -2) + np.eye(nz)
    Rm = rng.normal(size=(P, N, nc, nc))
    R = 0.1 * Rm @ np.swapaxes(Rm, -1, -2) + np.eye(nc)
    S = 0.05 * rng.normal(size=(P, N, nz, nc))
    q = 0.5 * rng.normal(size=(P, N + 1, nz))
    r = 0.5 * rng.normal(size=(P, N, nc))
    z0 = rng.normal(size=(P, nz))
    D = 0.5 * rng.normal(size=(P, N, mr, nz))
    E = 0.5 * rng.normal(size=(P, N, mr, nc))
    ct = 0.3 * rng.normal(size=(P, N, nc))
    zs = [z0]
    for k in range(N):
        zs.append(np.einsum("pij,pj->pi", F[:, k], zs[-1])
                  + np.einsum("pij,pj->pi", G[:, k], ct[:, k]) + d[:, k])
    zs = np.stack(zs, 1)
    vt = (np.einsum("pkmi,pki->pkm", D, zs[:, :-1])
          + np.einsum("pkmi,pki->pkm", E, ct))
    lo = vt - rng.uniform(0.05, 0.5, size=vt.shape)
    hi = vt + rng.uniform(0.05, 0.5, size=vt.shape)
    hi[:, :, 1] = np.inf
    soft = np.full(vt.shape, np.inf)
    soft[:, :, 0] = 50.0
    w0 = np.clip(0.1 * rng.normal(size=vt.shape), lo, hi)
    y0 = 0.05 * rng.normal(size=vt.shape)
    rho_scale = rng.uniform(0.5, 2.0, size=(P, mr))
    return dict(F=F, G=G, d=d, Q=Q, R=R, S=S, q=q, r=r, z0=z0, D=D, E=E,
                lo=lo, hi=hi, soft=soft, w0=w0, y0=y0, rho_scale=rho_scale)


# clock cycles per second of torch.cuda._sleep's spin, at or above the
# card's highest SM clock (1.98 GHz on the H100 SXM), so a spin of n cycles
# lasts at least n / SPIN_CYCLES_PER_S seconds
SPIN_CYCLES_PER_S = 2.0e9
SPIN_MAX_S = 0.5


def cuda_ms(fn, reps):
    """Mean device milliseconds per call over ``reps`` calls after one
    warm-up, timed with CUDA events. A spin kernel (``torch.cuda._sleep``)
    queued ahead of the calls keeps the card busy while the host queues
    them, so the window between the events holds the device's work and not
    the host's. The spin lasts twice the host's time to queue one call
    times ``reps`` (at least 5 ms, at most SPIN_MAX_S). A call that queues
    more launches than the card's queue holds (a plain twin's chain of
    small ops) waits on the device while it queues, so its reading stays
    the time of the chain with its host work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = min(SPIN_MAX_S, max(0.005, 2.0 * host * reps))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def kernel_bound(P, N, nz, nc, mr, epoch_len):
    """The least time (ms) the card could take for one launch, and what
    sets it: every input read once and every output written once (float32,
    Qxu included: it is an input of the function) over the HBM rate, or
    the FP32 operations of the explicit sweeps over the FP32 rate.
    ``mr = 0`` is the affine solve (one pass, no rows). Per stage and
    iteration: F' tt and F z (4 nz^2), G' tt, Qxu kff, K z and G c
    (8 nz nc), Quu_inv Qu (2 nc^2), the rows' D' t, E' t, D z and E c
    (4 mr (nz + nc)), t, relaxation, prox, dual update and residuals
    (12 mr), vector adds (4 nz): ~1,100 at nz=11, nc=2, mr=6."""
    fixed = (nz * nz + 3 * nz * nc + nc * nc + 2 * nz + nc
             + mr * (nz + nc + 5))
    inputs = N * fixed + (N + 1) * nz + nz + 2 * N * mr
    outputs = (N + 1) * nz + N * nc + 2 * N * mr + 2 * mr
    nbytes = 4.0 * P * (inputs + outputs)
    per_stage = (4 * nz * nz + 8 * nz * nc + 2 * nc * nc
                 + 4 * mr * (nz + nc) + 12 * mr + 4 * nz)
    flops = float(P) * N * max(epoch_len, 1) * per_stage
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# phase 3's large-fleet shapes, (tag, P, N, nc, mr): LPV 32 agents (35
# rows), either side of 32 controls and rows, NL hp_opt 11, 16, 17 and 32
# agents (nc = 22, 32, 34, 64; mr = 34, 49, 52, 97), and LPV 32 agents at
# N=125; phase 3c holds the epoch-data kernel at each, and at hp_opt 16
# agents at N=125 (``WIDE_DATA_SHAPES``: there the float32 twin's own
# residuals lie 1.5e-4 from float64, above phase 3's TOL_RESID, so the
# epoch kernel is held there by tests/test_torch_cuda.py against float64)
# and at hp_opt 11 agents in 704 fleets (``LIBRARY_ORDER_UNFOLLOWED``)
WIDE_SHAPES = (
    ("lpv_32_agents", 256, 20, 2, 35),
    ("nc32_mr32", 7, 20, 32, 32),
    ("nc33_mr33", 7, 20, 33, 33),
    ("hp_opt_11_agents", 22, 20, 22, 34),
    ("hp_opt_16_agents", 32, 20, 32, 49),
    ("hp_opt_17_agents", 34, 20, 34, 52),
    ("hp_opt_32_agents", 64, 20, 64, 97),
    ("lpv_32_agents_n125", 24, 125, 2, 35),
)
WIDE_DATA_SHAPES = (("hp_opt_16_agents_n125", 32, 125, 32, 49),
                    ("hp_opt_11_agents_p704", 704, 20, 22, 34))
# phase 3c shapes whose batch (P x N stage matrices past 1,024 at 22-28
# controls) takes the card's batched solve into an order the kernel does
# not follow: held to float64 (TOL_EPOCH_DATA_F64) in place of the bits
LIBRARY_ORDER_UNFOLLOWED = ("hp_opt_11_agents_p704",
                            "spill_hp_opt_100_agents")
# phase 3's shapes past one block's shared memory, (tag, P, N, nc, mr), P
# the agents of one fleet: NL hp_opt 31 and 36 agents at N=125 (the epoch
# kernel's w, y and kff spilled to global memory), 48 agents at N=20 (the
# ring too), LPV 200 agents at N=125 and 760 at N=20; the affine kernel at
# each with mr = 0. Phase 3c holds the epoch data (its block's layout
# spilled) at ``SPILL_DATA_SHAPES``.
SPILL_SHAPES = (
    ("hp_opt_31_agents_n125", 31, 125, 62, 94),
    ("hp_opt_36_agents_n125", 36, 125, 72, 109),
    ("hp_opt_48_agents", 48, 20, 96, 145),
    ("lpv_200_agents_n125", 200, 125, 2, 203),
    ("lpv_760_agents", 760, 20, 2, 763),
)
SPILL_DATA_SHAPES = (
    ("hp_opt_36_agents", 36, 20, 72, 109),
    ("hp_opt_48_agents", 48, 20, 96, 145),
    ("hp_opt_36_agents_n125", 36, 125, 72, 109),
    ("lpv_1000_agents", 1000, 20, 2, 1003),
    # 200 controls: past the widths whose library order the kernel follows
    # (cuBLAS's Qxu K over 200 terms, MAGMA's K solves at 128-200 in small
    # batches take other orders), held to float64
    ("hp_opt_100_agents", 100, 20, 200, 301),
)
# where the epoch kernel's residuals lie farther than TOL_RESID from its
# float32 twin's (long horizons, many rows or controls), they are held
# against the twin in float64: in the mean over the QPs of each QP's max
# |error| (a max over the batch is set by one QP), at most this times the
# larger of the float32 twin's distance and TOL_RESID. The kernel's
# sequential sums over up to nz + nc terms lie up to 2.1x as far from
# float64 as the twin's library products in that measure already at
# shapes that fit shared memory (LPV 744 agents at N=20, 1.5x at LPV 196
# and N=125: scripts/epoch_f64.py) and 1.8x at NL hp_opt 36 agents and
# N=125 (phase 3); the spill keeps their bits. So the bound is 2 over the
# tolerance's floor, not the 1.5 that holds the epoch data and the builds
TOL_RESID_F64 = 2.0


def resid_mean_err(res, res64):
    """Per residual (r_prim, r_dual), the mean over the QPs of each QP's
    max |error| from the float64 values."""
    return [float((x.double() - r).abs().amax(dim=1).mean())
            for x, r in zip(res, res64)]


def spill_levels_alike(dev, data, z0, w0, y0, kw, aff_args, P, N, nz, nc,
                       mr):
    """The epoch and the affine kernel under every spill level that fits
    (``cuda_lqr.kernel_plan(spill=...)`` at the chosen plan's ring): each
    level's outputs bit for bit the first fitting level's (the spill keeps
    the arithmetic and its order). Returns the entries differing per
    kernel and level; fails on any."""
    from colaborativempc_tpu_torch.ops import cuda_lqr
    out = {}
    for kind, m in (("epoch", mr), ("affine", 0)):
        ring = cuda_lqr.kernel_plan(P, N, nz, nc, m).ring
        outs = {}
        for level in range(len(cuda_lqr.SPILLS)):
            try:
                plan = cuda_lqr.kernel_plan(P, N, nz, nc, m, ring=ring,
                                            spill=level)
            except ValueError:
                continue
            outs[level] = (
                cuda_lqr.admm_epoch_batched(data, z0, w0, y0, plan=plan,
                                            **kw) if m else
                cuda_lqr.lqr_affine_solve_batched(*aff_args, plan=plan))
        torch.cuda.synchronize()
        first = outs[min(outs)]
        out[kind] = {level: sum(int((a != b).sum()) - int(
            (a.isnan() & b.isnan()).sum()) for a, b in zip(o, first))
                     for level, o in outs.items()}
        if any(out[kind].values()):
            fail(f"phase 3 P={P} N={N} nc={nc} mr={m}: the {kind} kernel's "
                 f"spill levels differ in their bits: {out[kind]}")
    return out


def random_qp(dev, P, N, nc, mr, seed):
    """``random_epoch_problems`` on ``dev`` in float32: the StageQP, its
    per-problem rho_scale and the starts z0, w0, y0."""
    from colaborativempc_tpu_torch.ops import LQRCost, LQRDynamics, StageQP
    pr = random_epoch_problems(np.random.default_rng(seed), P=P, N=N,
                               nz=HEADLINE["nz"], nc=nc, mr=mr)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    soft = t(pr["soft"])
    qp = StageQP(
        dyn=LQRDynamics(t(pr["F"]), t(pr["G"]), t(pr["d"])),
        cost=LQRCost(t(pr["Q"]), t(pr["q"]), t(pr["R"]), t(pr["r"]),
                     t(pr["S"])),
        D=t(pr["D"]), E=t(pr["E"]), lo=t(pr["lo"]), hi=t(pr["hi"]),
        soft_lo=soft, soft_hi=soft)
    return qp, t(pr["rho_scale"]), t(pr["z0"]), t(pr["w0"]), t(pr["y0"])


def check_kernels(dev, N, reps, P=HEADLINE["P"], nc=HEADLINE["nc"],
                  mr=HEADLINE["mr"], plain_reps=(2, 1), inputs=None,
                  f64_rule=False, **pin):
    """Phase 3 at one shape: both kernels vs their plain twins, under the
    launch plan ``kernel_plan`` chooses, or with ``pin`` (ring,
    qps_per_block) pinned. The epoch's residuals within TOL_RESID of the
    twin's or, with ``f64_rule`` (the shapes past shared memory), else
    held against the twin in float64 (then run on the card) by
    TOL_RESID_F64. ``plain_reps``: the timed calls of the affine and the
    epoch twin. ``inputs``: ``(qp, rho_scale,
    z0, w0, y0)`` in place of random QPs."""
    from colaborativempc_tpu_torch.ops import cuda_lqr
    from colaborativempc_tpu_torch.ops.admm import admm_epoch_inputs_plain
    shape = dict(HEADLINE, N=N, P=P, nc=nc, mr=mr)
    wide = (nc, mr) != (HEADLINE["nc"], HEADLINE["mr"])
    qp, rho_scale, z0, w0, y0 = inputs or random_qp(
        dev, P, N, nc, mr, 1000 + N + (P if P != HEADLINE["P"] else 0)
        + (nc * 100 + mr if wide else 0))
    # the epoch kernel's inputs from the plain version, as in earlier runs
    data = admm_epoch_inputs_plain(qp, rho=10.0, rho_scale=rho_scale)
    if not all(bool(torch.isfinite(x).all()) for x in data[:9]):
        fail(f"non-finite epoch data at N={N}")
    out = {}

    nz, nc, mr = shape["nz"], shape["nc"], shape["mr"]
    aff_plan = cuda_lqr.kernel_plan(P, N, nz, nc, 0, **pin)
    ep_plan = cuda_lqr.kernel_plan(P, N, nz, nc, mr, **pin)
    aff_args = (data.F, data.G, data.d, data.K, data.Quu_inv, data.Qxu,
                data.m, data.q, data.r, z0)
    got = cuda_lqr.lqr_affine_solve_batched(*aff_args, plan=aff_plan)
    torch.cuda.synchronize()
    ref = cuda_lqr.lqr_affine_solve_batched_plain(*aff_args)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    if not err <= TOL_AFFINE:
        fail(f"affine kernel vs plain at N={N}: max |err| {err} > "
             f"{TOL_AFFINE}")
    out["affine"] = dict(
        max_abs_err=err, plan=aff_plan._asdict(),
        ms=cuda_ms(lambda: cuda_lqr.lqr_affine_solve_batched(
            *aff_args, plan=aff_plan), reps),
        plain_ms=cuda_ms(
            lambda: cuda_lqr.lqr_affine_solve_batched_plain(*aff_args),
            plain_reps[0]))

    kw = dict(epoch_len=EPOCH_LEN, alpha=ALPHA)
    got = cuda_lqr.admm_epoch_batched(data, z0, w0, y0, plan=ep_plan, **kw)
    torch.cuda.synchronize()
    if f64_rule:
        out["levels_differing"] = spill_levels_alike(
            dev, data, z0, w0, y0, kw, aff_args, P, N, nz, nc, mr)
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0, **kw)
    torch.cuda.synchronize()
    err_zcwy = max_err(got[:4], ref[:4])
    err_res = max_err(got[4:], ref[4:])
    if not all(bool(torch.isfinite(x).all()) for x in got):
        fail(f"epoch kernel output not finite at N={N}")
    resid_f64 = None
    if err_res > TOL_RESID and f64_rule:
        ref64 = cuda_lqr.admm_epoch_batched_plain(
            type(data)(*(t.double() for t in data)), z0.double(),
            w0.double(), y0.double(), **kw)
        resid_f64 = {name: max(resid_mean_err(x, ref64[4:])) for name, x in
                     (("kernel", got[4:]), ("plain", ref[4:]))}
    if not (err_zcwy <= TOL_EPOCH and (err_res <= TOL_RESID or (
            resid_f64 and resid_f64["kernel"] <= TOL_RESID_F64 * max(
                resid_f64["plain"], TOL_RESID)))):
        fail(f"epoch kernel vs plain at P={P} N={N} nc={nc} mr={mr}: "
             f"z/c/w/y err {err_zcwy} (tol {TOL_EPOCH}), rp/rd err {err_res} "
             f"(tol {TOL_RESID}; against the twin in float64 {resid_f64})")
    out["epoch"] = dict(
        max_abs_err=err_zcwy, max_abs_err_resid=err_res,
        resid_vs_f64=resid_f64, plan=ep_plan._asdict(),
        ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched(
            data, z0, w0, y0, plan=ep_plan, **kw), reps),
        plain_ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched_plain(
            data, z0, w0, y0, **kw), plain_reps[1]))
    for name, m, el in (("affine", 0, 0), ("epoch", mr, EPOCH_LEN)):
        o = out[name]
        o["bound_ms"], o["bound_by"] = kernel_bound(P, N, nz, nc, m, el)
        o["roofline_share"] = o["bound_ms"] / o["ms"]
    print(f"phase 3 P={P} N={N} nc={nc} mr={mr}: affine kernel "
          f"{out['affine']['ms']:.4f} ms "
          f"(bound {out['affine']['bound_ms']:.3g}, plan "
          f"{out['affine']['plan']}) vs plain "
          f"{out['affine']['plain_ms']:.4f} ms (err {err:.3g}); epoch "
          f"kernel {out['epoch']['ms']:.4f} ms (bound "
          f"{out['epoch']['bound_ms']:.3g}, plan {out['epoch']['plan']}) vs "
          f"plain {out['epoch']['plain_ms']:.4f} ms (err {err_zcwy:.3g}, "
          f"resid err {err_res:.3g}"
          + (f"; against float64 the kernel {resid_f64['kernel']:.3g}, the "
             f"float32 twin {resid_f64['plain']:.3g}" if resid_f64 else "")
          + ")" + (f"; spill levels alike, entries differing "
                   f"{out['levels_differing']}" if f64_rule else ""),
          flush=True)
    out["qp"] = (qp, rho_scale)
    return out


TOL_EPOCH_DATA = 1e-4     # of max(1, the field's max |value|), float32
# at the MPCC shapes, the kernel's share of scale from the float64 plain
# version, at most this times the float32 plain version's own
TOL_EPOCH_DATA_F64 = 1.5


def epoch_data_bound(P, N, nz, nc, mr):
    """The least time (ms) the card could take for one epoch-data launch,
    and what sets it: ``cuda_lqr.epoch_data_traffic``'s bytes (every input
    read once, every output written once) over the HBM rate, or its FP32
    operations over the FP32 rate."""
    from colaborativempc_tpu_torch.ops import cuda_lqr
    nbytes, flops = cuda_lqr.epoch_data_traffic(P, N, nz, nc, mr)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def map_qp(qp, fn):
    """A StageQP with ``fn`` applied to every tensor (None stays None)."""
    return type(qp)(*(type(x)(*map(fn, x)) if isinstance(x, tuple) else
                      None if x is None else fn(x) for x in qp))


def check_epoch_data(dev, tag, qp, rho_scale, reps):
    """Phase 3c at one shape: ``admm_epoch_inputs`` on the card (one launch
    of the epoch-data kernel) against its plain version on the same CUDA
    tensors, field by field: NaN nowhere, each field within TOL_EPOCH_DATA
    of max(1, its max |value|). A single QP is compared as a batch of two
    (the QP twice, the first kept): the card's libraries take other
    routines for one matrix than for a batch, and the kernel's arithmetic
    per QP does not depend on the batch. Both are also read against the
    plain version in float64 on the card, as a share of each field's scale:
    where the kernel's share is no larger than the float32 plain version's,
    a failure of the check reads as the libraries' order of operations
    having changed (a new torch or CUDA build), not as a kernel fault.
    The kernel must also give 0 entries whose bits differ from the float32
    plain version, and at the MPCC shapes its share of scale from float64
    may be at most TOL_EPOCH_DATA_F64 times the float32 plain version's;
    at the shapes of LIBRARY_ORDER_UNFOLLOWED the latter holds in place of
    the former.
    Times both at the QP's own batch (the plain version is the path the
    card ran before the kernel), and the wrapper's host microseconds per
    call (host clock over calls queued without a synchronise)."""
    from colaborativempc_tpu_torch.ops import ADMMEpochData, cuda_lqr
    from colaborativempc_tpu_torch.ops.admm import (
        admm_epoch_inputs, admm_epoch_inputs_plain,
    )
    P, N, mr = qp.lo.shape
    nz, nc = qp.dyn.F.shape[-1], qp.dyn.G.shape[-1]
    rs = torch.broadcast_to(torch.as_tensor(
        rho_scale, dtype=torch.float32, device=dev), (P, mr))
    cqp, crs = (map_qp(qp, lambda t: torch.cat([t, t])), torch.cat([rs, rs])) \
        if P == 1 else (qp, rs)
    before = cuda_lqr.epoch_data_batched.launches
    got = admm_epoch_inputs(cqp, 10.0, crs)
    torch.cuda.synchronize()
    if cuda_lqr.epoch_data_batched.launches != before + 1:
        fail(f"phase 3c {tag}: admm_epoch_inputs did not launch the "
             "epoch-data kernel once")
    ref = admm_epoch_inputs_plain(cqp, 10.0, crs)
    ref64 = admm_epoch_inputs_plain(map_qp(qp, torch.Tensor.double), 10.0,
                                    rs.double())
    torch.cuda.synchronize()
    got, ref = (ADMMEpochData(*(t[:P] for t in x)) for x in (got, ref))
    rel, err, differing = 0.0, 0.0, 0
    rel64 = {"kernel": 0.0, "plain": 0.0}
    for f, g, r, r64 in zip(ADMMEpochData._fields, got, ref, ref64):
        differing += int((g != r).sum()) - int((g.isnan() & r.isnan()).sum())
        if not (bool(torch.isfinite(g).all()) or f in ("lo", "hi")):
            fail(f"phase 3c {tag}: field {f} of the kernel not finite")
        fin = torch.isfinite(r)
        if not torch.equal(fin, torch.isfinite(g)):
            fail(f"phase 3c {tag}: field {f}: finite entries differ")
        if not bool(fin.any()):
            continue
        e = float((g[fin] - r[fin]).abs().max())
        scale = max(1.0, float(r[fin].abs().max()))
        s64 = max(1.0, float(r64[fin].abs().max()))
        for name, x in (("kernel", g), ("plain", r)):
            rel64[name] = max(rel64[name], float(
                (x[fin].double() - r64[fin]).abs().max()) / s64)
        if not e <= TOL_EPOCH_DATA * scale:
            fail(f"phase 3c {tag}: field {f} max |err| {e} against "
                 f"{TOL_EPOCH_DATA} x {scale}; against float64 (share of "
                 f"scale) the kernel {rel64['kernel']:.3g}, the float32 "
                 f"plain version {rel64['plain']:.3g} (torch "
                 f"{torch.__version__}, CUDA {torch.version.cuda})")
        err, rel = max(err, e), max(rel, e / scale)
    unfollowed = tag in LIBRARY_ORDER_UNFOLLOWED
    if differing and not unfollowed:
        fail(f"phase 3c {tag}: {differing} entries differ in their bits from "
             f"the float32 plain version (torch {torch.__version__}, CUDA "
             f"{torch.version.cuda})")
    if (tag.startswith("mpcc") or unfollowed) and not (
            rel64["kernel"] <= TOL_EPOCH_DATA_F64 * rel64["plain"]):
        fail(f"phase 3c {tag}: the kernel's share of scale from float64 "
             f"{rel64['kernel']:.3g} exceeds {TOL_EPOCH_DATA_F64} x the "
             f"float32 plain version's {rel64['plain']:.3g}")
    admm_epoch_inputs(qp, 10.0, rs)
    torch.cuda.synchronize()
    calls = 50
    t0 = time.perf_counter()
    for _ in range(calls):
        admm_epoch_inputs(qp, 10.0, rs)
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    plan = cuda_lqr.epoch_data_plan(
        P, N, nz, nc, mr,
        sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    out = dict(P=P, N=N, nz=nz, nc=nc, mr=mr, max_abs_err=err,
               max_rel_err=rel, entries_differing=differing,
               compared_as_batch=cqp.lo.shape[0],
               max_rel_err_vs_f64=rel64["kernel"],
               plain_max_rel_err_vs_f64=rel64["plain"],
               plan=plan._asdict(), host_us=host_us,
               ms=cuda_ms(lambda: admm_epoch_inputs(qp, 10.0, rs), reps),
               plain_ms=cuda_ms(lambda: admm_epoch_inputs_plain(
                   qp, 10.0, rs), 2))
    out["bound_ms"], out["bound_by"] = epoch_data_bound(P, N, nz, nc, mr)
    out["roofline_share"] = out["bound_ms"] / out["ms"]
    print(f"phase 3c {tag} P={P} N={N} nc={nc} mr={mr}: epoch-data kernel "
          f"{out['ms']:.4f} ms (bound {out['bound_ms']:.3g} by "
          f"{out['bound_by']}, share {out['roofline_share']:.3f}, plan "
          f"{out['plan']}; wrapper {host_us:.1f} us of host per call) vs "
          f"plain {out['plain_ms']:.3f} ms (max |err| "
          f"{err:.3g}, {rel:.3g} of scale, tol {TOL_EPOCH_DATA}; "
          f"{differing} entries differ in their bits; compared at batch "
          f"{cqp.lo.shape[0]}; vs float64 {rel64['kernel']:.3g} of scale, "
          f"the float32 plain version {rel64['plain']:.3g})", flush=True)
    return out


TOL_SQP_QP = 1e-4         # of max(1, the field's max |value|), float32


def sqp_qp_bound(nbytes, flops):
    """The least time (ms) the card could take for one build, and what sets
    it: ``cuda_sqp``'s bytes over the HBM rate or its FP32 operations over
    the FP32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qp_fields(qp):
    """A StageQP's fields by name."""
    return {"F": qp.dyn.F, "G": qp.dyn.G, "d": qp.dyn.d, "Q": qp.cost.Q,
            "q": qp.cost.q, "R": qp.cost.R, "r": qp.cost.r, "S": qp.cost.S,
            "D": qp.D, "E": qp.E, "lo": qp.lo, "hi": qp.hi,
            "soft_lo": qp.soft_lo, "soft_hi": qp.soft_hi}


def compare_qp(what, got, ref, ref64, keep):
    """Field by field, the first ``keep`` problems: the finite entries
    alike, each field within TOL_SQP_QP of max(1, its max |value|), the
    entries whose bits differ (both NaN counts as alike), and the kernel's
    and the float32 plain version's distance from the float64 plain
    version as a share of each field's scale."""
    err = rel = 0.0
    differing = 0
    rel64 = {"kernel": 0.0, "plain": 0.0}
    worst = {}
    for f, g in qp_fields(got).items():
        g, r = g[:keep], qp_fields(ref)[f][:keep]
        r64 = qp_fields(ref64)[f][:keep]
        diff = (g != r) & ~(g.isnan() & r.isnan())
        differing += int(diff.sum())
        fin = torch.isfinite(r)
        if not torch.equal(fin, torch.isfinite(g)):
            fail(f"{what}: field {f}: finite entries differ")
        if not bool(fin.any()):
            continue
        e = float((g[fin] - r[fin]).abs().max())
        scale = max(1.0, float(r[fin].abs().max()))
        fin64 = fin & torch.isfinite(r64)
        if bool(fin64.any()):
            s64 = max(1.0, float(r64[fin64].abs().max()))
            for name, x in (("kernel", g), ("plain", r)):
                rel64[name] = max(rel64[name], float(
                    (x[fin64].double() - r64[fin64]).abs().max()) / s64)
        if not e <= TOL_SQP_QP * scale:
            fail(f"{what}: field {f} max |err| {e} against {TOL_SQP_QP} x "
                 f"{scale}; against float64 (share of scale) the kernel "
                 f"{rel64['kernel']:.3g}, the float32 plain version "
                 f"{rel64['plain']:.3g}")
        if int(diff.sum()):
            worst[f] = int(diff.sum())
        err, rel = max(err, e), max(rel, e / scale)
    return dict(max_abs_err=err, max_rel_err=rel, entries_differing=differing,
                differing_by_field=worst, max_rel_err_vs_f64=rel64["kernel"],
                plain_max_rel_err_vs_f64=rel64["plain"])


def check_sqp_build(dev, tag, family, args, reps, batch_of_two=False):
    """Phase 3d at one shape: the NL or MPCC build on the card (one launch
    of its kernel) against its plain version on the same CUDA tensors,
    field by field (``compare_qp``); fails on any entry whose bits differ.
    With the kernel's time, the plain version's, the bound, the launch
    count and the wrapper's host microseconds per call (host clock over
    calls queued without a synchronise, the best of 5 batches of 20). A
    single race is compared as a batch of two (the race twice, the first
    kept)."""
    from colaborativempc_tpu_torch.ops import cuda_sqp
    from colaborativempc_tpu_torch.planners import mpcc, nl
    from colaborativempc_tpu_torch.scripts import clock_split
    if family == "nl":
        build, plain, wrapper = (nl.build_nl_qp, nl.build_nl_qp_plain,
                                 cuda_sqp.nl_qp_batched)
        per_problem = ("x_bar", "u_bar", "lambdas", "neigh_xy",
                       "master_mask", "planes0")
    else:
        build, plain, wrapper = (mpcc.build_mpcc_qp, mpcc.build_mpcc_qp_plain,
                                 cuda_sqp.mpcc_qp_batched)
        per_problem = ("x_bar", "u_bar")
    P, N = args["x_bar"].shape[0], args["N"]
    cargs = dict(args)
    if batch_of_two:
        for k in per_problem:
            if cargs.get(k) is not None:
                cargs[k] = torch.cat([cargs[k], cargs[k]]).contiguous()
    before = wrapper.launches
    got = build(**cargs)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        fail(f"phase 3d {tag}: the build did not launch its kernel once")
    ref = plain(**cargs)
    a64 = {k: (v.double() if isinstance(v, torch.Tensor)
               and v.is_floating_point() and k in per_problem else v)
           for k, v in args.items()}
    ref64 = plain(**a64)
    torch.cuda.synchronize()
    out = compare_qp(f"phase 3d {tag}", got, ref, ref64, P)
    if tag in SQP_ORDER_UNFOLLOWED:
        if not (out["max_rel_err_vs_f64"] <= TOL_EPOCH_DATA_F64
                * out["plain_max_rel_err_vs_f64"]):
            fail(f"phase 3d {tag}: the kernel's share of scale from float64 "
                 f"{out['max_rel_err_vs_f64']:.3g} exceeds "
                 f"{TOL_EPOCH_DATA_F64} x the float32 plain version's "
                 f"{out['plain_max_rel_err_vs_f64']:.3g}")
    elif out["entries_differing"]:
        fail(f"phase 3d {tag}: {out['entries_differing']} entries differ in "
             f"their bits from the plain version {out['differing_by_field']}"
             f" (torch {torch.__version__}, CUDA {torch.version.cuda})")
    nb = args["neigh_xy"].shape[-2] if family == "nl" else 0
    track = args["track"]
    if family == "nl":
        nc, m = cuda_sqp.nl_shape(nb, args["coupling"])
        traffic = cuda_sqp.nl_traffic(P, N, nb, args["coupling"],
                                      *track.s0.shape)
    else:
        nc, m = 2, cuda_sqp.MPCC_ROWS
        traffic = cuda_sqp.mpcc_traffic(P, N, *track.s0.shape)
    host_us = clock_split.host_us(lambda: build(**args), calls=20,
                                  batches=5)
    plan = (cuda_sqp.sqp_qp_plan(P, N, nc, m, track.s0.shape[1], nb,
                                 args["coupling"] == "hp_opt")
            if family == "nl" else None)
    stages = plan.stages if plan else cuda_sqp.STAGES_PER_BLOCK
    out.update(P=P, N=N, nc=nc, m=m, stages_per_block=stages,
               spilled=plan.spilled if plan else "",
               compared_as_batch=2 * P if batch_of_two
               else P, matvec_order=cuda_sqp.matvec_order(
                   cargs["x_bar"].shape[0] * N,
                   "row" if family == "nl" else "col"),
               host_us=host_us, ms=cuda_ms(lambda: build(**args), reps),
               plain_ms=cuda_ms(lambda: plain(**args), 2))
    out["bound_ms"], out["bound_by"] = sqp_qp_bound(*traffic)
    out["roofline_share"] = out["bound_ms"] / out["ms"]
    print(f"phase 3d {tag} P={P} N={N} nc={nc} m={m} ({stages} stages per "
          f"block{', image spilled' if out['spilled'] else ''}): build kernel "
          f"{out['ms']:.4f} ms (bound {out['bound_ms']:.3g} by "
          f"{out['bound_by']}, share {out['roofline_share']:.3f}; "
          f"wrapper {host_us:.1f} us of host per call) vs plain "
          f"{out['plain_ms']:.3f} ms (max |err| {out['max_abs_err']:.3g}, "
          f"{out['max_rel_err']:.3g} of scale, tol {TOL_SQP_QP}; "
          f"{out['entries_differing']} entries differ in their bits; "
          f"compared at batch {out['compared_as_batch']}; vs float64 "
          f"{out['max_rel_err_vs_f64']:.3g} of scale, the float32 plain "
          f"version {out['plain_max_rel_err_vs_f64']:.3g})", flush=True)
    return out


# phase 3d's builds of large fleets: eu's price over 3 neighbours (torch's
# order of the sum), eu and hp past the former 8 neighbours (9, 31),
# hp_opt with 10, 15 and 16 neighbours, either side of the last fleet
# whose blocks take 8 stages on the Highway track (21 and 22 agents), 32
# agents (4 stages per block), and eu 32 and hp_opt 16 agents at N=125
LARGE_FLEET_BUILDS = (
    ("nl eu 4 agents", 64, 4, 20, "eu", {}),
    ("nl eu 10 agents", 20, 10, 20, "eu", {}),
    ("nl hp 10 agents", 20, 10, 20, "hp", {}),
    ("nl eu 32 agents", 64, 32, 20, "eu", {}),
    ("nl hp_opt 11 agents", 22, 11, 20, "hp_opt", {}),
    ("nl hp_opt 16 agents", 32, 16, 20, "hp_opt", {}),
    ("nl hp_opt 17 agents", 34, 17, 20, "hp_opt", {}),
    ("nl hp_opt 21 agents", 21, 21, 20, "hp_opt", {}),
    ("nl hp_opt 22 agents", 22, 22, 20, "hp_opt", {}),
    ("nl hp_opt 32 agents", 64, 32, 20, "hp_opt", {}),
    ("nl eu 32 agents N=125", 32, 32, 125, "eu", {}),
    ("nl hp_opt 16 agents N=125", 16, 16, 125, "hp_opt", {}),
    # past one block's shared memory (the image and the neighbour arrays
    # spilled to global memory): hp_opt 72 and 100 agents; eu 64 agents
    # (63 terms in the price sum)
    ("nl hp_opt 72 agents", 72, 72, 20, "hp_opt", {}),
    ("nl hp_opt 100 agents", 100, 100, 20, "hp_opt", {}),
    ("nl eu 64 agents", 64, 64, 20, "eu", {}),
    ("nl eu 66 agents", 66, 66, 20, "eu", {}),
)
# phase 3d builds whose eu/hp price sum has 64 or more terms over 128 or
# more outputs: there torch.sum splits the terms over four warps, an order
# the kernel does not follow (scripts/library_order.py); held to float64
# (TOL_EPOCH_DATA_F64 times the float32 plain version's share of scale)
SQP_ORDER_UNFOLLOWED = ("nl eu 66 agents",)


def check_sqp_builds(dev):
    """Phase 3d: both build kernels against their plain versions at the
    main paths' shapes, the branch edges, either side of each boundary of
    the card's batched matrix-vector order (``cuda_sqp.MATVEC_ORDERS``),
    hp_opt with 3, 4 and 8 neighbours, a fitted track of more segments
    than the kernels stage (``scripts/sqp_qp_split.py``'s inputs) and the
    large fleets (``LARGE_FLEET_BUILDS``)."""
    from colaborativempc_tpu_torch.scripts.sqp_qp_split import (
        mpcc_build_args, nl_build_args,
    )
    out = {}
    for tag, P, n, N, coupling, kw in (
            ("nl eu", 192, 3, 20, "eu", {}),
            ("nl hp", 192, 3, 20, "hp", {}),
            ("nl hp_opt", 192, 3, 20, "hp_opt", {}),
            ("nl eu N=125", 3, 3, 125, "eu", {}),
            ("nl eu Oval2 lanes", 48, 3, 20, "eu",
             dict(map_type="Oval2", lanes=True)),
            ("nl eu edges", 6, 3, 20, "eu", dict(edges=True)),
            ("nl hp_opt edges", 6, 3, 20, "hp_opt", dict(edges=True)),
            ("nl eu P=649", 649, 3, 20, "eu", {}),
            ("nl eu P=650", 650, 3, 20, "eu", {}),
            ("nl eu P=1864", 1864, 3, 20, "eu", {}),
            ("nl eu P=1865", 1865, 3, 20, "eu", {}),
            ("nl hp_opt 4 agents", 256, 4, 20, "hp_opt", {}),
            ("nl hp_opt 5 agents", 320, 5, 20, "hp_opt", {}),
            ("nl hp_opt 9 agents", 144, 9, 20, "hp_opt", {}),
            ("nl eu 3000 segments", 48, 3, 20, "eu", dict(segments=3000)),
            *LARGE_FLEET_BUILDS):
        out[tag] = check_sqp_build(
            dev, tag, "nl", nl_build_args(dev, P, n, N, coupling, **kw), 20)
    for tag, P, N, kw in (("mpcc P=1 N=60", 1, 60, {}),
                          ("mpcc P=18 N=20", 18, 20, {}),
                          ("mpcc edges", 2, 20, dict(edges=True)),
                          *((f"mpcc P={P}", P, 20, {})
                            for P in (9, 10, 66, 67, 142, 143)),
                          ("mpcc 3000 segments", 18, 20,
                           dict(segments=3000))):
        out[tag] = check_sqp_build(dev, tag, "mpcc",
                                   mpcc_build_args(dev, P, N, **kw), 20,
                                   batch_of_two=P == 1)
    return out


def fleet(device, B):
    """Config, track and the perturbed B-scenario start state of bench.py."""
    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, SolverConfig, lpv_gains,
    )
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.parallel import batch_fleet_state
    from colaborativempc_tpu_torch.runtime import init_lpv_fleet
    cfg = ExperimentConfig(n_agents=3, N=20, dt=0.02, map_type="Highway",
                           gains=lpv_gains(),
                           solver=SolverConfig(admm_iters=300))
    track = make_track(cfg.map_type, device=device)
    state = batch_fleet_state(init_lpv_fleet(track, cfg, device=device), B,
                              device=device)
    rng = np.random.default_rng(0)
    dx = torch.tensor(rng.normal(size=tuple(state.x0.shape)) * 0.02,
                      dtype=state.x0.dtype, device=device)
    return cfg, track, state._replace(x0=state.x0 + dx)


def all_finite(tensors):
    return all(bool(torch.isfinite(x).all()) for x in tensors
               if x.is_floating_point())


def check_nl_epoch(dev, coupling, reps, **pin):
    """Phase 3b at one coupling: the epoch kernel vs its plain twin on the
    NL planner's QPs of 256 perturbed 3-agent fleets (N=20), as the Jacobi
    sweep hands them to the solver, under its launch plan or with ``pin``
    pinned."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.ops import cuda_lqr
    from colaborativempc_tpu_torch.ops.admm import admm_epoch_inputs_plain
    from colaborativempc_tpu_torch.planners import build_nl_qp
    from colaborativempc_tpu_torch.runtime.ocd import _bisector_planes
    from colaborativempc_tpu_torch.runtime.simulate import _neighbour_index
    from colaborativempc_tpu_torch.scripts import monte_carlo
    B, n = 256, 3
    cfg, _, st = monte_carlo.setup("nl", scenarios=B, agents=n, N=20,
                                   steps=1, device=dev, coupling=coupling)
    N = cfg.N
    ns = torch.as_tensor(_neighbour_index(n), device=dev)
    ids = torch.arange(n, device=dev)
    rng = np.random.default_rng(7)
    lam = torch.tensor(rng.uniform(0.0, 1.0, size=(B, n, n - 1, N)),
                       dtype=torch.float32, device=dev)
    x_bar = torch.cat([st.x0[:, :, None], st.x_pred[:, :, 1:]], dim=2)
    planes = _bisector_planes(x_bar)[:, torch.minimum(ids[:, None], ns),
                                     torch.maximum(ids[:, None], ns)]

    def flat(t):
        return t.reshape((B * n,) + t.shape[2:])
    mm = (ids[:, None] < ns).float().expand(B, n, n - 1)
    qp = build_nl_qp(make_track("Highway", device=dev), cfg.gains,
                     cfg.limits, cfg.model, N, cfg.dt, flat(x_bar),
                     flat(st.u_pred), flat(lam),
                     flat(x_bar[:, ns][..., 7:9].transpose(2, 3)), flat(mm),
                     coupling=coupling, planes0=flat(planes))
    data = admm_epoch_inputs_plain(qp, rho=10.0)
    z0 = torch.cat([flat(st.x0), flat(st.u_old)], dim=-1).contiguous()
    w0 = torch.clamp(torch.zeros_like(qp.lo), qp.lo, qp.hi).contiguous()
    y0 = torch.zeros_like(w0)
    shape = dict(P=B * n, nc=data.G.shape[-1], mr=data.lo.shape[-1])
    if not all(bool(torch.isfinite(x).all()) for x in data[:9]):
        fail(f"non-finite NL epoch data ({coupling})")
    plan = cuda_lqr.kernel_plan(shape["P"], N, data.F.shape[-1], shape["nc"],
                                shape["mr"], **pin)
    plain_kw = dict(epoch_len=EPOCH_LEN, alpha=ALPHA)
    kw = dict(plain_kw, plan=plan)
    got = cuda_lqr.admm_epoch_batched(data, z0, w0, y0, **kw)
    torch.cuda.synchronize()
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0, **plain_kw)
    torch.cuda.synchronize()
    err_zcwy = max_err(got[:4], ref[:4])
    err_res = max_err(got[4:], ref[4:])
    if not all(bool(torch.isfinite(x).all()) for x in got):
        fail(f"epoch kernel output not finite on NL QPs ({coupling})")
    if not (err_zcwy <= TOL_EPOCH and err_res <= TOL_RESID):
        fail(f"epoch kernel vs plain on NL QPs ({coupling}, {shape}): "
             f"z/c/w/y err {err_zcwy} (tol {TOL_EPOCH}), rp/rd err "
             f"{err_res} (tol {TOL_RESID})")
    out = dict(max_abs_err=err_zcwy, max_abs_err_resid=err_res,
               plan=plan._asdict(),
               ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched(
                   data, z0, w0, y0, **kw), reps),
               plain_ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched_plain(
                   data, z0, w0, y0, **plain_kw), 1))
    out["bound_ms"], out["bound_by"] = kernel_bound(
        shape["P"], N, data.F.shape[-1], shape["nc"], shape["mr"], EPOCH_LEN)
    out["roofline_share"] = out["bound_ms"] / out["ms"]
    print(f"phase 3b {coupling} {shape}: epoch kernel {out['ms']:.4f} ms "
          f"(bound {out['bound_ms']:.3g}, plan {out['plan']}) vs plain "
          f"{out['plain_ms']:.4f} ms (err {err_zcwy:.3g}, resid err "
          f"{err_res:.3g})", flush=True)
    out["qp"] = (qp, 1.0)
    return out


def watch_solver(planner, record, out=None):
    """Wrap a planner module's ``admm_solve`` so each call appends
    ``record(qp, z0, kw, solution)`` to the returned list (``out``, or a
    new one); ``restore()`` unwraps it."""
    orig = planner.admm_solve
    out = [] if out is None else out

    def watched(qp, z0, **kw):
        sol = orig(qp, z0, **kw)
        out.append(record(qp, z0, kw, sol))
        return sol

    def restore():
        planner.admm_solve = orig
    planner.admm_solve = watched
    return out, restore


class SolverCalls(list):
    """The epochs of each watched ``admm_solve`` call, and the planner
    family (``lpv``, ``nl`` or ``mpcc``) that made them: every NL or MPCC
    solve follows one SQP build."""
    family = None


def count_solver_epochs(planner=None):
    """Watch a planner module's ``admm_solve`` (default: the NL planner's):
    each call adds the epochs it ran (its slowest problem's iterations over
    the epoch length) to the returned list (a ``SolverCalls``)."""
    from colaborativempc_tpu_torch.ops.admm import default_epoch_len
    if planner is None:
        from colaborativempc_tpu_torch.planners import nl as planner
    out = SolverCalls()
    out.family = planner.__name__.rsplit(".", 1)[-1]
    return watch_solver(planner, lambda qp, z0, kw, sol: int(
        sol.iterations.max()) // (kw.get("epoch_len")
                                  or default_epoch_len(qp.lo.shape[1])), out)


def reset_launches():
    from colaborativempc_tpu_torch.ops import cuda_lqr, cuda_sqp
    cuda_lqr.admm_epoch_batched.launches = 0
    cuda_lqr.lqr_affine_solve_batched.launches = 0
    cuda_lqr.epoch_data_batched.launches = 0
    cuda_sqp.nl_qp_batched.launches = 0
    cuda_sqp.mpcc_qp_batched.launches = 0


def read_launches():
    from colaborativempc_tpu_torch.ops import cuda_lqr, cuda_sqp
    return {"epoch": cuda_lqr.admm_epoch_batched.launches,
            "affine": cuda_lqr.lqr_affine_solve_batched.launches,
            "epoch_data": cuda_lqr.epoch_data_batched.launches,
            "nl_qp": cuda_sqp.nl_qp_batched.launches,
            "mpcc_qp": cuda_sqp.mpcc_qp_batched.launches}


def check_build_launches(what, launches, builds):
    """Each build kernel launched once per SQP build the solves ran:
    ``builds`` counts the solves by planner family (an NL or MPCC solve
    follows one build; the families absent ran none)."""
    for fam in ("nl", "mpcc"):
        n = builds.get(fam, 0)
        if launches[f"{fam}_qp"] != n:
            fail(f"{what}: the {fam} build kernel launched "
                 f"{launches[f'{fam}_qp']} times, the {fam} solves ran "
                 f"{n} builds")


def check_epoch_launches(what, launches, epochs, builds=None):
    """The epoch kernel and the epoch-data kernel each launched once per
    epoch the solves ran, and at least once. With ``builds`` (solves by
    planner family), or ``epochs`` a ``SolverCalls``, also
    ``check_build_launches``."""
    n = sum(epochs) if not isinstance(epochs, int) else epochs
    if launches["epoch"] != n or n == 0:
        fail(f"{what}: epoch kernel launched {launches['epoch']} times, the "
             f"solves ran {n} epochs")
    if launches["epoch_data"] != n:
        fail(f"{what}: epoch-data kernel launched {launches['epoch_data']} "
             f"times, the solves ran {n} epochs")
    if builds is None and isinstance(epochs, SolverCalls):
        builds = {epochs.family: len(epochs)}
    if builds is not None:
        check_build_launches(what, launches, builds)


NL_B, NL_STEPS = 64, 20


def nl_main_path(dev, card):
    """Phase 6: the NL-OCD Monte-Carlo with the launch counters and the
    solver's epochs counted. Returns the record and the run's final
    state."""
    from colaborativempc_tpu_torch.scripts import monte_carlo
    cfg, rollout, state0 = monte_carlo.setup(
        "nl", scenarios=NL_B, agents=3, N=20, steps=NL_STEPS, device=dev)
    epochs, restore = count_solver_epochs()
    reset_launches()
    try:
        final, (xh, uh, met) = rollout(state0)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = read_launches()
    if not all_finite(list(final) + [xh, uh] + list(met)):
        fail("NL path: a state is not finite")
    check_epoch_launches("phase 6 (NL path)", launches, epochs)
    out = dict(
        card=card, fleets=NL_B, steps=NL_STEPS,
        mean_ocd_iterations=float(met.ocd_iterations.float().mean()),
        max_ocd_iterations=int(met.ocd_iterations.max()),
        feasible_share=float(met.feasible.float().mean()),
        min_dist_exec=float(met.min_dist_exec.min()),
        solver_calls=len(epochs), launches=launches)
    print(f"phase 6: NL-OCD {NL_B} fleets x 3 agents x {NL_STEPS} steps: "
          f"mean OCD "
          f"iterations {out['mean_ocd_iterations']:.2f}, feasible share "
          f"{out['feasible_share']:.4f}, min_dist_exec "
          f"{out['min_dist_exec']:.4f} m, epoch-kernel launches "
          f"{launches['epoch']} over {len(epochs)} solver calls, epoch-data "
          f"kernel launches {launches['epoch_data']} [{card}]",
          flush=True)
    return out, final


def record_admm_iterations():
    """Watch the NL planner's ``admm_solve``: each call appends its
    problems' ADMM iteration counts (on the CPU) to the returned list."""
    from colaborativempc_tpu_torch.planners import nl
    return watch_solver(nl, lambda qp, z0, kw, sol: sol.iterations.cpu())


def nl_end_to_end(dev):
    """Phase 7: the NL path on the kernels vs on the CPU's plain twins, B=2
    fleets x 3 steps: plans within TOL_ROLLOUT, equal feasible flags and OCD
    iteration counts. Each ADMM solve's per-problem iteration counts are
    recorded on both paths and printed where they differ; if the plans
    miss the tolerance where counts differ (a problem converging an epoch
    apart at a convergence edge), the plans are held to it in the fleets
    whose counts agree in every solve."""
    from colaborativempc_tpu_torch.scripts import monte_carlo
    B = 2
    out = {}
    for coupling, sweep in (("eu", "jacobi"), ("hp_opt", "gauss_seidel")):
        outs = {}
        for name in ("cuda", "cpu"):
            _, rollout, st = monte_carlo.setup(
                "nl", scenarios=B, agents=3, N=20, steps=3,
                device=torch.device(name), coupling=coupling, sweep=sweep)
            calls, restore = record_admm_iterations()
            reset_launches()
            try:
                fin, (_, _, m) = rollout(st)
            finally:
                restore()
            # one NL build kernel launch per SQP build on the card, none
            # on the CPU
            check_build_launches(
                f"phase 7 ({coupling}/{sweep}, {name})", read_launches(),
                {"nl": len(calls)} if name == "cuda" else {})
            outs[name] = (fin.x_pred.cpu(), m.feasible.cpu(),
                          m.ocd_iterations.cpu(), calls)
        (xg, fg, og, cg), (xc, fc, oc, cc) = outs["cuda"], outs["cpu"]
        dx_f = (xg - xc).abs().flatten(1).amax(dim=1)   # per fleet
        same_feas = bool(torch.equal(fg, fc))
        same_its = bool(torch.equal(og, oc))
        differ = set(range(B)) if len(cg) != len(cc) else set()
        n_solves = n_differ = 0
        for call, (a, b) in enumerate(zip(cg, cc)):
            per_fleet = a.numel() // B
            n_solves += a.numel()
            for i in (a != b).nonzero().flatten().tolist():
                n_differ += 1
                differ.add(i // per_fleet)
                print(f"phase 7: {coupling}/{sweep} solve {call} problem {i} "
                      f"(fleet {i // per_fleet}): ADMM iterations "
                      f"{int(a[i])} on the card, {int(b[i])} on the CPU",
                      flush=True)
        if not (same_feas and same_its):
            fail(f"NL {coupling}/{sweep} kernel vs plain: feasible flags "
                 f"equal: {same_feas}, OCD iterations equal: {same_its} "
                 f"({og.tolist()} vs {oc.tolist()})")
        held = held_to_tolerance(f"phase 7 (NL {coupling}/{sweep} kernel vs "
                                 "plain)", dx_f, differ)
        out[f"{coupling}_{sweep}"] = dict(
            held, problem_solves=n_solves, problem_solves_differing=n_differ)
        dx = held["max_dx"]
        print(f"phase 7: NL {coupling}/{sweep} B={B} x 3 steps, max |dx_pred| "
              f"cuda vs cpu {dx:.3g} ({dx / TOL_ROLLOUT:.3f} of the "
              f"tolerance; held to it in fleets {held['members_held']}: "
              f"{held['max_dx_held']:.3g}), ADMM iterations differ in "
              f"{n_differ} of {n_solves} problem solves, feasible flags and "
              f"OCD iterations {og.tolist()} equal", flush=True)
    return out


def nl_single_fleet(dev, card):
    """Phase 8: one fleet's NL-OCD closed loop, as ``nl_main`` runs it;
    the kernels launched once per epoch and per SQP build."""
    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, OCDConfig, SolverConfig, nl_gains,
    )
    from colaborativempc_tpu_torch.runtime import run_nl_experiment
    cfg = ExperimentConfig(
        n_agents=3, N=20, dt=0.02, max_it=20, map_type="Highway",
        gains=nl_gains(), ocd=OCDConfig(max_it_ocd=50),
        solver=SolverConfig(admm_iters=200, sqp_iters=2))
    epochs, restore = count_solver_epochs()
    reset_launches()
    try:
        res = run_nl_experiment(cfg, device=dev)
    finally:
        restore()
    check_epoch_launches("phase 8 (NL single fleet)", read_launches(),
                         epochs)
    if res.steps != 20 or not np.isfinite(res.states).all():
        fail(f"single-fleet NL run: {res.steps} steps, finite states: "
             f"{bool(np.isfinite(res.states).all())}")
    out = dict(card=card, steps=res.steps,
               mean_ocd_iterations=float(res.ocd_iterations.mean()),
               feasible_share=float(res.feasible.mean()),
               min_dist_exec=float(res.min_dist_exec.min()))
    print(f"phase 8: run_nl_experiment 3 agents N=20, {res.steps} steps: "
          f"mean OCD iterations "
          f"{out['mean_ocd_iterations']:.2f}, feasible share "
          f"{out['feasible_share']:.4f} [{card}]", flush=True)
    return out


def rollout_iterations_agree(dev):
    """Phase 5: the B=4 LPV rollout for 5 steps on the card and on the CPU.
    Plans agree within TOL_ROLLOUT with equal feasible flags; where a
    problem ran a different number of ADMM iterations on the two paths
    (an epoch apart at a convergence edge), the counts are printed and the
    plans are held to the tolerance in the scenarios whose counts agree."""
    from colaborativempc_tpu_torch.runtime import make_lpv_fleet_rollout
    outs = {}
    for name in ("cuda", "cpu"):
        cfg5, track5, st5 = fleet(torch.device(name), 4)
        fin, (_, _, m5) = make_lpv_fleet_rollout(track5, cfg5, 5)(st5)
        outs[name] = (fin.x_pred.cpu(), m5.feasible.cpu(),
                      m5.iterations.cpu())
    (xg, fg, ig), (xc, fc, ic) = outs["cuda"], outs["cpu"]
    dx_s = (xg - xc).abs().flatten(1).amax(dim=1)   # per scenario
    dx = float(dx_s.max())
    differ = ig != ic                               # (B, steps, agents)
    for b, k, a in differ.nonzero().tolist():
        print(f"phase 5: scenario {b} step {k} agent {a}: ADMM iterations "
              f"{int(ig[b, k, a])} on the card, {int(ic[b, k, a])} on the "
              "CPU", flush=True)
    if dx <= TOL_ROLLOUT and bool(torch.equal(fg, fc)):
        print(f"phase 5: B=4 x 5 steps, max |dx_pred| cuda vs cpu {dx:.3g} "
              f"({dx / TOL_ROLLOUT:.3f} of the tolerance), feasible flags "
              f"equal, ADMM iterations differ in {int(differ.sum())} of "
              f"{differ.numel()} solves", flush=True)
        return dict(max_dx=dx, solves_differing=int(differ.sum()))
    agree = ~differ.flatten(1).any(dim=1)
    if not bool(agree.any()):
        fail(f"rollout kernel vs plain: max |dx_pred| {dx} (tol "
             f"{TOL_ROLLOUT}) and no scenario with equal iteration counts")
    dx_a = float(dx_s[agree].max())
    same_a = bool(torch.equal(fg[agree], fc[agree]))
    if not (dx_a <= TOL_ROLLOUT and same_a):
        fail(f"rollout kernel vs plain: max |dx_pred| {dx_a} (tol "
             f"{TOL_ROLLOUT}) where the iteration counts agree, feasible "
             f"flags equal there: {same_a}")
    print(f"phase 5: B=4 x 5 steps, max |dx_pred| {dx:.3g} over all "
          f"scenarios, {dx_a:.3g} over the {int(agree.sum())} whose ADMM "
          "iteration counts agree (held to the tolerance), feasible flags "
          "equal there", flush=True)
    return dict(max_dx=dx, max_dx_where_counts_agree=dx_a,
                solves_differing=int(differ.sum()))


MPCC_N, MPCC_WARM, MPCC_STEPS = 60, 10, 80
BAT_N, BAT_WARM, BAT_STEPS = 20, 10, 160


def mpcc_race(dev, card):
    """Phase 10: one MPCC race at the reference's horizon, N=60 (the
    associative schedule, epoch 15): 10 warm-in steps, then MPCC_STEPS
    steps with the launch counters and the solver's epochs counted."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.planners import mpcc
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
    from colaborativempc_tpu_torch.runtime import racing
    cfg = MPCCConfig(N=MPCC_N)
    if not (cfg.resolved_assoc() and cfg.resolved_epoch_len() == 15):
        fail("phase 10: the N=60 schedule did not resolve to assoc, epoch 15")
    track = make_track(cfg.map_type, device=dev)
    step = racing.make_mpcc_step(track, cfg)
    st = racing.init_mpcc(track, cfg, device=dev)
    for _ in range(MPCC_WARM):
        st, _ = step(st)
    epochs, restore = count_solver_epochs(mpcc)
    reset_launches()
    ms = []
    try:
        for _ in range(MPCC_STEPS):
            st, m = step(st)
            ms.append(m)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = read_launches()
    if not all_finite(list(st) + [t for m in ms for t in m]):
        fail("phase 10: an MPCC state is not finite")
    check_epoch_launches("phase 10 (MPCC race)", launches, epochs)
    resets = sum(int(m.reset.sum()) for m in ms)
    feas = float(np.mean([float(m.feasible.float().mean()) for m in ms]))
    out = dict(card=card, N=MPCC_N, steps=MPCC_STEPS, final_s=float(st.x[0, 6]), feasible_share=feas, resets=resets,
               epochs=sum(epochs), launches=launches["epoch"],
               launches_per_step=launches["epoch"] / MPCC_STEPS,
               mean_admm_iterations=float(np.mean(
                   [int(m.iterations[0]) for m in ms])))
    print(f"phase 10: MPCC race N={MPCC_N}, {MPCC_STEPS} steps after "
          f"{MPCC_WARM} warm-in: final s "
          f"{out['final_s']:.3f} m, feasible share {feas:.4f}, resets "
          f"{resets}, epoch-kernel launches {launches['epoch']} "
          f"({out['launches_per_step']:.2f} per step) [{card}]", flush=True)
    return out


def mpcc_battery(dev, card):
    """Phase 11: the 18-race gain battery of scripts/experiment_battery.py
    at N=20, as ``run_mpcc_battery`` races it, for BAT_STEPS steps after
    BAT_WARM warm-in steps."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.planners import mpcc
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig, MPCCGains
    from colaborativempc_tpu_torch.runtime import battery, racing
    cfg = MPCCConfig(N=BAT_N)
    grid = battery.mpcc_gain_grid(MPCCGains(), q_contour=[20.0, 50.0, 120.0],
                                  q_progress=[0.5, 1.0, 2.0],
                                  dr_scale=[0.5, 1.0])
    track = make_track(cfg.map_type, device=dev)
    L = float(track.track_length[0])
    gains = MPCCGains(*(
        torch.tensor(np.asarray([getattr(g, f) for g in grid], np.float32),
                     device=dev) for f in MPCCGains._fields))
    step_fn = racing._make_mpcc_step_fn(track, cfg)
    st = racing.init_mpcc(track, cfg, races=len(grid), device=dev)
    for _ in range(BAT_WARM):
        st, _ = step_fn(gains, st)
    epochs, restore = count_solver_epochs(mpcc)
    reset_launches()
    try:
        st, met = racing._race(lambda s: step_fn(gains, s), st, BAT_STEPS)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = read_launches()
    if not all_finite(list(st) + list(met)):
        fail("phase 11: an MPCC battery state is not finite")
    check_epoch_launches("phase 11 (MPCC battery)", launches, epochs)
    laps = int((st.x[:, 6] >= L).sum())
    out = dict(card=card, races=len(grid), N=BAT_N, steps=BAT_STEPS,
               laps_completed=laps,
               feasible_share=float(met.feasible.float().mean()),
               resets=int(met.reset.sum()), epochs=sum(epochs),
               launches=launches["epoch"],
               launches_per_step=launches["epoch"] / BAT_STEPS)
    print(f"phase 11: MPCC battery {len(grid)} races N={BAT_N} x "
          f"{BAT_STEPS} steps: laps completed {laps}/"
          f"{len(grid)}, feasible share {out['feasible_share']:.4f}, "
          f"epoch-kernel launches {launches['epoch']} "
          f"({out['launches_per_step']:.2f} per step) [{card}]", flush=True)
    return out


def held_to_tolerance(what, dx_per, differ):
    """Plans of a card run and a CPU run held to TOL_ROLLOUT: all of them,
    or, where some problems ran different ADMM iteration counts on the two
    paths (an epoch apart at a convergence edge), those whose counts agree.
    ``dx_per``: max |dx| per batch member; ``differ``: members whose counts
    differ."""
    dx = float(dx_per.max())
    if dx <= TOL_ROLLOUT:
        return dict(max_dx=dx, max_dx_held=dx,
                    members_held=list(range(len(dx_per))))
    agree = [b for b in range(len(dx_per)) if b not in differ]
    if not differ or not agree:
        fail(f"{what}: max |dx| {dx} (tol {TOL_ROLLOUT}); iteration counts "
             f"differ in members {sorted(differ)}")
    held = float(dx_per[agree].max())
    if not held <= TOL_ROLLOUT:
        fail(f"{what}: max |dx| {held} (tol {TOL_ROLLOUT}) in the members "
             f"{agree} whose iteration counts agree")
    return dict(max_dx=dx, max_dx_held=held, members_held=agree)


def mpcc_kernel_vs_plain(dev):
    """Phase 12: B=2 races x 5 steps at N=20 on the card and on the CPU;
    on the card the kernels launched once per epoch and per SQP build,
    on the CPU no build kernel."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.planners import mpcc
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
    from colaborativempc_tpu_torch.runtime import racing
    cfg = MPCCConfig(N=BAT_N)
    x0 = None
    outs = {}
    for name in ("cuda", "cpu"):
        d = torch.device(name)
        track = make_track(cfg.map_type, device=d)
        if x0 is None:
            st = racing.init_mpcc(track, cfg, races=2, device=d)
            x0 = st.x.cpu().clone()
            x0[1, 0] += 0.3                       # the second race faster
        st = racing.init_mpcc(track, cfg, x0=x0, races=2, device=d)
        epochs, restore = count_solver_epochs(mpcc)
        reset_launches()
        try:
            fin, m = racing.make_mpcc_rollout(track, cfg, 5)(st)
        finally:
            restore()
        if name == "cuda":
            check_epoch_launches("phase 12 (MPCC, card)", read_launches(),
                                 epochs)
        else:
            check_build_launches("phase 12 (MPCC, CPU)", read_launches(), {})

        outs[name] = (fin.x.cpu(), fin.x_bar.cpu(), m.reset.cpu(),
                      m.iterations.cpu())
    (xg, bg, rg, ig), (xc, bc, rc, ic) = outs["cuda"], outs["cpu"]
    if not torch.equal(rg, rc):
        fail(f"phase 12: reset flags differ: {rg.tolist()} vs {rc.tolist()}")
    differ = set()
    for b, k in (ig != ic).nonzero().tolist():
        differ.add(b)
        print(f"phase 12: race {b} step {k}: ADMM iterations "
              f"{int(ig[b, k])} on the card, {int(ic[b, k])} on the CPU",
              flush=True)
    dx_per = torch.maximum((xg - xc).abs().amax(dim=1),
                           (bg - bc).abs().flatten(1).amax(dim=1))
    out = held_to_tolerance("phase 12 (MPCC kernel vs plain)", dx_per,
                            differ)
    out["steps_differing"] = int((ig != ic).sum())
    print(f"phase 12: MPCC B=2 x 5 steps, max |dx| cuda vs cpu "
          f"{out['max_dx']:.3g} ({out['max_dx'] / TOL_ROLLOUT:.3f} of the "
          f"tolerance), reset flags equal, ADMM iterations differ in "
          f"{out['steps_differing']} of {ig.numel()} race-steps", flush=True)
    return out


@functools.cache
def mpcc_qps(dev, P, N):
    """The first SQP iteration's normalised stage QPs of P cold-started
    races on oval_mt at horizon N, their scaled initial states and the
    epoch length the MPCC config resolves at N."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
    from colaborativempc_tpu_torch.runtime import racing
    cfg = MPCCConfig(N=N)
    qp, z0 = racing.cold_start_qps(make_track(cfg.map_type, device=dev), cfg,
                                   P)
    return qp, z0, cfg.resolved_epoch_len() or 20


def check_mpcc_epoch(dev, P, N, reps):
    """Phase 13 at one shape: the epoch kernel vs its plain twin on MPCC's
    own QPs, under the launch plan ``kernel_plan`` chooses."""
    from colaborativempc_tpu_torch.ops import cuda_lqr
    from colaborativempc_tpu_torch.ops.admm import admm_epoch_inputs_plain
    qp, z0, el = mpcc_qps(dev, P, N)
    data = admm_epoch_inputs_plain(qp, rho=10.0)
    if not all(bool(torch.isfinite(x).all()) for x in data[:9]):
        fail(f"phase 13: non-finite MPCC epoch data at P={P}, N={N}")
    nz, nc, mr = data.F.shape[-1], data.G.shape[-1], data.lo.shape[-1]
    w0 = torch.clamp(torch.zeros_like(qp.lo), qp.lo, qp.hi).contiguous()
    y0 = torch.zeros_like(w0)
    plan = cuda_lqr.kernel_plan(P, N, nz, nc, mr)
    kw = dict(epoch_len=el, alpha=ALPHA)
    got = cuda_lqr.admm_epoch_batched(data, z0, w0, y0, plan=plan, **kw)
    torch.cuda.synchronize()
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0, **kw)
    torch.cuda.synchronize()
    err_zcwy = max_err(got[:4], ref[:4])
    err_res = max_err(got[4:], ref[4:])
    if not all(bool(torch.isfinite(x).all()) for x in got):
        fail(f"phase 13: epoch kernel output not finite at P={P}, N={N}")
    if not (err_zcwy <= TOL_EPOCH and err_res <= TOL_RESID):
        fail(f"phase 13: epoch kernel vs plain on MPCC QPs P={P} N={N}: "
             f"z/c/w/y err {err_zcwy} (tol {TOL_EPOCH}), rp/rd err "
             f"{err_res} (tol {TOL_RESID})")
    out = dict(max_abs_err=err_zcwy, max_abs_err_resid=err_res,
               plan=plan._asdict(), epoch_len=el,
               ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched(
                   data, z0, w0, y0, plan=plan, **kw), reps),
               plain_ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched_plain(
                   data, z0, w0, y0, **kw), 1))
    out["bound_ms"], out["bound_by"] = kernel_bound(P, N, nz, nc, mr, el)
    out["roofline_share"] = out["bound_ms"] / out["ms"]
    print(f"phase 13 MPCC P={P} N={N} mr={mr} epoch {el}: epoch kernel "
          f"{out['ms']:.4f} ms (bound {out['bound_ms']:.3g}, plan "
          f"{out['plan']}) vs plain {out['plain_ms']:.4f} ms (err "
          f"{err_zcwy:.3g}, resid err {err_res:.3g})", flush=True)
    return out


TOL_ASSOC = 1e-3   # float32, relative to the solution's scale


def assoc_on_card(dev, card):
    """Phase 14: the associative affine solve against the sequential one
    on CUDA tensors."""
    from colaborativempc_tpu_torch.ops import (
        LQRCost, LQRDynamics, StageQP, build_admm_cost, lqr_affine_solve,
        lqr_affine_solve_assoc, lqr_factorize,
    )
    rng = np.random.default_rng(125)
    pr = random_epoch_problems(rng, P=3, N=125, nz=11, nc=2, mr=6)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    soft = t(pr["soft"])
    lpv_like = StageQP(
        dyn=LQRDynamics(t(pr["F"]), t(pr["G"]), t(pr["d"])),
        cost=LQRCost(t(pr["Q"]), t(pr["q"]), t(pr["R"]), t(pr["r"]),
                     t(pr["S"])),
        D=t(pr["D"]), E=t(pr["E"]), lo=t(pr["lo"]), hi=t(pr["hi"]),
        soft_lo=soft, soft_hi=soft)
    mq, mz0, _ = mpcc_qps(dev, 1, MPCC_N)
    cases = {"mpcc_p1_n60": (mq, mz0), "p3_n125": (lpv_like, t(pr["z0"]))}
    out = {}
    for tag, (qp, z0) in cases.items():
        rho_scale = torch.full(qp.lo.shape[::2], 100.0, device=dev)
        rv = 10.0 * rho_scale[:, None, :] * (
            torch.isfinite(qp.lo) | torch.isfinite(qp.hi)).float()
        cost = build_admm_cost(qp, rv)
        fac = lqr_factorize(qp.dyn, cost)
        za, ca = lqr_affine_solve_assoc(qp.dyn, fac, cost.q, cost.r, z0)
        zs, cs = lqr_affine_solve(qp.dyn, fac, cost.q, cost.r, z0)
        scale = max(1.0, float(zs.abs().max()), float(cs.abs().max()))
        err = max_err((za, ca), (zs, cs)) / scale
        if not (all_finite([za, ca]) and err <= TOL_ASSOC):
            fail(f"phase 14 {tag}: associative vs sequential affine solve "
                 f"{err} of the solution's scale (tol {TOL_ASSOC})")
        out[tag] = dict(rel_err_assoc_vs_sequential=err)
        print(f"phase 14 {tag}: assoc vs sequential affine solve "
              f"{err:.3g} of scale (tol {TOL_ASSOC}) [{card}]", flush=True)
    return out


LPV125_STEPS = 10


def lpv_long_horizon(dev, card):
    """Phase 15: one 3-agent fleet at N=125 on Highway through
    ``run_lpv_experiment`` with default settings."""
    from colaborativempc_tpu_torch.config import ExperimentConfig, lpv_gains
    from colaborativempc_tpu_torch.planners import lpv
    from colaborativempc_tpu_torch.runtime import (
        resolve_single_fleet_schedule, run_lpv_experiment,
    )
    cfg = ExperimentConfig(n_agents=3, N=125, dt=0.02, map_type="Highway",
                           gains=lpv_gains(), max_it=LPV125_STEPS)
    sv = resolve_single_fleet_schedule(cfg).solver
    if not (sv.assoc and sv.epoch_len == 15 and sv.admm_iters == 1000):
        fail(f"phase 15: the N=125 schedule resolved to {sv}")
    epochs, restore = count_solver_epochs(lpv)
    reset_launches()
    try:
        res = run_lpv_experiment(cfg, device=dev)
    finally:
        restore()
    launches = read_launches()
    if res.steps != LPV125_STEPS or not np.isfinite(res.states).all():
        fail(f"phase 15: {res.steps} steps, finite states: "
             f"{bool(np.isfinite(res.states).all())}")
    check_epoch_launches("phase 15 (LPV N=125)", launches, epochs)
    out = dict(card=card, steps=res.steps, epochs=sum(epochs),
               launches=launches["epoch"],
               launches_per_step=launches["epoch"] / res.steps,
               feasible_share=float(res.feasible.mean()),
               max_admm_iterations=int(res.iterations.max()))
    print(f"phase 15: run_lpv_experiment 3 agents N=125, {res.steps} steps: "
          f"feasible share "
          f"{out['feasible_share']:.4f}, epoch-kernel launches "
          f"{launches['epoch']} ({out['launches_per_step']:.1f} per step) "
          f"[{card}]", flush=True)
    return out


def lane_fleet(device, B):
    """The dynamic-lane config on Oval2 and its B-fleet start: perturbed
    speeds, agent 1 of every other fleet moved 1 m inwards (onto the inner
    lane, its Frenet entries still the outer lane's)."""
    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, SolverConfig, lpv_gains,
    )
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.parallel import batch_fleet_state
    from colaborativempc_tpu_torch.runtime import init_lpv_fleet
    cfg = ExperimentConfig(n_agents=3, N=20, dt=0.02, map_type="Oval2",
                           gains=lpv_gains(), dynamic_lane=True,
                           solver=SolverConfig(admm_iters=300))
    track = make_track(cfg.map_type, device=device)
    st = batch_fleet_state(init_lpv_fleet(track, cfg, device=device), B,
                           device=device)
    rng = np.random.default_rng(16)
    x0, xp = st.x0.clone(), st.x_pred.clone()
    x0[..., 0] += torch.tensor(rng.normal(size=(B, 3)) * 0.05,
                               dtype=x0.dtype, device=device)
    for a in (x0[::2, 1], xp[::2, 1]):
        a[..., 7] -= torch.sin(a[..., 5])
        a[..., 8] += torch.cos(a[..., 5])
    return cfg, track, st._replace(x0=x0, x_pred=xp)


LANE_B, LANE_STEPS = 64, 10


def dynamic_lanes(dev, card):
    """Phase 16: the dynamic-lane LPV fleet step, B=64 x 10 steps, then
    B=2 x 3 steps on the card vs the CPU."""
    from colaborativempc_tpu_torch.planners import lpv
    from colaborativempc_tpu_torch.runtime import make_lpv_fleet_step
    cfg, track, st = lane_fleet(dev, LANE_B)
    step = make_lpv_fleet_step(track, cfg)
    epochs, restore = count_solver_epochs(lpv)
    reset_launches()
    lanes, ms = [st.lane], []
    try:
        for _ in range(LANE_STEPS):
            st, m = step(st)
            lanes.append(st.lane)
            ms.append(m)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = read_launches()
    if not all_finite(list(st) + [t for m in ms for t in m]):
        fail("phase 16: a dynamic-lane state is not finite")
    check_epoch_launches("phase 16 (dynamic lanes)", launches, epochs)
    lanes = torch.stack(lanes)
    switches = int((lanes[1:] != lanes[:-1]).sum())
    if switches == 0:
        fail("phase 16: no lane switch in the dynamic-lane rollout")
    outs = {}
    for name in ("cuda", "cpu"):
        cfg2, track2, st2 = lane_fleet(torch.device(name), 2)
        step2 = make_lpv_fleet_step(track2, cfg2)
        its = []
        for _ in range(3):
            st2, m2 = step2(st2)
            its.append(m2.iterations)
        outs[name] = (st2.x_pred.cpu(), st2.lane.cpu(),
                      torch.stack(its, 1).cpu())
    (xg, lg, ig), (xc, lc, ic) = outs["cuda"], outs["cpu"]
    if not torch.equal(lg, lc):
        fail(f"phase 16: lanes differ cuda vs cpu: {lg.tolist()} vs "
             f"{lc.tolist()}")
    differ = {b for b, _, _ in (ig != ic).nonzero().tolist()}
    agree = held_to_tolerance("phase 16 (dynamic lanes cuda vs cpu)",
                              (xg - xc).abs().flatten(1).amax(dim=1), differ)
    out = dict(card=card, fleets=LANE_B, steps=LANE_STEPS,
               lane_switches=switches,
               agents_on_lane_1=int((st.lane == 1).sum()),
               feasible_share=float(torch.stack(
                   [m.feasible for m in ms]).float().mean()),
               epochs=sum(epochs), launches=launches["epoch"],
               launches_per_step=launches["epoch"] / LANE_STEPS,
               cuda_vs_cpu=agree)
    print(f"phase 16: dynamic lanes Oval2 B={LANE_B} x {LANE_STEPS} steps: "
          f"{switches} lane switches, "
          f"{out['agents_on_lane_1']} agents on lane 1 at the end, feasible "
          f"share {out['feasible_share']:.4f}, epoch-kernel launches "
          f"{launches['epoch']}; B=2 x 3 steps cuda vs cpu max |dx| "
          f"{agree['max_dx']:.3g}, lanes equal [{card}]", flush=True)
    return out


def run_counted(what, fn, *planners):
    """``fn()`` with the launch counters reset and the planners' solver
    epochs counted: ``(result, epoch launches)``; fails unless the epoch
    kernel launched once per epoch the solves ran, and at least once."""
    counts, restores = zip(*(count_solver_epochs(p) for p in planners))
    reset_launches()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for restore in restores:
            restore()
    launches = read_launches()
    builds = {}
    for c in counts:
        builds[c.family] = builds.get(c.family, 0) + len(c)
    check_epoch_launches(what, launches, [e for c in counts for e in c],
                         builds)
    return out, launches["epoch"]


CLI_STEPS, CLI_COMPARE_STEPS, CLI_TINY = 8, 5, (2, 8, 4)
LPV_FILES = ("csv/{a}/states.dat", "csv/{a}/u.dat", "csv/{a}/plan_dist.dat",
             "csv/{a}/time.dat", "pck/{a}/states.pkl", "pck/{a}/u.pkl")
TOL_EVAL_ROLLOUT = 1e-4
TOL_TOOLS_F64 = 1e-9      # float64 elementwise tools, card vs CPU
TOL_REGRESSION = 1e-6     # of the estimate's scale: an 11 x 11 inverse


def tools_card_vs_cpu(dev, run_dir):
    """Phase 17: the open-loop tools on a recorded run, on the card against
    the CPU: ``rollout_rk4`` with 4 substeps (float32) over agent 0's
    recorded inputs, ``regression`` of (A, B) from its record, ``gbellmf``
    of its vx, and ``plane_signed_distance`` of the separating planes
    between the agents' last positions (float64). Fails on a difference
    above its tolerance or an ego on the wrong side of a plane."""
    from colaborativempc_tpu_torch.geometry import (
        compute_hyperplanes, make_track, plane_signed_distance,
    )
    from colaborativempc_tpu_torch.runtime.io import load_experiment
    from colaborativempc_tpu_torch.utils import gbellmf, regression
    from colaborativempc_tpu_torch.utils.rollout import rollout_rk4
    s_hist, u_hist = load_experiment(run_dir, 0)
    xs = np.stack([h[0] for h in s_hist])
    us = np.stack([h[0] for h in u_hist])
    xy = load_states(run_dir, 3)[-1, :, 7:9]
    got = []
    for d in (dev, torch.device("cpu")):
        x = torch.tensor(xs, dtype=torch.float64, device=d)
        u = torch.tensor(us, dtype=torch.float64, device=d)
        roll = rollout_rk4(make_track("Highway", device=d), x[0].float(),
                           u.float(), 0.025, substeps=4)
        A, B, _ = regression(x, u, 1e-3)
        ego = torch.tensor(xy, dtype=torch.float64, device=d)
        neigh = torch.stack([ego.roll(-1, 0), ego.roll(-2, 0)], dim=1)
        dist = plane_signed_distance(compute_hyperplanes(ego, neigh),
                                     ego[:, None, :])
        got.append([t.cpu().numpy() for t in (
            roll, torch.cat([A, B], 1), gbellmf(x[:, 0], 0.5, 2.0, 1.0),
            dist)])
    (rg, ab_g, gb_g, dg), (rc, ab_c, gb_c, dc) = got
    out = dict(rollout_rk4=float(np.abs(rg - rc).max()),
               regression=float(np.abs(ab_g - ab_c).max()
                                / max(np.abs(ab_c).max(), 1.0)),
               gbellmf=float(np.abs(gb_g - gb_c).max()),
               plane_distance=float(np.abs(dg - dc).max()))
    if not (np.isfinite(rg).all() and out["rollout_rk4"] <= TOL_EVAL_ROLLOUT
            and out["regression"] <= TOL_REGRESSION
            and out["gbellmf"] <= TOL_TOOLS_F64
            and out["plane_distance"] <= TOL_TOOLS_F64 and (dg < 0).all()):
        fail(f"phase 17: open-loop tools card vs cpu {out}; ego plane "
             f"distances {dg.tolist()}")
    return out


def load_states(run_dir, n_agents):
    return np.stack([np.loadtxt(os.path.join(run_dir, "csv", str(a),
                                             "states.dat"), ndmin=2)
                     for a in range(n_agents)], axis=1)


def lpv_cli(dev, card):
    """Phase 17: the LPV flagship CLI at its defaults, the model check and
    the reference comparison on its output, and a tiny run (``CLI_TINY``:
    agents, N, steps) on the card against the CPU."""
    from colaborativempc_tpu_torch.planners import lpv
    from colaborativempc_tpu_torch.scripts import (
        compare_reference, eval_lpv_model, lpv_main,
    )
    steps = CLI_STEPS
    out = dict(card=card, steps=steps)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "lpv")
        res, launches = run_counted(
            "phase 17 (lpv_main)", lambda: lpv_main.main(
                ["--steps", str(steps), "--no-plot", "--verb", "0",
                 "--out", run_dir]), lpv)
        missing = [f.format(a=a) for a in range(3) for f in LPV_FILES
                   if not os.path.exists(os.path.join(run_dir,
                                                      f.format(a=a)))]
        if missing or not os.path.exists(os.path.join(run_dir,
                                                      "settings.csv")):
            fail(f"phase 17: lpv_main did not write {missing or 'settings'}")
        written = load_states(run_dir, 3)
        if (res.steps != steps or written.shape[0] != steps
                or not (np.isfinite(res.states).all()
                        and np.isfinite(written).all())):
            fail(f"phase 17: lpv_main ran {res.steps} steps, wrote "
                 f"{written.shape[0]}; finite: "
                 f"{bool(np.isfinite(written).all())}")
        out.update(launches=launches, launches_per_step=launches / steps,
                   feasible_share=float(res.feasible.mean()),
                   max_admm_iterations=int(res.iterations.max()),
                   matplotlib_importable=(
                       importlib.util.find_spec("matplotlib") is not None))
        print(f"phase 17: lpv_main 3 agents N=125 dt 0.025, {steps} "
              f"steps: feasible share "
              f"{out['feasible_share']:.4f}, epoch-kernel launches "
              f"{launches} ({out['launches_per_step']:.1f} per step); csv/pck "
              f"written; matplotlib importable here: "
              f"{out['matplotlib_importable']} [{card}]", flush=True)

        sim_g, err_g = eval_lpv_model.main([run_dir])
        sim_c, _ = eval_lpv_model.main([run_dir, "--device", "cpu"])
        d_eval = float(np.abs(sim_g - sim_c).max())
        if not (np.isfinite(sim_g).all() and d_eval <= TOL_EVAL_ROLLOUT):
            fail(f"phase 17: eval_lpv_model rollout card vs cpu {d_eval} "
                 f"(tol {TOL_EVAL_ROLLOUT})")
        out["eval_rollout_card_vs_cpu"] = d_eval
        out["tools_card_vs_cpu"] = tools = tools_card_vs_cpu(dev, run_dir)
        out["eval_max_err_vs_recorded"] = [float(e) for e in
                                           err_g.max(axis=0)]

        golden = os.path.join(tmp, "golden")
        for a in range(3):
            os.makedirs(os.path.join(golden, "csv", str(a)))
            shutil.copy(os.path.join(run_dir, "csv", str(a), "states.dat"),
                        os.path.join(golden, "csv", str(a), "states.dat"))
        with open(os.path.join(golden, "settings.csv"), "w") as f:
            f.write("n_agents,3\nN,125\ndt,0.025\nmap_type,Highway\n"
                    "vx_ref,3.0\nmin_dist,0.25\n")
        cmp, l_cmp = run_counted(
            "phase 17 (compare_reference)", lambda: compare_reference.main(
                ["--ref", golden, "--steps", str(CLI_COMPARE_STEPS),
                 "--short", "3"]), lpv)
        dev_short = float(np.max(cmp["short_deviation"]))
        if not np.isfinite(dev_short):
            fail("phase 17: compare_reference deviation not finite")
        out.update(compare_launches=l_cmp,
                   compare_short_deviation_max=dev_short)

        a, N, k = CLI_TINY
        written = {}
        for name in ("cuda", "cpu"):
            d = os.path.join(tmp, f"tiny_{name}")
            r = lpv_main.main(["--agents", str(a), "--N", str(N), "--steps",
                               str(k), "--no-plot", "--verb", "0", "--out",
                               d, "--device", name])
            written[name] = (load_states(d, a), r.iterations)
        (sg, ig), (sc, ic) = written["cuda"], written["cpu"]
        for t, j in zip(*np.nonzero(ig != ic)):
            print(f"phase 17: tiny run step {t} agent {j}: ADMM iterations "
                  f"{int(ig[t, j])} on the card, {int(ic[t, j])} on the CPU",
                  flush=True)
        d_tiny = float(np.abs(sg - sc).max())
        if not d_tiny <= TOL_ROLLOUT:
            fail(f"phase 17: tiny lpv_main card vs cpu states {d_tiny} "
                 f"(tol {TOL_ROLLOUT})")
        out["tiny_card_vs_cpu"] = d_tiny
    print(f"phase 17: eval_lpv_model card vs cpu {d_eval:.3g} (tol "
          f"{TOL_EVAL_ROLLOUT}); compare_reference {CLI_COMPARE_STEPS} steps "
          f"({l_cmp} launches), short-horizon deviation "
          f"{dev_short:.3g}; tiny lpv_main ({a} agents, N={N}, {k} steps) "
          f"card vs cpu {d_tiny:.3g} (tol {TOL_ROLLOUT}); open-loop tools "
          f"card vs cpu: rollout_rk4 {tools['rollout_rk4']:.3g} (tol "
          f"{TOL_EVAL_ROLLOUT}), regression {tools['regression']:.3g} of "
          f"scale (tol {TOL_REGRESSION}), gbellmf {tools['gbellmf']:.3g}, "
          f"plane distances {tools['plane_distance']:.3g} (tol "
          f"{TOL_TOOLS_F64}) [{card}]",
          flush=True)
    return out


NL125_STEPS = 2
PERT_STARTS, PERT_STEPS, PERT_CHUNK = 8, 5, 5


def stress_full_width(dev, card):
    """Phase 18: ``stress_study latency`` of one NL-OCD fleet at N=125 and
    ``perturbed --batched`` LPV at N=125 (one chunk of 5 steps)."""
    from colaborativempc_tpu_torch.planners import lpv, nl
    from colaborativempc_tpu_torch.scripts import stress_study
    n, nl_steps = 125, NL125_STEPS
    starts, steps, chunk = PERT_STARTS, PERT_STEPS, PERT_CHUNK
    lat, l_lat = run_counted(
        "phase 18 (latency nl-eu)", lambda: stress_study.main(
            ["latency", "--family", "nl-eu", "--n", str(n), "--steps",
             str(nl_steps)]), nl)
    if lat["steps"] != nl_steps or not np.isfinite(lat["s_final"]).all():
        fail(f"phase 18: NL latency ran {lat['steps']} steps, s_final "
             f"{lat['s_final']}")
    pert, l_pert = run_counted(
        "phase 18 (perturbed --batched lpv)", lambda: stress_study.main(
            ["perturbed", "--batched", "--family", "lpv", "--n", str(n),
             "--starts", str(starts), "--steps", str(steps), "--chunk",
             str(chunk)]), lpv)
    if pert["steps"] != steps or None in pert["min_dist_exec"]:
        fail(f"phase 18: perturbed ran {pert['steps']} steps, min_dist_exec "
             f"{pert['min_dist_exec']}")
    out = dict(card=card, latency_nl=lat,
               launches_nl=l_lat, launches_per_step_nl=l_lat / nl_steps,
               perturbed=pert, launches_perturbed=l_pert,
               launches_per_step_perturbed=l_pert / steps)
    print(f"phase 18: NL-OCD eu N={n} latency, {nl_steps} steps: p50 "
          f"{lat['p50_ms']} ms, p95 {lat['p95_ms']} ms, "
          f"{out['launches_per_step_nl']:.1f} epoch launches per step; "
          f"perturbed --batched LPV N={n}, {starts} starts x {steps} steps: "
          f"{pert['complete']} complete, "
          f"{out['launches_per_step_perturbed']:.1f} launches per step "
          f"[{card}]", flush=True)
    return out


def batteries(dev, card):
    """Phase 19: ``experiment_battery`` over its NL grid at two horizons and
    over its LPV grid."""
    horizons, nl_steps, lpv_steps = "20,40", 5, 10
    from colaborativempc_tpu_torch.planners import lpv, nl
    from colaborativempc_tpu_torch.scripts import experiment_battery
    res_nl, l_nl = run_counted(
        "phase 19 (NL battery)", lambda: experiment_battery.main(
            ["--pipeline", "nl", "--horizons", horizons, "--steps",
             str(nl_steps)]), nl)
    res_lpv, l_lpv = run_counted(
        "phase 19 (LPV battery)", lambda: experiment_battery.main(
            ["--pipeline", "lpv", "--steps", str(lpv_steps)]), lpv)
    runs = list(res_nl.values()) + [res_lpv]
    if not all(np.isfinite(r.states).all() for r in runs):
        fail("phase 19: a battery state is not finite")
    out = dict(card=card, nl_horizons=horizons, nl_steps=nl_steps,
               nl_configs=res_nl[min(res_nl)].n_configs,
               launches_nl=l_nl, lpv_steps=lpv_steps,
               lpv_configs=res_lpv.n_configs, launches_lpv=l_lpv,
               nl_feasible_share={N: float(r.feasible.mean())
                                  for N, r in res_nl.items()},
               lpv_feasible_share=float(res_lpv.feasible.mean()))
    print(f"phase 19: NL battery {out['nl_configs']} configs at N={horizons} "
          f"x {nl_steps} steps ({l_nl} launches); LPV battery "
          f"{out['lpv_configs']} configs x {lpv_steps} steps ({l_lpv} "
          f"launches) [{card}]", flush=True)
    return out


def gs_tradeoff(dev, card):
    """Phase 20: ``stress_study gs-tradeoff``: Jacobi against Gauss-Seidel
    over a batch of fleets sharing one gain set."""
    n, batch, steps = 20, 16, 8
    from colaborativempc_tpu_torch.planners import nl
    from colaborativempc_tpu_torch.scripts import stress_study
    rows, launches = run_counted(
        "phase 20 (gs-tradeoff)", lambda: stress_study.main(
            ["gs-tradeoff", "--n", str(n), "--batch", str(batch), "--steps",
             str(steps), "--reps", "1"]), nl)
    out = dict(card=card, rows=rows, launches=launches)
    print("phase 20: gs-tradeoff " + "; ".join(
        f"{r['study'].split('/')[1]}: {r['ocd_iters_mean']} OCD iterations, "
        f"{r['fleet_steps_per_s']} fleet-steps/s" for r in rows)
        + f" (B={batch}, N={n}, {launches} launches) [{card}]", flush=True)
    return out


LPV_B, LPV_STEPS = 256, 20
GLOO_LPV_STEPS, GLOO_NL_B, GLOO_NL_STEPS = 3, 16, 2
RANK_DEADLINE_S = 300.0


def record_diff(a, b):
    """Largest |difference| over the floating fields of two records (on
    any devices), and the number of integer or boolean elements that
    differ."""
    dx, n_int = 0.0, 0
    for x, y in zip(a, b):
        x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
        if x.is_floating_point():
            dx = max(dx, float((x.double() - y.double()).abs().max()))
        else:
            n_int += int((x != y).sum())
    return dx, n_int


def sharded_world_one(dev, card, lpv_ref, nl_ref):
    """Phase 21 (a): the LPV headline (phase 4's config and start) and the
    NL-OCD Monte-Carlo (phase 6's) through the sharded rollouts on a
    (1, 1) mesh over NCCL, each run once: launches equal to the epochs the
    solves ran, final states against phases 4 and 6 (bit for bit expected,
    held to TOL_ROLLOUT)."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from colaborativempc_tpu_torch.ops.admm import default_epoch_len
    from colaborativempc_tpu_torch.parallel import (
        gather_sharded, initialize_distributed, make_sharded_lpv_rollout,
        shard_fleet_state,
    )
    from colaborativempc_tpu_torch.scripts import monte_carlo
    cfg, track, state0 = fleet(dev, LPV_B)
    tmp = tempfile.mkdtemp()
    initialize_distributed(dev, init_method=f"file://{tmp}/rendezvous",
                           rank=0, world_size=1,
                           timeout=datetime.timedelta(minutes=5))
    out = {}
    try:
        if dist.get_backend() != "nccl":
            fail(f"phase 21 (a): backend {dist.get_backend()}, not nccl")
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("scen", "agent"))
        roll = make_sharded_lpv_rollout(track, cfg, mesh, LPV_STEPS)
        local = shard_fleet_state(state0, mesh)
        reset_launches()
        final, met = roll(local)
        torch.cuda.synchronize()
        el = cfg.solver.epoch_len or default_epoch_len(cfg.N)
        epochs = int((met.iterations.amax(dim=(1, 2)) // el).sum())
        check_epoch_launches("phase 21 (a) LPV", read_launches(), epochs)
        launches = read_launches()["epoch"]
        dx, n_int = record_diff(gather_sharded(final, mesh), lpv_ref)
        if not (dx <= TOL_ROLLOUT and n_int == 0):
            fail(f"phase 21 (a) LPV: final state vs phase 4 max |dx| {dx} "
                 f"(tol {TOL_ROLLOUT}), {n_int} integer entries differ")
        out["lpv"] = dict(
            card=card, fleets=LPV_B, steps=LPV_STEPS, mesh=[1, 1],
            backend="nccl", launches=launches, epochs=epochs,
            max_abs_diff_vs_phase4=dx, bit_identical=dx == 0.0)
        print(f"phase 21 (a): sharded LPV rollout on a (1, 1) NCCL mesh, "
              f"B={LPV_B} x {LPV_STEPS} steps: "
              f"epoch-kernel and epoch-data launches {launches} = epochs; "
              f"final state vs "
              f"phase 4 max |dx| {dx:.3g} (bit for bit: {dx == 0.0}) "
              f"[{card}]", flush=True)

        _, roll_nl, local_nl = monte_carlo.setup(
            "nl", scenarios=NL_B, agents=3, N=20, steps=NL_STEPS, device=dev,
            mesh=mesh)
        epochs_nl, restore = count_solver_epochs()
        reset_launches()
        try:
            fin_nl, met_nl = roll_nl(local_nl)
            torch.cuda.synchronize()
        finally:
            restore()
        launches_nl = read_launches()
        check_epoch_launches("phase 21 (a) NL", launches_nl, epochs_nl)
        dx_nl, n_int_nl = record_diff(gather_sharded(fin_nl, mesh), nl_ref)
        if not (dx_nl <= TOL_ROLLOUT and n_int_nl == 0):
            fail(f"phase 21 (a) NL: final state vs phase 6 max |dx| {dx_nl} "
                 f"(tol {TOL_ROLLOUT}), {n_int_nl} integer entries differ")
        out["nl"] = dict(
            card=card, fleets=NL_B, steps=NL_STEPS, mesh=[1, 1],
            backend="nccl", launches=launches_nl["epoch"], epochs=sum(epochs_nl),
            mean_ocd_iterations=float(met_nl.ocd_iterations.float().mean()),
            max_abs_diff_vs_phase6=dx_nl, bit_identical=dx_nl == 0.0)
        print(f"phase 21 (a): sharded NL-OCD rollout on a (1, 1) NCCL mesh, "
              f"B={NL_B} x {NL_STEPS} steps: mean OCD iterations "
              f"{out['nl']['mean_ocd_iterations']:.2f}, epoch-kernel and "
              f"epoch-data launches {launches_nl['epoch']} = epochs; final "
              f"state vs "
              f"phase 6 max |dx| {dx_nl:.3g} (bit for bit: {dx_nl == 0.0}) "
              f"[{card}]", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _gloo_card_rank(rank, world, rdv, case, device, fleets, steps):
    """One rank of phase 21 (b), sharing card 0 with its siblings over
    gloo (``device`` is ``cuda``): ``lpv``, the headline config with
    ``fleets`` fleets on a (2, 1) mesh, or ``nl_hp_opt`` (``fleets``
    fleets, hp_opt, Jacobi) on a (1, 3) mesh, one agent per rank, for
    ``steps`` steps. Returns the gathered final state, this rank's epoch
    launches and its solves' epochs."""
    import datetime
    from torch.distributed.device_mesh import init_device_mesh
    from colaborativempc_tpu_torch.ops.admm import default_epoch_len
    from colaborativempc_tpu_torch.parallel import (
        gather_sharded, initialize_distributed, make_sharded_lpv_rollout,
        shard_fleet_state,
    )
    from colaborativempc_tpu_torch.scripts import monte_carlo
    from colaborativempc_tpu_torch.utils import synchronize
    dev = initialize_distributed(device, init_method=rdv, rank=rank,
                                 world_size=world, backend="gloo",
                                 timeout=datetime.timedelta(minutes=4))
    reset_launches()
    if case == "lpv":
        mesh = init_device_mesh(dev.type, (2, 1),
                                mesh_dim_names=("scen", "agent"))
        cfg, track, state0 = fleet(dev, fleets)
        final, met = make_sharded_lpv_rollout(track, cfg, mesh, steps)(
            shard_fleet_state(state0, mesh))
        el = cfg.solver.epoch_len or default_epoch_len(cfg.N)
        epochs = int((met.iterations.amax(dim=(1, 2)) // el).sum())
        builds = {}
    else:
        mesh = init_device_mesh(dev.type, (1, 3),
                                mesh_dim_names=("scen", "agent"))
        _, roll, local = monte_carlo.setup(
            "nl", scenarios=fleets, agents=3, N=20, steps=steps, device=dev,
            coupling="hp_opt", mesh=mesh)
        counted, restore = count_solver_epochs()
        try:
            final, met = roll(local)
        finally:
            restore()
        epochs = sum(counted)
        builds = {"nl": len(counted)}
    final = gather_sharded(final, mesh)
    synchronize(dev)
    launches = read_launches()
    return dict(final=[t.cpu().numpy() for t in final],
                launches=launches["epoch"],
                launches_epoch_data=launches["epoch_data"],
                launches_nl_qp=launches["nl_qp"],
                launches_mpcc_qp=launches["mpcc_qp"], epochs=epochs,
                builds=builds)


def sharded_gloo_on_card(dev, card):
    """Phase 21 (b): real collectives on the one card: ranks that share
    card 0 over gloo (each its own process, with a deadline), the LPV
    headline split (2, 1) and an hp_opt NL batch split (1, 3), both at
    once, each against the single-process rollout from the same start."""
    from concurrent.futures import ThreadPoolExecutor
    from colaborativempc_tpu_torch.parallel.multihost import run_local_ranks
    from colaborativempc_tpu_torch.runtime import make_lpv_fleet_rollout
    from colaborativempc_tpu_torch.scripts import monte_carlo
    cfg, track, state0 = fleet(dev, LPV_B)
    ref_lpv, _ = make_lpv_fleet_rollout(track, cfg, GLOO_LPV_STEPS)(state0)
    _, roll, st = monte_carlo.setup(
        "nl", scenarios=GLOO_NL_B, agents=3, N=20, steps=GLOO_NL_STEPS,
        device=dev, coupling="hp_opt")
    ref_nl, _ = roll(st)
    cases = (("lpv", 2, [2, 1], ref_lpv, (LPV_B, GLOO_LPV_STEPS)),
             ("nl_hp_opt", 3, [1, 3], ref_nl, (GLOO_NL_B, GLOO_NL_STEPS)))
    out = {}
    tmp = tempfile.mkdtemp()
    try:
        # both cases' ranks run at once, each case its own process group
        with ThreadPoolExecutor(len(cases)) as pool:
            runs = {case: pool.submit(
                run_local_ranks, _gloo_card_rank, world,
                (f"file://{tmp}/rendezvous_{case}", case, dev.type) + size,
                timeout=RANK_DEADLINE_S)
                for case, world, _, _, size in cases}
        for case, world, mesh, ref, size in cases:
            try:
                ranks = runs[case].result()
            except RuntimeError as e:
                fail(f"phase 21 (b) {case}: {e}")
            for r, res in enumerate(ranks):
                check_epoch_launches(
                    f"phase 21 (b) {case} rank {r}",
                    dict(epoch=res["launches"],
                         epoch_data=res["launches_epoch_data"],
                         nl_qp=res["launches_nl_qp"],
                         mpcc_qp=res["launches_mpcc_qp"]),
                    res["epochs"], res["builds"])
            diffs = [record_diff(res["final"], ref) for res in ranks]
            dx = max(d for d, _ in diffs)
            n_int = max(n for _, n in diffs)
            if not (dx <= TOL_ROLLOUT and n_int == 0):
                fail(f"phase 21 (b) {case}: gathered final state vs the "
                     f"single-process rollout max |dx| {dx} (tol "
                     f"{TOL_ROLLOUT}), {n_int} integer entries differ")
            out[case] = dict(
                card=card, ranks=world, mesh=mesh, backend="gloo",
                fleets=size[0], steps=size[1],
                launches=sum(res["launches"] for res in ranks),
                launches_per_rank=[res["launches"] for res in ranks],
                max_abs_diff_vs_single_process=dx)
            print(f"phase 21 (b): {case} on a {tuple(mesh)} gloo mesh, "
                  f"{world} ranks sharing card 0: final state vs the "
                  f"single-process rollout max |dx| {dx:.3g} (tol "
                  f"{TOL_ROLLOUT}), epoch-kernel and epoch-data launches "
                  f"per rank {out[case]['launches_per_rank']} = epochs "
                  f"[{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# phase 22's fleets: (tag, held to float64 past TOL_ROLLOUT, monte_carlo.
# setup arguments); only LPV 32 agents, whose float32 loops part by ~1e-2
LARGE_FLEETS = (
    ("lpv_32_agents", True, dict(pipeline="lpv", scenarios=8, agents=32,
                                 N=20, steps=5)),
    ("nl_eu_10_agents", False, dict(pipeline="nl", scenarios=2, agents=10,
                                    N=20, steps=3, coupling="eu",
                                    sweep="jacobi")),
    ("nl_hp_opt_11_agents", False, dict(pipeline="nl", scenarios=2,
                                        agents=11, N=20, steps=3,
                                        coupling="hp_opt")),
)
# a fleet held to float64 whose card run is no nearer the CPU's float32
# plain path than TOL_ROLLOUT may lie at most this times as far from its
# float64 plain path as the float32 plain path does, in the mean over the
# scenarios of each one's max |dx| (``scripts/fleet_f64.py f64_ratios``;
# the max over the batch, which one scenario sets, read 0.68-1.59x over
# seeds 0-3 on the H100)
TOL_ROLLOUT_F64 = 1.5


def large_fleets(dev, card):
    """Phase 22: closed loops of fleets past the kernels' earlier limits
    (LPV 32 agents: 35 rows per stage; NL eu 10 agents: 9 neighbours; NL
    hp_opt 11 agents: 22 controls and 34 rows) on the card and on the CPU's
    plain twins from the same start: every state finite, on the card each
    kernel launched once per ADMM epoch and the NL build once per SQP
    build (none on the CPU), the feasible share and min_dist_exec of the
    card's run; the plans within TOL_ROLLOUT of the CPU's. For the fleet
    marked in LARGE_FLEETS, where they are not, the same loop runs on the
    CPU in float64 from the same start, and the card's plans may lie at
    most TOL_ROLLOUT_F64 times as far from it as the CPU's float32 plans
    do, in the mean over the scenarios: the kernels as accurate as the
    float32 plain path, in a loop that carries float32 rounding past
    TOL_ROLLOUT (LPV 32 agents: a solve an epoch apart in every
    scenario)."""
    from colaborativempc_tpu_torch.planners import lpv, nl
    from colaborativempc_tpu_torch.scripts import monte_carlo
    from colaborativempc_tpu_torch.scripts.fleet_f64 import (
        f64_ratios, float64_plans,
    )
    out = {}
    for tag, to_f64, kw in LARGE_FLEETS:
        planner = nl if kw["pipeline"] == "nl" else lpv
        runs = {}
        for name in ("cuda", "cpu"):
            cfg, rollout, st = monte_carlo.setup(device=torch.device(name),
                                                 **kw)
            epochs, restore = count_solver_epochs(planner)
            calls, restore_calls = watch_solver(
                planner, lambda qp, z0, kw_, sol: sol.iterations.cpu())
            reset_launches()
            try:
                fin, (xh, uh, m) = rollout(st)
            finally:
                restore_calls()
                restore()
            launches = read_launches()
            if not all_finite(list(fin) + [xh, uh] + list(m)):
                fail(f"phase 22 {tag} ({name}): a state is not finite")
            if name == "cuda":
                check_epoch_launches(f"phase 22 ({tag})", launches, epochs)
            elif any(launches.values()):
                fail(f"phase 22 {tag}: the CPU run launched kernels "
                     f"{launches}")
            runs[name] = (fin.x_pred.cpu(), m, calls, launches)
        (xg, mg, cg, lg), (xc, mc, cc, _) = runs["cuda"], runs["cpu"]
        B = xg.shape[0]
        differing = (sum(int((a != b).sum()) for a, b in zip(cg, cc))
                     if len(cg) == len(cc) else None)
        dx = float((xg - xc).abs().max())
        rec = dict(max_dx=dx, card=card, scenarios=B, agents=kw["agents"],
                   steps=kw["steps"], feasible_share=float(mg.feasible.float().mean()),
                   min_dist_exec=float(mg.min_dist_exec.min()),
                   solver_calls=len(cg), problem_solves_differing=differing,
                   launches=lg)
        held = f"within {TOL_ROLLOUT}"
        if not dx <= TOL_ROLLOUT and not to_f64:
            fail(f"phase 22 {tag}: max |dx| card vs CPU {dx} (tol "
                 f"{TOL_ROLLOUT})")
        if not dx <= TOL_ROLLOUT:
            x64 = float64_plans(kw["pipeline"], cfg, st, kw["steps"])
            rec.update(**f64_ratios(xg, xc, x64))
            if not rec["ratio_mean"] <= TOL_ROLLOUT_F64:
                fail(f"phase 22 {tag}: max |dx| card vs CPU {dx} (tol "
                     f"{TOL_ROLLOUT}); against the CPU in float64, the "
                     f"mean over scenarios of each one's max |dx|: the card "
                     f"{rec['card_vs_f64_mean']:.3g}, the CPU in float32 "
                     f"{rec['cpu_f32_vs_f64_mean']:.3g} (at most "
                     f"{TOL_ROLLOUT_F64}x)")
            held = (f"against float64, mean over scenarios, the card "
                    f"{rec['card_vs_f64_mean']:.3g}, the CPU's float32 "
                    f"{rec['cpu_f32_vs_f64_mean']:.3g}, ratio "
                    f"{rec['ratio_mean']:.3g}; max over the batch "
                    f"{rec['card_vs_f64']:.3g} and "
                    f"{rec['cpu_f32_vs_f64']:.3g}")
        out[tag] = rec
        print(f"phase 22: {tag} B={B} x {kw['steps']} steps: max |dx_pred| "
              f"card vs CPU {dx:.3g} ({held}; ADMM iterations differ in "
              f"{differing} problem solves), feasible share "
              f"{rec['feasible_share']:.4f}, min_dist_exec "
              f"{rec['min_dist_exec']:.4f} m, launches {lg} over {len(cg)} "
              f"solver calls [{card}]", flush=True)
    return out


# phase 22 (b): the fleet at the spill's own sizes, card only; its OCD loop
# cut to SPILL_FLEET_OCD_ITERATIONS per step (depth, not width: every
# solve is the fleet's full QP)
SPILL_FLEET = dict(pipeline="nl", scenarios=1, agents=36, N=125, steps=2,
                   coupling="hp_opt")
SPILL_FLEET_OCD_ITERATIONS = 3


def spill_fleet(dev, card):
    """Phase 22 (b): NL hp_opt 36 agents at N=125 (``SPILL_FLEET``: B=1, 2
    steps of SPILL_FLEET_OCD_ITERATIONS OCD iterations each), a fleet
    whose epoch kernel spills w, y and kff and whose epoch
    data spills its block's layout to global memory: every state finite,
    each kernel launched once per ADMM epoch and the NL build once per SQP
    build, the feasible share and min_dist_exec printed. The CPU's plain
    path cannot run this loop within the phase's time, so the loop's first
    QPs are held against the plain versions on the card instead, as phases
    3, 3c and 3d hold random QPs: the first SQP build (0 entries whose
    bits differ), the first stage QPs' epoch data (0 entries differing)
    and their first epoch (the epoch kernel at phase 3's tolerance, or the
    float64 rule, and the affine kernel)."""
    import dataclasses
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.planners import nl
    from colaborativempc_tpu_torch.runtime import make_nl_ocd_rollout
    from colaborativempc_tpu_torch.scripts import monte_carlo
    kw = SPILL_FLEET
    cfg, _, st = monte_carlo.setup(device=dev, **kw)
    cfg = dataclasses.replace(cfg, ocd=cfg.ocd._replace(
        max_it_ocd=SPILL_FLEET_OCD_ITERATIONS))
    rollout = make_nl_ocd_rollout(make_track(cfg.map_type, device=dev), cfg,
                                  kw["steps"])
    first = {}
    build = nl.build_nl_qp

    def first_build(*a, **k):
        qp = build(*a, **k)
        first.setdefault("build", (a, k, qp))
        return qp
    epochs, restore = count_solver_epochs(nl)
    calls, restore_calls = watch_solver(nl, lambda qp, z0, k, sol: (
        first.setdefault("qp", (qp, z0, k)), sol.iterations.max())[1])
    nl.build_nl_qp = first_build
    reset_launches()
    try:
        fin, (xh, uh, m) = rollout(st)
        torch.cuda.synchronize()
    finally:
        nl.build_nl_qp = build
        restore_calls()
        restore()
    launches = read_launches()
    if not all_finite(list(fin) + [xh, uh] + list(m)):
        fail("phase 22 spill fleet: a state is not finite")
    check_epoch_launches("phase 22 (NL hp_opt 36 agents N=125)", launches,
                         epochs)
    a, k, got = first["build"]
    ref = nl.build_nl_qp_plain(*a, **k)
    torch.cuda.synchronize()
    differing = sum(int(((g != r) & ~(g.isnan() & r.isnan())).sum())
                    for g, r in zip(qp_fields(got).values(),
                                    qp_fields(ref).values()))
    if differing:
        fail(f"phase 22 spill fleet: the first NL build differs from its "
             f"plain version in {differing} entries")
    qp, z0, skw = first["qp"]
    P, N, mr = qp.lo.shape
    nc = qp.dyn.G.shape[-1]
    rs = torch.broadcast_to(torch.as_tensor(
        skw.get("rho_scale0", 1.0), dtype=torch.float32, device=dev),
        (P, mr)).contiguous()
    data_rec = check_epoch_data(dev, "spill fleet first QPs", qp, rs, 1)
    w0 = torch.clamp(torch.zeros_like(qp.lo), qp.lo, qp.hi)
    epoch_rec = check_kernels(dev, N, reps=1, P=P, nc=nc, mr=mr,
                              plain_reps=(1, 1), f64_rule=True, inputs=(
                                  qp, rs, z0.contiguous(), w0,
                                  torch.zeros_like(qp.lo)))
    spilled = (epoch_rec["epoch"]["plan"]["spilled"],
               data_rec["plan"]["spilled"])
    if spilled != ("horizon", "block"):
        fail(f"phase 22 spill fleet: the kernels spilled {spilled}, not "
             "the epoch's horizon and the epoch data's block")
    rec = dict(card=card, agents=kw["agents"], N=kw["N"], steps=kw["steps"],
               scenarios=kw["scenarios"], feasible_share=float(m.feasible.float().mean()),
               min_dist_exec=float(m.min_dist_exec.min()),
               ocd_iterations=m.ocd_iterations.tolist(),
               solver_calls=len(calls), launches=launches,
               first_build_entries_differing=differing,
               first_epoch_data=data_rec, first_epoch={
                   k2: epoch_rec[k2] for k2 in ("epoch", "affine")},
               spilled=spilled)
    print(f"phase 22: NL hp_opt 36 agents N=125 B=1 x {kw['steps']} steps "
          f"on the card: finite, feasible share "
          f"{rec['feasible_share']:.4f}, min_dist_exec "
          f"{rec['min_dist_exec']:.4f} m, OCD iterations "
          f"{rec['ocd_iterations']}, launches {launches} over {len(calls)} "
          f"solver calls ({sum(epochs)} epochs); first build "
          f"{differing} entries differing, first epoch data "
          f"{data_rec['entries_differing']}, first epoch kernel err "
          f"{epoch_rec['epoch']['max_abs_err']:.3g} (spilled {spilled}) "
          f"[{card}]", flush=True)
    return rec


def bench_suite_on_card(dev, card):
    """Phase 23: the ported ``scripts/bench_suite.py`` on the card through
    its ``main``: the default rows (the JAX suite's seven), then
    ``--tiny``; each row printed on its own line by the script, and each
    must have ``feasible`` true."""
    from colaborativempc_tpu_torch.scripts import bench_suite
    out = {}
    for name, argv in (("default", []), ("tiny", ["--tiny"])):
        rows = bench_suite.main(argv)
        bad = [r["config"] for r in rows if not r["feasible"]]
        if bad or not rows:
            fail(f"phase 23 bench_suite {name}: rows not feasible: {bad}")
        out[name] = rows
    print(f"phase 23: bench_suite default ({len(out['default'])} rows) and "
          f"--tiny ({len(out['tiny'])}), every row feasible [{card}]",
          flush=True)
    return out


# phase 24: the oracle's bounds. tests/test_native.py's shapes keep its
# tolerances; a shape it does not hold is held to the larger of the floor
# and this times the CPU plain path's own distance from the oracle
TOL_ORACLE_FLOOR = 3e-3
TOL_ORACLE_CPU = 1.5


def oracle_lpv_inputs(dev, name):
    """Phase 24 (a)'s LPV cases on ``dev``: (track, N, dt, x0, x_lin,
    u_lin, neighbours (1, N+1, n_nb, 2) or None) of agent 0, the port's
    warm start of ``x0_database`` in float32."""
    from colaborativempc_tpu_torch.config import x0_database
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.utils.warmstart import initialise_agents
    track_name, agents, N, dt = {
        "oval_1_agent_n15": ("oval", 1, 15, 0.025),
        "highway_3_agents_n12": ("Highway", 3, 12, 0.025),
        "headline_n20": ("Highway", 3, 20, 0.02),
        "headline_n125": ("Highway", 3, 125, 0.02),
        "lpv_197_agents_n125": ("Highway", 197, 125, 0.02)}[name]
    track = make_track(track_name, device=dev)
    x0s = torch.tensor(x0_database(agents), dtype=torch.float32, device=dev)
    agents_xy, x_pred, u_pred = initialise_agents(track, x0s, N, dt)
    neigh = agents_xy[None, :, 1:] if agents > 1 else None
    return track, N, dt, x_pred[:1, 0], x_pred[:1], u_pred[:1], neigh


def oracle_nl_inputs(dev, N):
    """Phase 24 (b)'s NL case: ego agent 1 of 3 on the Highway (master
    towards 2, slave towards 0, prices 0.3), dt 0.02."""
    from colaborativempc_tpu_torch.config import x0_database
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.utils.warmstart import initialise_agents
    track = make_track("Highway", device=dev)
    x0s = torch.tensor(x0_database(3), dtype=torch.float32, device=dev)
    agents_xy, x_pred, u_pred = initialise_agents(track, x0s, N, 0.02)
    neigh = agents_xy[:, [0, 2], :]
    lam = torch.full((1, 2, N), 0.3, device=dev)
    master = torch.tensor([[0.0, 1.0]], device=dev)
    return track, x_pred[1:2], u_pred[1:2], neigh, lam, master


def oracle_distance(sol, x_nat, u_nat):
    return (float(np.abs(sol.x_pred[0].double().cpu().numpy()
                         - x_nat).max()),
            float(np.abs(sol.u_pred[0].double().cpu().numpy()
                         - u_nat).max()))


def native_oracle(dev, card):
    """Phase 24: the card's LPV, NL, MPCC and safety-filter results
    against the float64 C++ twin (``colaborativempc_tpu_torch.native``),
    one case at a time; see the module docstring."""
    from colaborativempc_tpu_torch import native
    from colaborativempc_tpu_torch.config import (
        ModelParams, SysLimits, lpv_gains, nl_gains,
    )
    from colaborativempc_tpu_torch.dynamics.pacejka import PacejkaParams
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.planners import lpv, mpcc, nl
    from colaborativempc_tpu_torch.planners.mpcc import (
        MPCCBounds, MPCCConfig, MPCCGains,
    )
    from colaborativempc_tpu_torch.runtime.racing import run_mpcc_experiment
    from colaborativempc_tpu_torch.runtime.simulate import _sep_filter_beta
    t0 = time.perf_counter()
    lib_path = native.build()
    build_s = time.perf_counter() - t0
    native.load()
    print(f"phase 24: native library {lib_path} ({native.compiler()} "
          f"{' '.join(native.CXX_FLAGS)}, {build_s:.2f} s)", flush=True)
    cpu = torch.device("cpu")
    gl, lim, mp = lpv_gains(), SysLimits(), ModelParams()
    out = {"cases": {}, "launches": {}}
    lpv_kw = dict(admm_iters=600, eps=1e-6)
    gn = nl_gains()
    nl_kw = {"nl_eu_test_n12": (12, dict(sqp_iters=2, admm_iters=400)),
             "nl_eu_headline_n20": (20, dict(sqp_iters=3, admm_iters=300))}

    def lpv_on(dev_, tag):
        track, N, dt, x0, xl, ul, nb = oracle_lpv_inputs(dev_, tag)
        return lpv.lpv_solve(track, gl, lim, mp, N, dt, x0, xl, ul,
                             torch.zeros_like(x0[:, :2]), nb, **lpv_kw)

    def nl_on(dev_, tag):
        N, kw = nl_kw[tag]
        track, xb, ub, nb, lam, master = oracle_nl_inputs(dev_, N)
        return nl.nl_solve(track, gn, lim, mp, N, 0.02, xb[:, 0], xb, ub,
                           torch.zeros_like(xb[:, 0, :2]), lam, nb[None],
                           master, sqp_mix=0.7, eps=1e-6, **kw)

    # the CPU plain path's solves of the shapes held by the rule, in a
    # thread of their own while the card's cases run
    pool = concurrent.futures.ThreadPoolExecutor(1)
    on_cpu = {tag: pool.submit(lpv_on, cpu, tag) for tag in (
        "headline_n20", "headline_n125", "lpv_197_agents_n125")}
    on_cpu["nl_eu_headline_n20"] = pool.submit(nl_on, cpu,
                                               "nl_eu_headline_n20")
    pool.shutdown(wait=False)

    def oracle_case(tag, ok, sol, x_nat, u_nat, bounds, launches,
                    native_its=None):
        """Hold one solve on the card: feasible on both sides, its max
        |dx_pred| and |du_pred| from the oracle within ``bounds`` (None:
        not held) or, where ``bounds`` is None, within the larger of the
        floor and TOL_ORACLE_CPU times the CPU plain path's own. The ADMM
        iterations of the card, the CPU and the oracle (``native_its``)
        are printed (NL and MPCC: summed over the SQP iterations)."""
        if not (ok and bool(sol.feasible[0])):
            fail(f"phase 24 {tag}: infeasible (native {ok}, card "
                 f"{bool(sol.feasible[0])})")
        cpu_dist, cpu_txt, cpu_its = (None, None), "", None
        its = int(sol.iterations[0])
        if bounds is None:
            sol_cpu = on_cpu[tag].result()
            cpu_its = int(sol_cpu.iterations[0])
            cpu_dist = oracle_distance(sol_cpu, x_nat, u_nat)
            bounds = tuple(max(TOL_ORACLE_FLOOR, TOL_ORACLE_CPU * d)
                           for d in cpu_dist)
            cpu_txt = (f"; CPU plain path {cpu_dist[0]:.3e} / "
                       f"{cpu_dist[1]:.3e}, {cpu_its} iterations")
        dist = oracle_distance(sol, x_nat, u_nat)
        for what, d, b in zip(("x", "u"), dist, bounds):
            if b is not None and not d <= b:
                fail(f"phase 24 {tag}: max |d{what}_pred| from the oracle "
                     f"{d:.3e} above its bound {b:.3e}")
        out["launches"][tag] = launches
        out["cases"][tag] = dict(
            dx=dist[0], du=dist[1], bound_x=bounds[0], bound_u=bounds[1],
            cpu_dx=cpu_dist[0], cpu_du=cpu_dist[1], epoch_launches=launches,
            iterations=its, cpu_iterations=cpu_its,
            native_iterations=native_its)
        shown = " / ".join("not held" if b is None else f"{b:.3e}"
                           for b in bounds)
        print(f"phase 24 {tag}: card max |dx_pred| {dist[0]:.3e} |du_pred| "
              f"{dist[1]:.3e} from the oracle (bounds {shown}), {its} "
              f"iterations{cpu_txt}"
              + ("" if native_its is None else
                 f"; oracle {native_its} iterations")
              + f"; epoch launches {launches} [{card}]", flush=True)

    # (a) LPV
    for tag, bounds in (("oval_1_agent_n15", (3e-3, 3e-3)),
                        ("highway_3_agents_n12", (5e-3, None)),
                        ("headline_n20", None), ("headline_n125", None),
                        ("lpv_197_agents_n125", None)):
        track, N, dt, x0, xl, ul, nb = oracle_lpv_inputs(dev, tag)
        ok, x_nat, u_nat, res_nat = native.lpv_solve_native(
            track, gl, lim, mp, N, dt, x0[0], xl[0], ul[0], np.zeros(2),
            neighbours_xy=None if nb is None else nb[0])
        sol, launches = run_counted(f"phase 24 {tag}",
                                    lambda: lpv_on(dev, tag), lpv)
        oracle_case(tag, ok, sol, x_nat, u_nat, bounds, launches,
                    int(res_nat[2]))
        if tag == "lpv_197_agents_n125":
            from colaborativempc_tpu_torch.ops import cuda_lqr
            plan = cuda_lqr.kernel_plan(1, N, 11, 2, 4 + nb.shape[2])
            if not plan.spilled:
                fail("phase 24: the 197-agent epoch launch did not spill")
            out["cases"][tag]["plan"] = plan._asdict()

    # (b) NL eu
    for tag, bounds in (("nl_eu_test_n12", (1e-2, 1e-2)),
                        ("nl_eu_headline_n20", None)):
        N, kw = nl_kw[tag]
        track, xb, ub, nb, lam, master = oracle_nl_inputs(dev, N)
        ok, x_nat, u_nat, _ = native.nl_solve_native(
            track, gn, lim, mp, N, 0.02, xb[0, 0], xb[0], ub[0],
            np.zeros(2), lam[0], nb[1:], master[0].to(torch.int32),
            mix=0.7, **kw)
        sol, launches = run_counted(f"phase 24 {tag}",
                                    lambda: nl_on(dev, tag), nl)
        oracle_case(tag, ok, sol, x_nat, u_nat, bounds, launches)

    # (c) MPCC: one SQP solve, then the closed-loop race
    track = make_track("oval_mt", device=dev)
    g, b, p = MPCCGains(), MPCCBounds(), PacejkaParams()
    N, dt = 16, 0.05
    x = torch.zeros((1, 9), device=dev)
    x[:, 0] = 0.6
    x_bar = x[:, None].repeat(1, N + 1, 1)
    x_bar[..., 6] = torch.arange(N + 1, dtype=torch.float32,
                                 device=dev) * (0.6 * dt)
    u_bar = torch.zeros((1, N, 2), device=dev)
    u_bar[..., 1] = 0.25
    u_old = torch.zeros((1, 2), device=dev)
    ok, x_nat, u_nat, _ = native.mpcc_solve_native(
        track, g, b, p, N, dt, x[0], x_bar[0], u_bar[0], u_old[0],
        sqp_iters=3, mix=0.7, admm_iters=300)
    sol, launches = run_counted(
        "phase 24 mpcc_solve_n16", lambda: mpcc.mpcc_solve(
            track, g, p, N, dt, x, x_bar, u_bar, u_old, sqp_iters=3,
            sqp_mix=0.7, admm_iters=300, bounds=b, norm=None), mpcc)
    oracle_case("mpcc_solve_n16", ok, sol, x_nat, u_nat, (5e-3, 5e-3),
                launches)
    steps = 50
    cfg = MPCCConfig(N=N, dt=dt, n_sim=steps, map_type="oval_mt",
                     initial_velocity=0.5, verb=0)
    res, launches = run_counted(
        "phase 24 mpcc_race", lambda: run_mpcc_experiment(
            cfg, track=track, device=dev), mpcc)
    t, xs, _, feas = native.mpcc_race_native(
        track, g, b, p, N=N, dt=dt, steps=steps, v0=0.5, n_sqp=cfg.n_sqp,
        mix=cfg.sqp_mixing, admm_iters=300)
    s_card, s_nat = float(res.states[-1, 6]), float(xs[-1, 6])
    if not (t == steps == res.steps and feas.all()
            and res.feasible.all()):
        fail(f"phase 24 mpcc_race: steps {res.steps} (native {t}) or a "
             f"step infeasible (card {int(res.feasible.sum())}, native "
             f"{int(feas.sum())} feasible)")
    progress = abs(s_card - s_nat) / max(s_card, 1.0)
    if not progress < 0.02:
        fail(f"phase 24 mpcc_race: final s {s_card:.4f} m on the card, "
             f"{s_nat:.4f} m native ({progress:.2%} apart, bound 2%)")
    out["launches"]["mpcc_race"] = launches
    out["cases"]["mpcc_race_n16"] = dict(
        steps=steps, s_card=s_card, s_native=s_nat, progress_rel=progress,
        bound_rel=0.02, max_abs_ds=float(np.abs(res.states[:, 6]
                                                - xs[:, 6]).max()),
        epoch_launches=launches)
    print(f"phase 24 mpcc_race_n16: {steps} steps, every step feasible on "
          f"both; final s {s_card:.4f} m card, {s_nat:.4f} m native "
          f"({progress:.3%} apart, bound 2%); max |ds| over the race "
          f"{out['cases']['mpcc_race_n16']['max_abs_ds']:.3e} m; epoch "
          f"launches {launches} [{card}]", flush=True)

    # (d) the safety filter
    rng = np.random.default_rng(11)
    floor = 0.175
    worst = 0.0
    for _ in range(100):
        n = int(rng.integers(2, 6))
        p0 = rng.uniform(-2.0, 2.0, (n, 2))
        p1 = p0 + rng.uniform(-0.2, 0.2, (n, 2))
        prio = rng.uniform(0.0, 30.0, n)
        b_nat = native.sep_filter_native(p0, p1, prio, floor)
        b_card = _sep_filter_beta(
            torch.tensor(p0, dtype=torch.float32, device=dev),
            torch.tensor(p1, dtype=torch.float32, device=dev),
            torch.tensor(floor, dtype=torch.float32, device=dev),
            prio=torch.tensor(prio, dtype=torch.float32, device=dev))
        worst = max(worst, float(np.abs(b_card.double().cpu().numpy()
                                        - b_nat).max()))
    if not worst <= 2e-3:
        fail(f"phase 24 sep_filter: max |dbeta| {worst:.3e} above 2e-3")
    out["cases"]["sep_filter_100_fleets"] = dict(dbeta=worst, bound=2e-3)
    print(f"phase 24 sep_filter: 100 fleets of 2-5 agents, max |dbeta| "
          f"{worst:.3e} from the oracle (bound 2e-3) [{card}]", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    secs = {}
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    from colaborativempc_tpu_torch.ops import _build
    from colaborativempc_tpu_torch.ops.admm import default_epoch_len
    from colaborativempc_tpu_torch.runtime import make_lpv_fleet_rollout

    # phase 2: build
    info = _build.build()
    _build.load()
    secs["phase 2"] = time.perf_counter() - t_start
    print(f"phase 2: kernels built in {info['seconds']:.2f} s "
          f"(built={info['built']}) -> {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or line.startswith("==")):
            print("  ptxas:", line.strip())

    # phase 3: kernels vs plain twins
    t_phase = time.perf_counter()
    k20 = check_kernels(dev, HEADLINE["N"], reps=20)
    k125 = check_kernels(dev, 125, reps=5)
    k125_resident = check_kernels(dev, 125, reps=2, ring=125)
    k7 = check_kernels(dev, HEADLINE["N"], reps=10, P=7, qps_per_block=4)
    if not (k125["epoch"]["plan"]["ring"] < 125
            and 7 % k7["epoch"]["plan"]["qps_per_block"] != 0):
        fail("phase 3 did not reach a streamed ring and a ragged block")
    kwide = {tag: check_kernels(dev, N, reps=5, P=P, nc=nc, mr=mr)
             for tag, P, N, nc, mr in WIDE_SHAPES}
    kspill = {tag: check_kernels(dev, N, reps=2, P=P, nc=nc, mr=mr,
                                 plain_reps=(1, 1), f64_rule=True)
              for tag, P, N, nc, mr in SPILL_SHAPES}
    if {r["epoch"]["plan"]["spilled"] for r in kspill.values()} != {
            "horizon", "horizon+ring"}:
        fail("phase 3 did not reach both spill levels of the epoch kernel")
    # phase 3b: the epoch kernel on the NL planner's QPs
    knl = {c: check_nl_epoch(dev, c, reps=10) for c in ("eu", "hp_opt")}
    knl["hp_opt_resident"] = check_nl_epoch(dev, "hp_opt", reps=10,
                                            ring=HEADLINE["N"])
    # phase 3c: the epoch-data kernel vs its plain version
    print(f"phase 3c: torch {torch.__version__}, CUDA {torch.version.cuda} "
          "(the plain version's order of operations is the card libraries' "
          "of this build)", flush=True)
    qp7, rs7 = k7["qp"]
    inactive = torch.zeros_like(qp7.lo, dtype=torch.bool)
    inactive[:, ::3, 2] = True         # row 2 unbounded at every 3rd stage
    qp7 = qp7._replace(lo=qp7.lo.masked_fill(inactive, -torch.inf),
                       hi=qp7.hi.masked_fill(inactive, torch.inf))
    kdata = {"headline": check_epoch_data(dev, "headline", *k20["qp"], 20),
             "n125": check_epoch_data(dev, "n125", *k125["qp"], 5),
             "p7_inactive_rows": check_epoch_data(dev, "p7 inactive rows",
                                                  qp7, rs7, 10)}
    for c in ("eu", "hp_opt"):
        kdata[f"nl_{c}"] = check_epoch_data(dev, f"nl {c}", *knl[c]["qp"],
                                            10)
    for P, N in ((18, BAT_N), (1, MPCC_N)):
        kdata[f"mpcc_p{P}_n{N}"] = check_epoch_data(
            dev, f"mpcc P={P} N={N}", mpcc_qps(dev, P, N)[0], 1.0, 10)
    for tag, r in kwide.items():
        kdata[tag] = check_epoch_data(dev, tag, *r["qp"], 5)
    for tag, P, N, nc, mr in WIDE_DATA_SHAPES:
        kdata[tag] = check_epoch_data(
            dev, tag, *random_qp(dev, P, N, nc, mr, 2000 + N + nc)[:2], 3)
    for tag, P, N, nc, mr in SPILL_DATA_SHAPES:
        kdata[f"spill_{tag}"] = check_epoch_data(
            dev, f"spill_{tag}",
            *random_qp(dev, P, N, nc, mr, 3000 + N + nc)[:2], 2)
        if kdata[f"spill_{tag}"]["plan"]["spilled"] != "block":
            fail(f"phase 3c {tag}: the epoch data did not spill")
    # phase 3d: the SQP build kernels vs their plain versions
    ksqp = check_sqp_builds(dev)

    # phase 4: the main path
    B, STEPS = LPV_B, LPV_STEPS
    cfg, track, state0 = fleet(dev, B)
    rollout = make_lpv_fleet_rollout(track, cfg, STEPS)
    reset_launches()
    final, (xh, uh, met) = rollout(state0)
    torch.cuda.synchronize()
    launches = read_launches()
    if not all_finite(list(final) + [xh, uh]):
        fail("main path: a state is not finite")
    el = cfg.solver.epoch_len or default_epoch_len(cfg.N)
    # per step the solve runs as many epochs as its slowest problem
    expected = int((met.iterations.amax(dim=(0, 2)) // el).sum())
    check_epoch_launches("phase 4 (LPV main path)", launches, expected)
    feas = float(met.feasible.float().mean())
    mean_it = float(met.iterations.float().mean())
    min_exec = float(met.min_dist_exec.min())
    print(f"phase 4: LPV B={B} x {STEPS} steps: feasible share "
          f"{feas:.4f}, mean ADMM iterations "
          f"{mean_it:.2f}, min_dist_exec {min_exec:.4f} m, epoch-kernel "
          f"launches {launches['epoch']} ({launches['epoch'] / STEPS:.2f} "
          f"per step), epoch-data kernel launches {launches['epoch_data']} "
          f"[{card}]", flush=True)

    secs["phases 3-4"] = time.perf_counter() - t_phase
    print(f"phases 3-4 took {secs['phases 3-4']:.1f} s", flush=True)

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        secs[name] = time.perf_counter() - t0
        print(f"{name} took {secs[name]:.1f} s", flush=True)
        return out

    # phase 5: end to end, kernel vs plain twins on the CPU
    phase5 = timed("phase 5", rollout_iterations_agree, dev)

    nl_path, nl_final = timed("phase 6", nl_main_path, dev, card)
    phase7 = timed("phase 7", nl_end_to_end, dev)
    single = timed("phase 8", nl_single_fleet, dev, card)
    race = timed("phase 10", mpcc_race, dev, card)
    bat = timed("phase 11", mpcc_battery, dev, card)
    phase12 = timed("phase 12", mpcc_kernel_vs_plain, dev)
    kmpcc = timed("phase 13", lambda: {
        "mpcc_p18_n20": check_mpcc_epoch(dev, 18, BAT_N, reps=10),
        "mpcc_p1_n60": check_mpcc_epoch(dev, 1, MPCC_N, reps=10)})
    phase14 = timed("phase 14", assoc_on_card, dev, card)
    lpv125 = timed("phase 15", lpv_long_horizon, dev, card)
    lanes = timed("phase 16", dynamic_lanes, dev, card)
    cli = timed("phase 17", lpv_cli, dev, card)
    stress = timed("phase 18", stress_full_width, dev, card)
    bats = timed("phase 19", batteries, dev, card)
    gs = timed("phase 20", gs_tradeoff, dev, card)
    sharded = timed("phase 21 (a)", sharded_world_one, dev, card, final,
                    nl_final)
    gloo = timed("phase 21 (b)", sharded_gloo_on_card, dev, card)
    large = timed("phase 22", large_fleets, dev, card)
    large["nl_hp_opt_36_agents_n125"] = timed("phase 22 (b)", spill_fleet,
                                              dev, card)
    suite = timed("phase 23", bench_suite_on_card, dev, card)
    oracle = timed("phase 24", native_oracle, dev, card)
    secs["total"] = time.perf_counter() - t_start
    print(f"chip_smoke phases took {secs['total']:.1f} s", flush=True)

    src = "colaborativempc_tpu_torch/csrc/lqr_kernels.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "roofline_share",
            "max_abs_err", "plan")

    def shapes(name, **runs):
        return {tag: {k: r[name][k] for k in keys} if name in r
                else {k: r[k] for k in keys} for tag, r in runs.items()}
    kernels = [
        dict(name="admm_epoch_batched", route="cuda", source=src,
             replaces="colaborativempc_tpu/ops/pallas_lqr.py:88",
             max_abs_err=k20["epoch"]["max_abs_err"],
             max_abs_err_resid=k20["epoch"]["max_abs_err_resid"],
             ms=k20["epoch"]["ms"], plain_ms=k20["epoch"]["plain_ms"],
             bound_ms=k20["epoch"]["bound_ms"],
             bound_by=k20["epoch"]["bound_by"],
             roofline_share=k20["epoch"]["roofline_share"],
             library_ms=None, plan=k20["epoch"]["plan"],
             shapes=shapes("epoch", n125=k125, n125_resident=k125_resident,
                           p7=k7,
                           **{f"nl_{c}": r for c, r in knl.items()},
                           **kmpcc, **kwide, **kspill)),
        dict(name="lqr_affine_solve_batched", route="cuda", source=src,
             replaces="colaborativempc_tpu/ops/pallas_lqr.py:40",
             on_main_path=False,
             max_abs_err=k20["affine"]["max_abs_err"],
             ms=k20["affine"]["ms"], plain_ms=k20["affine"]["plain_ms"],
             bound_ms=k20["affine"]["bound_ms"],
             bound_by=k20["affine"]["bound_by"],
             roofline_share=k20["affine"]["roofline_share"],
             library_ms=None, plan=k20["affine"]["plan"],
             shapes=shapes("affine", n125=k125,
                           n125_resident=k125_resident, p7=k7, **kwide,
                           **kspill)),
        dict(name="epoch_data_batched", route="cuda",
             source="colaborativempc_tpu_torch/csrc/epoch_data.cu",
             replaces=("colaborativempc_tpu/ops/admm.py:159 "
                       "(admm_epoch_inputs: XLA, not Pallas)"),
             max_abs_err=kdata["headline"]["max_abs_err"],
             max_rel_err=kdata["headline"]["max_rel_err"],
             ms=kdata["headline"]["ms"],
             plain_ms=kdata["headline"]["plain_ms"],
             bound_ms=kdata["headline"]["bound_ms"],
             bound_by=kdata["headline"]["bound_by"],
             roofline_share=kdata["headline"]["roofline_share"],
             max_rel_err_vs_f64=kdata["headline"]["max_rel_err_vs_f64"],
             plain_max_rel_err_vs_f64=kdata["headline"][
                 "plain_max_rel_err_vs_f64"],
             library_ms=None, plan=kdata["headline"]["plan"],
             host_us=kdata["headline"]["host_us"],
             torch_version=torch.__version__, cuda_version=torch.version.cuda,
             shapes={tag: {k: r[k] for k in keys + (
                 "max_rel_err", "max_rel_err_vs_f64",
                 "plain_max_rel_err_vs_f64", "compared_as_batch", "host_us")}
                     for tag, r in kdata.items() if tag != "headline"}),
    ]
    sqp_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "roofline_share",
                "max_abs_err", "max_rel_err", "entries_differing",
                "max_rel_err_vs_f64", "plain_max_rel_err_vs_f64",
                "compared_as_batch", "matvec_order", "host_us")
    for fam, name, head, replaces in (
            ("nl", "nl_qp_batched", "nl eu",
             "colaborativempc_tpu/planners/nl.py:80-94 _linearize_horizon, "
             ":97 build_nl_qp (XLA, not Pallas)"),
            ("mpcc", "mpcc_qp_batched", "mpcc P=1 N=60",
             "colaborativempc_tpu/planners/mpcc.py:132 build_mpcc_qp, "
             "dynamics/pacejka.py:110 linearize_pacejka, mpcc.py:215-221 "
             "(XLA, not Pallas)")):
        r = ksqp[head]
        kernels.append(dict(
            name=name, route="cuda",
            source="colaborativempc_tpu_torch/csrc/sqp_qp.cu",
            replaces=replaces, library_ms=None,
            **{k: r[k] for k in sqp_keys},
            shapes={tag: {k: v[k] for k in sqp_keys}
                    for tag, v in ksqp.items()
                    if tag.startswith(fam) and tag != head}))
    print(json.dumps({"main_path": {
        "card": card, "feasible_share": feas, "mean_admm_iterations": mean_it,
        "min_dist_exec": min_exec}}))
    print(json.dumps({"nl_main_path": {
        k: v for k, v in nl_path.items() if k != "launches"},
        "nl_single_fleet": single, "phase5": phase5, "phase7": phase7}))
    print(json.dumps({"mpcc_race": race, "mpcc_battery": bat,
                      "phase12": phase12, "phase14": phase14,
                      "lpv_n125": lpv125, "dynamic_lanes": lanes}))
    print(json.dumps({"lpv_cli": cli, "stress": stress, "batteries": bats,
                      "gs_tradeoff": gs}))
    print(json.dumps({"sharded_nccl": sharded, "sharded_gloo": gloo,
                      "large_fleets": large, "bench_suite": suite,
                      "native_oracle": oracle, "phase_seconds": secs}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
