"""Split the SQP build kernels' time (``csrc/sqp_qp.cu``: ``cmpc_nl_qp``,
``cmpc_mpcc_qp``) into intervals, and their wrappers' host time into
functions (card only).

The kernels are built a second time with ``-DCMPC_SQP_QP_CLOCKS``
(``ops/_build.py load_sqp_qp_clocks``, a library of its own; the port runs
the default build, which has no stamps). That build stamps ``clock64()``
at each of a block's barriers, so a block's time falls into four
intervals (``cmpc_sqp_qp_clock_names``): the slots and the staged inputs
(the per-problem numbers, the stage inputs and the lane's track rows in
shared memory), the Jacobian rows and the pairs, the image rows (every
output field of the block's stages built in shared memory) and the
bounds with the copy out. Each stamp holds thread 0's clock and the clock
of the block's last warp to get there; an interval is the last warp's
arrival at its stamp less its arrival at the stamp before
(``scripts/clock_split.py split``). This script prints, per shape, the
mean cycles of each interval kind, the cycles per stage, the blocks that
ran at once on one SM, the launch's wall time, the kernel's time in the
default and the clocked build (CUDA events, a spin kernel queued ahead)
and whether the two builds give the same bits; each kernel's ptxas line
(registers, stack frame, spills) of both builds; the build wrappers' host
microseconds per call (``build_nl_qp`` / ``build_mpcc_qp`` on the card,
queued without a synchronise) and where a call's host time goes
(``cProfile``, the functions with the most time of their own):

    python -m colaborativempc_tpu_torch.scripts.sqp_qp_split

``--source`` splits another copy of ``sqp_qp.cu`` that exports the same
clocked entries (for instance a variant under a directory that
``.gitignore`` lists).
``--parent DIR`` takes another checkout of the repo (for instance an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists) and times its ``build_nl_qp`` / ``build_mpcc_qp``
on the card against this tree's in turns (it, this, this, it), each of its
turns in a process of its own (``scripts/clock_split.py turns``), with the
entries whose bits differ and the host microseconds per call of both:

    python -m colaborativempc_tpu_torch.scripts.sqp_qp_split \\
        --parent _scratch/parent

The shapes are ``chip_smoke.py`` phase 3d's (:data:`SHAPES`): the NL
Monte-Carlo's 192 QPs for each coupling, one fleet at N=125, per-problem
lanes, the branch edges with a NaN, either side of each boundary of the
batched matrix-vector order, hp_opt at 4, 5 and 9 agents; the MPCC race,
the battery and the slip floor's edges; a build of each family on a
fitted track of 3000 segments, more than the kernels stage; the large
fleets (eu 10 agents, hp_opt 11, 16 and 32). Against a checkout that
predates the large fleets, ``--shapes`` names the others. The inputs are
:func:`nl_build_args` / :func:`mpcc_build_args`, from a seed.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import re
import sys

import numpy as np
import torch

from colaborativempc_tpu_torch.scripts.clock_split import (
    card, differing, event_ms, host_us, print_split, split, turns,
)

# name: (family, problems, agents per fleet or 0, N, options)
SHAPES = {
    "nl_eu": ("nl", 192, 3, 20, {}),
    "nl_hp": ("nl", 192, 3, 20, dict(coupling="hp")),
    "nl_hp_opt": ("nl", 192, 3, 20, dict(coupling="hp_opt")),
    "nl_eu_n125": ("nl", 3, 3, 125, {}),
    "nl_eu_oval2_lanes": ("nl", 48, 3, 20, dict(map_type="Oval2",
                                                 lanes=True)),
    "nl_eu_edges": ("nl", 6, 3, 20, dict(edges=True)),
    "nl_hp_opt_edges": ("nl", 6, 3, 20, dict(coupling="hp_opt",
                                             edges=True)),
    # either side of the row layout's order boundaries at 12,997 / 12,998
    # and 37,292 / 37,293 products
    "nl_eu_p649": ("nl", 649, 3, 20, {}),
    "nl_eu_p650": ("nl", 650, 3, 20, {}),
    "nl_eu_p1864": ("nl", 1864, 3, 20, {}),
    "nl_eu_p1865": ("nl", 1865, 3, 20, {}),
    # hp_opt with 3, 4 and 8 neighbours (nc = 8, 10, 18; m = 13, 16, 28)
    "nl_hp_opt_4_agents": ("nl", 256, 4, 20, dict(coupling="hp_opt")),
    "nl_hp_opt_5_agents": ("nl", 320, 5, 20, dict(coupling="hp_opt")),
    "nl_hp_opt_9_agents": ("nl", 144, 9, 20, dict(coupling="hp_opt")),
    # a track of more segments than the kernels stage in shared memory
    "nl_eu_3000_segments": ("nl", 48, 3, 20, dict(segments=3000)),
    # large fleets: 9 neighbours (eu), 10 and 15 (hp_opt), 31 (hp_opt at 4
    # stages per block); a checkout that predates them cannot build them,
    # so turns against one name the other shapes (--shapes)
    "nl_eu_10_agents": ("nl", 20, 10, 20, {}),
    "nl_hp_opt_11_agents": ("nl", 22, 11, 20, dict(coupling="hp_opt")),
    "nl_hp_opt_16_agents": ("nl", 32, 16, 20, dict(coupling="hp_opt")),
    "nl_hp_opt_32_agents": ("nl", 64, 32, 20, dict(coupling="hp_opt")),
    "mpcc_p1_n60": ("mpcc", 1, 0, 60, {}),
    "mpcc_p18_n20": ("mpcc", 18, 0, 20, {}),
    "mpcc_edges": ("mpcc", 2, 0, 20, dict(edges=True)),
    # either side of the column layout's boundaries at 189 / 190, 1,335 /
    # 1,336 and 2,852 / 2,853 products
    "mpcc_p9": ("mpcc", 9, 0, 20, {}),
    "mpcc_p10": ("mpcc", 10, 0, 20, {}),
    "mpcc_p66": ("mpcc", 66, 0, 20, {}),
    "mpcc_p67": ("mpcc", 67, 0, 20, {}),
    "mpcc_p142": ("mpcc", 142, 0, 20, {}),
    "mpcc_p143": ("mpcc", 143, 0, 20, {}),
    "mpcc_3000_segments": ("mpcc", 18, 0, 20, dict(segments=3000)),
}
# the shapes whose wrapper host time is split into functions
PROFILED = ("nl_eu", "mpcc_p1_n60")


def fitted_track(track, segments: int):
    """Lane 0 of ``track`` refitted by ``geometry/spline.py
    fit_centerline`` into ``segments`` segments of equal length, as a
    user's measured centerline is: the track a build takes where it has
    more segments than the kernels stage in shared memory
    (``cuda_sqp.MAX_STAGED_SEGMENTS``)."""
    from colaborativempc_tpu_torch.geometry.frenet import frenet_to_cartesian
    from colaborativempc_tpu_torch.geometry.spline import fit_centerline
    closed = not bool(track.open_flag)
    L = float(track.track_length[0])
    s = np.linspace(0.0, L, 2 * segments, endpoint=False)  # s = L wraps
    x, y, _ = frenet_to_cartesian(
        track, torch.tensor(s, dtype=track.s0.dtype, device=track.s0.device),
        0.0)
    return fit_centerline(x.cpu().numpy(), y.cpu().numpy(),
                          halfwidth=float(track.halfwidth[0, 0]),
                          closed=closed, n_segments=segments,
                          slack=float(track.slack), clean=False, smooth=0.0,
                          device=track.s0.device)


def nl_build_args(dev, P, n, N, coupling="eu", map_type="Highway",
                  lanes=False, edges=False, segments=None, seed=7):
    """The arguments of ``build_nl_qp`` for the first P problems of
    ceil(P / n) perturbed n-agent fleets at horizon N, as the Jacobi sweep
    hands them to it (the Monte-Carlo's perturbed start): per-agent float32
    limits, random prices, the bisector planes; ``lanes`` gives every other
    problem lane 1 (a per-problem lane tensor), ``edges`` puts the velocity
    gate's edges (vx below and at 0.2) and a NaN into the linearisation
    point; ``segments`` refits the track (:func:`fitted_track`)."""
    from colaborativempc_tpu_torch.config import SysLimits
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.runtime.ocd import _bisector_planes
    from colaborativempc_tpu_torch.runtime.simulate import (
        _neighbour_index, _per_agent_limits,
    )
    from colaborativempc_tpu_torch.scripts import monte_carlo
    B = -(-P // n)
    cfg, _, st = monte_carlo.setup("nl", scenarios=B, agents=n, N=N,
                                   steps=1, device=dev, coupling=coupling,
                                   map_type=map_type)
    ns = torch.as_tensor(_neighbour_index(n), device=dev)
    ids = torch.arange(n, device=dev)
    rng = np.random.default_rng(seed)
    lam = torch.tensor(rng.uniform(0.0, 1.0, size=(B, n, n - 1, N)),
                       dtype=torch.float32, device=dev)
    x_bar = torch.cat([st.x0[:, :, None], st.x_pred[:, :, 1:]], dim=2)
    planes = _bisector_planes(x_bar)[:, torch.minimum(ids[:, None], ns),
                                     torch.maximum(ids[:, None], ns)]
    neigh = x_bar[:, ns][..., 7:9].transpose(2, 3)

    def flat(t):
        return t.reshape((B * n,) + t.shape[2:])[:P].contiguous()
    x_bar = flat(x_bar)
    if edges:
        x_bar[:, 2:N:4, 0] = 0.1
        x_bar[:, 3:N:4, 0] = 0.2
        x_bar[0, 1, 0] = float("nan")
    limits = SysLimits(*(v.repeat(B)[:P].contiguous()
                         for v in _per_agent_limits(cfg, dev)))
    track = make_track(map_type, device=dev)
    return dict(
        track=track if segments is None else fitted_track(track, segments),
        gains=cfg.gains,
        limits=limits, model=cfg.model, N=N, dt=cfg.dt, x_bar=x_bar,
        u_bar=flat(st.u_pred), lambdas=flat(lam), neigh_xy=flat(neigh),
        master_mask=flat((ids[:, None] < ns).float().expand(B, n, n - 1)),
        coupling=coupling,
        lane=torch.arange(P, device=dev) % 2 if lanes else 0,
        planes0=flat(planes) if coupling == "hp_opt" else None)


def mpcc_build_args(dev, P, N, edges=False, segments=None, seed=11):
    """The arguments of ``build_mpcc_qp`` for P races spread over oval_mt
    at horizon N: the cold guess of ``runtime/racing.py`` with noise on the
    lateral states and inputs; ``edges`` puts the slip floor's edges (vx at
    and below 0.3) and a NaN into the linearisation point; ``segments``
    refits the track (:func:`fitted_track`) before the races are placed
    on it."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.geometry.frenet import frenet_to_cartesian
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
    from colaborativempc_tpu_torch.runtime import racing
    cfg = MPCCConfig(N=N)
    track = make_track(cfg.map_type, device=dev)
    if segments is not None:
        track = fitted_track(track, segments)
    s = torch.arange(P, dtype=torch.float32, device=dev) * (
        float(track.track_length[0]) / P)
    px, py, th = frenet_to_cartesian(track, s, 0.0)
    zero = torch.zeros_like(s)
    x0 = torch.stack([0.5 + 0.05 * torch.arange(P, device=dev), zero, zero,
                      zero, zero, th, s, px, py], dim=-1)
    x_bar, u_bar = racing._cold_guess(track, cfg, x0)
    rng = np.random.default_rng(seed)
    x_bar = x_bar + torch.tensor(
        rng.normal(size=x_bar.shape) * [0.1, 0.05, 0.3, 0.05, 0.05, 0, 0, 0,
                                        0], dtype=torch.float32, device=dev)
    u_bar = u_bar + torch.tensor(rng.normal(size=u_bar.shape) * [0.05, 0.1],
                                 dtype=torch.float32, device=dev)
    if edges:
        x_bar[:, 2:N:4, 0] = 0.3
        x_bar[:, 3:N:4, 0] = 0.1
        x_bar[0, 1, 0] = float("nan")
    return dict(track=track, gains=cfg.gains, p=cfg.model, N=N, dt=cfg.dt,
                x_bar=x_bar.contiguous(), u_bar=u_bar.contiguous(),
                bounds=cfg.bounds)


def shape_args(name, dev):
    """``(family, build arguments)`` of the named shape."""
    family, P, n, N, opts = SHAPES[name]
    if family == "nl":
        return family, nl_build_args(dev, P, n, N, **opts)
    return family, mpcc_build_args(dev, P, N, **opts)


def build_of(family):
    """The build the planner calls (``planners/nl.py build_nl_qp`` or
    ``planners/mpcc.py build_mpcc_qp``): on CUDA tensors the wrapper."""
    from colaborativempc_tpu_torch.planners import mpcc, nl
    return nl.build_nl_qp if family == "nl" else mpcc.build_mpcc_qp


def stage_qp_fields(qp):
    return [qp.dyn.F, qp.dyn.G, qp.dyn.d, qp.cost.Q, qp.cost.q, qp.cost.R,
            qp.cost.r, qp.cost.S, qp.D, qp.E, qp.lo, qp.hi, qp.soft_lo,
            qp.soft_hi]


def kernel_times(names, dev) -> dict:
    """The build of the package that ``sys.path`` finds at each named shape:
    its device ms, its host us per call and its outputs (every StageQP
    field, on the CPU)."""
    out = {}
    for name in names:
        family, args = shape_args(name, dev)
        build = build_of(family)
        got = [t.cpu() for t in stage_qp_fields(build(**args))]
        out[name] = {"ms": event_ms(lambda: build(**args)), "out": got,
                     "host_us": host_us(lambda: build(**args))}
    return out


def host_profile(fn, calls=300, top=12):
    """Where the host time of a call of ``fn`` goes: ``cProfile`` over
    ``calls`` calls, the ``top`` functions by time of their own, each as
    (function, microseconds per call of ``fn``, calls per call of ``fn``).
    The profiler's own cost inflates each function's time."""
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    total = sum(v[2] for v in stats.values()) / calls * 1e6
    return {"total_us": total, "functions": [
        (f"{k[0].split('/')[-1]}:{k[1]} {k[2]}", v[2] / calls * 1e6,
         v[1] / calls) for k, v in rows]}


def ptxas_lines(log: str) -> list:
    """The ptxas lines of the SQP kernels from an nvcc log: per kernel
    its registers, stack frame, spills and shared memory."""
    keep, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        if name and ("qp_kernel" in name) and (
                "registers" in line or "stack frame" in line):
            keep.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}")
    return keep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout of the repo whose build_nl_qp / "
                         "build_mpcc_qp are timed against this tree's in "
                         "turns")
    ap.add_argument("--source", default=None,
                    help="another copy of sqp_qp.cu with the clocked "
                         "entries (default: the package's)")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated names of " + ", ".join(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sqp_qp_split: needs a CUDA device")
    names = args.shapes.split(",")
    dev = torch.device("cuda", 0)
    from colaborativempc_tpu_torch.ops import _build, cuda_sqp
    info = card()
    print(info, flush=True)
    report = {"card": info, "shapes": {}}
    _build.load()
    _build.load_sqp_qp_clocks()
    report["ptxas"] = {
        "default": ptxas_lines(_build.build()["log"]),
        "clocked": ptxas_lines(_build.build_sqp_qp_clocks()["log"])}
    for build, lines in report["ptxas"].items():
        for line in lines:
            print(f"ptxas ({build} build) {line}", flush=True)
    if args.parent:
        report["shapes"] = turns(__file__, args.parent, names,
                                 lambda n: kernel_times(n, dev))
    for name in names:
        family, bargs = shape_args(name, dev)
        build = build_of(family)
        P, N = bargs["x_bar"].shape[0], bargs["N"]
        ref = build(**bargs)
        # the second of two calls: the first warms what a run of builds
        # finds warm (the code, the output's memory)
        for _ in range(2):
            qp, clocks, labels = cuda_sqp.sqp_qp_clocked(family, args.source,
                                                         **bargs)
            torch.cuda.synchronize()
        res = split(clocks.cpu().numpy(), labels, N)
        res["clocked_ms"] = event_ms(
            lambda: cuda_sqp.sqp_qp_clocked(family, args.source, **bargs))
        res["equal_to_default_build"] = differing(
            stage_qp_fields(qp), stage_qp_fields(ref)) == 0
        tag = name if args.source is None else f"{name} {args.source}"
        report["shapes"].setdefault(tag, {}).update(res)
        print(f"{tag} P={P} N={N}: {res['cycles_per_stage']:.0f} cycles "
              f"per stage (span {res['span_cycles']:.0f}), clocked build "
              f"{res['clocked_ms']:.4f} ms, outputs equal to the default "
              f"build's {res['equal_to_default_build']}; blocks at once "
              f"per SM {res.get('blocks_at_once_per_sm')}, wall "
              f"{res.get('wall_us')} us", flush=True)
        print_split(res)
        res = report["shapes"].setdefault(name, {})
        res["kernel_ms"] = event_ms(lambda: build(**bargs))
        res["host_us"] = host_us(lambda: build(**bargs))
        print(f"{name}: default build {res['kernel_ms']:.4f} ms, wrapper "
              f"{res['host_us']:.1f} us of host per call", flush=True)
        if name in PROFILED:
            res["host_profile"] = host_profile(lambda: build(**bargs))
            hp = res["host_profile"]
            print(f"  host profile: {hp['total_us']:.1f} us per call under "
                  "the profiler; " + "; ".join(
                      f"{f} {us:.1f} us x {n:g}"
                      for f, us, n in hp["functions"]), flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    sys.exit(main())
