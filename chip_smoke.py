"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's two main paths through the hand-written CUDA kernels —
the collaborative LPV fleet rollout of ``bench.py`` (Highway, 3 agents,
H=20, 256 scenarios, 20 control steps, admm_iters=300) and the NL-OCD
Monte-Carlo of ``scripts/monte_carlo.py --pipeline nl`` (64 fleets) — and
checks them:

1. a CUDA device is present; prints the card's name and power limit;
2. builds the kernels from ``colaborativempc_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch twin on the card, with the time of
   each beside its bound (bytes over 3.35 TB/s or FP32 operations over 67
   TFLOP/s, whichever is larger) and the launch plan (QPs per block, ring
   depth): at the headline shape (768 QPs, N=20, nz=11, nc=2, mr=6,
   epoch_len=20), at N=125 (a ring shorter than the horizon, streamed) and
   at N=125 with the horizon pinned resident, and at P=7 with 4 QPs per
   block (a ragged block);
3b. the epoch kernel against its twin on the NL planner's own QPs (256
   fleets x 3 agents, N=20): eu (nc=2, mr=6) and hp_opt (nc=6, mr=10), the
   latter under its plan and with the horizon pinned resident;
4. the LPV path: launch counts reset, one 20-step rollout, every state
   finite, the epoch kernel launched once per ADMM epoch the solves ran;
   then solves/s as the best of 3 rollouts;
5. end to end, kernel vs plain: the same config at B=4 for 5 steps on the
   card and on the CPU (plain twins) agree; each problem's ADMM iteration
   counts on both paths are printed where they differ;
6. the NL path: the NL-OCD Monte-Carlo (64 fleets x 3 agents, N=20,
   eu, Jacobi) for 20 control steps: launch counts reset, every state
   finite, the epoch kernel launched once per ADMM epoch its solves ran;
   then fleet-steps/s as the best of 2 rollouts;
7. NL end to end, kernel vs plain: B=2 fleets x 3 steps on the card and
   on the CPU, for eu/Jacobi and hp_opt/Gauss-Seidel — plans within 1e-3,
   equal feasible flags and OCD iteration counts;
8. one fleet's closed loop (``run_nl_experiment``, 20 steps): p50/p95 step
   latency;
9. the layer split of an LPV step (B=256) and of an NL-OCD step (B=64):
   milliseconds per control step in each layer, from synchronised host
   timers around the layers' functions.

Prints a JSON line with each kernel's record, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, on
any failure or when no CUDA device is available.

Usage: ``python3 chip_smoke.py`` from the repository root.
"""

import json
import subprocess
import sys
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


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def check_kernels(dev, N, reps, P=HEADLINE["P"], **pin):
    """Phase 3 at one shape: both kernels vs their plain twins, under the
    launch plan ``kernel_plan`` chooses, or with ``pin`` (ring,
    qps_per_block) pinned."""
    from colaborativempc_tpu_torch.ops import (
        LQRCost, LQRDynamics, StageQP, admm_epoch_inputs, cuda_lqr,
    )
    shape = dict(HEADLINE, N=N, P=P)
    rng = np.random.default_rng(1000 + N + (P if P != HEADLINE["P"] else 0))
    pr = random_epoch_problems(rng, **shape)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    soft = t(pr["soft"])
    qp = StageQP(
        dyn=LQRDynamics(t(pr["F"]), t(pr["G"]), t(pr["d"])),
        cost=LQRCost(t(pr["Q"]), t(pr["q"]), t(pr["R"]), t(pr["r"]),
                     t(pr["S"])),
        D=t(pr["D"]), E=t(pr["E"]), lo=t(pr["lo"]), hi=t(pr["hi"]),
        soft_lo=soft, soft_hi=soft)
    data = admm_epoch_inputs(qp, rho=10.0, rho_scale=t(pr["rho_scale"]))
    z0, w0, y0 = t(pr["z0"]), t(pr["w0"]), t(pr["y0"])
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
            lambda: cuda_lqr.lqr_affine_solve_batched_plain(*aff_args), 2))

    kw = dict(epoch_len=EPOCH_LEN, alpha=ALPHA)
    got = cuda_lqr.admm_epoch_batched(data, z0, w0, y0, plan=ep_plan, **kw)
    torch.cuda.synchronize()
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0, **kw)
    torch.cuda.synchronize()
    err_zcwy = max_err(got[:4], ref[:4])
    err_res = max_err(got[4:], ref[4:])
    if not all(bool(torch.isfinite(x).all()) for x in got):
        fail(f"epoch kernel output not finite at N={N}")
    if not (err_zcwy <= TOL_EPOCH and err_res <= TOL_RESID):
        fail(f"epoch kernel vs plain at N={N}: z/c/w/y err {err_zcwy} "
             f"(tol {TOL_EPOCH}), rp/rd err {err_res} (tol {TOL_RESID})")
    out["epoch"] = dict(
        max_abs_err=err_zcwy, max_abs_err_resid=err_res,
        plan=ep_plan._asdict(),
        ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched(
            data, z0, w0, y0, plan=ep_plan, **kw), reps),
        plain_ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched_plain(
            data, z0, w0, y0, **kw), 1))
    for name, m, el in (("affine", 0, 0), ("epoch", mr, EPOCH_LEN)):
        o = out[name]
        o["bound_ms"], o["bound_by"] = kernel_bound(P, N, nz, nc, m, el)
        o["roofline_share"] = o["bound_ms"] / o["ms"]
    print(f"phase 3 P={P} N={N}: affine kernel {out['affine']['ms']:.4f} ms "
          f"(bound {out['affine']['bound_ms']:.3g}, plan "
          f"{out['affine']['plan']}) vs plain "
          f"{out['affine']['plain_ms']:.4f} ms (err {err:.3g}); epoch "
          f"kernel {out['epoch']['ms']:.4f} ms (bound "
          f"{out['epoch']['bound_ms']:.3g}, plan {out['epoch']['plan']}) vs "
          f"plain {out['epoch']['plain_ms']:.4f} ms (err {err_zcwy:.3g}, "
          f"resid err {err_res:.3g})", flush=True)
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
    from colaborativempc_tpu_torch.ops import admm_epoch_inputs, cuda_lqr
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
    data = admm_epoch_inputs(qp, rho=10.0)
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
    return out


def count_solver_epochs():
    """Wrap the NL planner's ``admm_solve`` so each call adds the epochs it
    ran (its slowest problem's iterations over the epoch length) to the
    returned list; ``restore()`` unwraps it."""
    from colaborativempc_tpu_torch.ops.admm import default_epoch_len
    from colaborativempc_tpu_torch.planners import nl
    orig = nl.admm_solve
    epochs = []

    def counting(qp, *args, **kw):
        sol = orig(qp, *args, **kw)
        el = kw.get("epoch_len") or default_epoch_len(qp.lo.shape[1])
        epochs.append(int(sol.iterations.max()) // el)
        return sol

    def restore():
        nl.admm_solve = orig
    nl.admm_solve = counting
    return epochs, restore


NL_B, NL_STEPS = 64, 20


def nl_main_path(dev, card):
    """Phase 6: the NL-OCD Monte-Carlo, once with the launch counters and
    the solver's epochs counted, then timed as the best of 2 rollouts."""
    from colaborativempc_tpu_torch.ops import cuda_lqr
    from colaborativempc_tpu_torch.scripts import monte_carlo
    cfg, rollout, state0 = monte_carlo.setup(
        "nl", scenarios=NL_B, agents=3, N=20, steps=NL_STEPS, device=dev)
    epochs, restore = count_solver_epochs()
    cuda_lqr.admm_epoch_batched.launches = 0
    cuda_lqr.lqr_affine_solve_batched.launches = 0
    try:
        final, (xh, uh, met) = rollout(state0)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = {"epoch": cuda_lqr.admm_epoch_batched.launches,
                "affine": cuda_lqr.lqr_affine_solve_batched.launches}
    if not all_finite(list(final) + [xh, uh] + list(met)):
        fail("NL path: a state is not finite")
    if launches["epoch"] != sum(epochs) or not epochs or sum(epochs) == 0:
        fail(f"NL path: epoch kernel launched {launches['epoch']} times, the "
             f"solves ran {sum(epochs)} epochs over {len(epochs)} calls")
    best = float("inf")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(state0)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    out = dict(
        card=card, fleets=NL_B, steps=NL_STEPS,
        fleet_steps_per_s=NL_B * NL_STEPS / best,
        ms_per_step=best / NL_STEPS * 1e3,
        mean_ocd_iterations=float(met.ocd_iterations.float().mean()),
        max_ocd_iterations=int(met.ocd_iterations.max()),
        feasible_share=float(met.feasible.float().mean()),
        min_dist_exec=float(met.min_dist_exec.min()),
        solver_calls=len(epochs), launches=launches)
    print(f"phase 6: NL-OCD {NL_B} fleets x 3 agents x {NL_STEPS} steps: "
          f"{out['fleet_steps_per_s']:.2f} fleet-steps/s "
          f"({out['ms_per_step']:.1f} ms/step, best of 2), mean OCD "
          f"iterations {out['mean_ocd_iterations']:.2f}, feasible share "
          f"{out['feasible_share']:.4f}, min_dist_exec "
          f"{out['min_dist_exec']:.4f} m, epoch-kernel launches "
          f"{launches['epoch']} over {len(epochs)} solver calls [{card}]",
          flush=True)
    return out


def record_admm_iterations():
    """Wrap the NL planner's ``admm_solve`` so each call appends its
    problems' ADMM iteration counts (on the CPU) to the returned list;
    ``restore()`` unwraps it."""
    from colaborativempc_tpu_torch.planners import nl
    orig = nl.admm_solve
    calls = []

    def recording(qp, *args, **kw):
        sol = orig(qp, *args, **kw)
        calls.append(sol.iterations.cpu())
        return sol

    def restore():
        nl.admm_solve = orig
    nl.admm_solve = recording
    return calls, restore


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
            try:
                fin, (_, _, m) = rollout(st)
            finally:
                restore()
            outs[name] = (fin.x_pred.cpu(), m.feasible.cpu(),
                          m.ocd_iterations.cpu(), calls)
        (xg, fg, og, cg), (xc, fc, oc, cc) = outs["cuda"], outs["cpu"]
        dx_f = (xg - xc).abs().flatten(1).amax(dim=1)   # per fleet
        dx = float(dx_f.max())
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
        agree = [f for f in range(B) if f not in differ]
        held, fleets_held = dx, list(range(B))
        if dx > TOL_ROLLOUT:
            if not differ or not agree:
                fail(f"NL {coupling}/{sweep} kernel vs plain: max |dx_pred| "
                     f"{dx} (tol {TOL_ROLLOUT}); ADMM iterations differ in "
                     f"{n_differ} of {n_solves} problem solves, fleets "
                     f"whose counts agree: {agree}")
            held, fleets_held = float(dx_f[agree].max()), agree
            if not held <= TOL_ROLLOUT:
                fail(f"NL {coupling}/{sweep} kernel vs plain: max |dx_pred| "
                     f"{held} (tol {TOL_ROLLOUT}) in the fleets {agree} "
                     "whose ADMM iteration counts agree")
        out[f"{coupling}_{sweep}"] = dict(
            max_dx=dx, max_dx_held=held, fleets_held=fleets_held,
            problem_solves=n_solves, problem_solves_differing=n_differ)
        print(f"phase 7: NL {coupling}/{sweep} B={B} x 3 steps, max |dx_pred| "
              f"cuda vs cpu {dx:.3g} ({dx / TOL_ROLLOUT:.3f} of the "
              f"tolerance; held to it in fleets {fleets_held}: "
              f"{held:.3g}), ADMM iterations differ in {n_differ} of "
              f"{n_solves} problem "
              f"solves, feasible flags and OCD iterations {og.tolist()} "
              "equal", flush=True)
    return out


def nl_single_fleet(dev, card):
    """Phase 8: one fleet's NL-OCD closed loop, as ``nl_main`` runs it."""
    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, OCDConfig, SolverConfig, nl_gains,
    )
    from colaborativempc_tpu_torch.runtime import run_nl_experiment
    cfg = ExperimentConfig(
        n_agents=3, N=20, dt=0.02, max_it=20, map_type="Highway",
        gains=nl_gains(), ocd=OCDConfig(max_it_ocd=50),
        solver=SolverConfig(admm_iters=200, sqp_iters=2))
    res = run_nl_experiment(cfg, device=dev)
    if res.steps != 20 or not np.isfinite(res.states).all():
        fail(f"single-fleet NL run: {res.steps} steps, finite states: "
             f"{bool(np.isfinite(res.states).all())}")
    ms = res.step_times * 1e3
    out = dict(card=card, steps=res.steps, p50_ms=float(np.percentile(ms, 50)),
               p95_ms=float(np.percentile(ms, 95)), first_ms=float(ms[0]),
               mean_ocd_iterations=float(res.ocd_iterations.mean()),
               feasible_share=float(res.feasible.mean()),
               min_dist_exec=float(res.min_dist_exec.min()))
    print(f"single fleet: run_nl_experiment 3 agents N=20, {res.steps} steps: "
          f"p50 {out['p50_ms']:.1f} ms, p95 {out['p95_ms']:.1f} ms per step "
          f"(first {out['first_ms']:.1f} ms), mean OCD iterations "
          f"{out['mean_ocd_iterations']:.2f}, feasible share "
          f"{out['feasible_share']:.4f} [{card}]", flush=True)
    return out


class LayerTimer:
    """Synchronised host timers around module functions: each call adds
    its milliseconds to ``ms[name]``; ``restore()`` unwraps them."""

    def __init__(self):
        self.ms, self.calls, self._undo = {}, {}, []

    def wrap(self, module, attr, name):
        orig = getattr(module, attr)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.ms[name] = (self.ms.get(name, 0.0)
                                 + (time.perf_counter() - t0) * 1e3)
                self.calls[name] = self.calls.get(name, 0) + 1
        setattr(module, attr, timed)
        self._undo.append((module, attr, orig))

    def restore(self):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)


def layer_split(dev, card, steps=3):
    """Phase 9: milliseconds per control step in each layer of the LPV step
    (B=256, from bench.py's perturbed start) and of the NL-OCD step (B=64,
    the Monte-Carlo's perturbed start), over ``steps`` steps, with every
    layer's function wrapped in a synchronised timer (the timers' syncs
    make the step slower than unwrapped)."""
    from colaborativempc_tpu_torch.ops import admm
    from colaborativempc_tpu_torch.planners import lpv, nl
    from colaborativempc_tpu_torch.runtime import (
        make_lpv_fleet_rollout, ocd, simulate,
    )
    from colaborativempc_tpu_torch.scripts import monte_carlo
    out = {}
    for path in ("lpv", "nl"):
        if path == "lpv":
            cfg, track, st = fleet(dev, 256)
            roll = make_lpv_fleet_rollout(track, cfg, steps)
        else:
            _, roll, st = monte_carlo.setup("nl", scenarios=NL_B, agents=3,
                                            N=20, steps=steps, device=dev)
        roll(st)  # warm
        timer = LayerTimer()
        timer.wrap(admm, "admm_epoch_inputs", "refactorisation")
        timer.wrap(admm, "admm_epoch_batched", "epoch_kernel")
        planner = lpv if path == "lpv" else nl
        timer.wrap(planner, "admm_solve", "admm_solve")
        if path == "lpv":
            timer.wrap(lpv, "build_lpv_qp", "qp_assembly")
            timer.wrap(simulate, "lpv_solve", "planner")
        else:
            timer.wrap(nl, "_linearize_horizon", "linearisation")
            timer.wrap(nl, "build_nl_qp", "qp_build")
            timer.wrap(ocd, "nl_solve", "planner")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, (_, _, met) = roll(st)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        finally:
            timer.restore()
        ms = {k: v / steps for k, v in timer.ms.items()}
        split = {"refactorisation": ms["refactorisation"],
                 "epoch_kernel": ms["epoch_kernel"],
                 "admm_rest": (ms["admm_solve"] - ms["refactorisation"]
                               - ms["epoch_kernel"])}
        if path == "lpv":
            split["qp_assembly"] = ms["qp_assembly"]
            split["planner_rest"] = (ms["planner"] - ms["qp_assembly"]
                                     - ms["admm_solve"])
        else:
            split["linearisation"] = ms["linearisation"]
            split["qp_assembly"] = ms["qp_build"] - ms["linearisation"]
            split["planner_rest"] = (ms["planner"] - ms["qp_build"]
                                     - ms["admm_solve"])
        split["step_rest"] = total / steps - ms["planner"]
        out[path] = dict(
            card=card, steps=steps, ms_per_step_timed=total / steps,
            epochs_per_step=timer.calls["epoch_kernel"] / steps,
            ms_per_epoch_kernel=ms["epoch_kernel"] * steps
            / timer.calls["epoch_kernel"],
            ms_per_epoch_refactorisation=ms["refactorisation"] * steps
            / timer.calls["refactorisation"],
            split_ms_per_step=split)
        if path == "nl":
            out[path]["ocd_iterations_per_step"] = float(
                met.ocd_iterations.amax(dim=0).float().mean())
        print(f"phase 9 {path}: {total / steps:.1f} ms per step with layer "
              f"timers, {out[path]['epochs_per_step']:.1f} epochs per step; "
              + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
              + f" [{card}]", flush=True)
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


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    from colaborativempc_tpu_torch.ops import _build, cuda_lqr
    from colaborativempc_tpu_torch.ops.admm import default_epoch_len
    from colaborativempc_tpu_torch.runtime import make_lpv_fleet_rollout

    # phase 2: build
    info = _build.build()
    _build.load()
    print(f"phase 2: kernels built in {info['seconds']:.2f} s "
          f"(built={info['built']}) -> {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())

    # phase 3: kernels vs plain twins
    k20 = check_kernels(dev, HEADLINE["N"], reps=20)
    k125 = check_kernels(dev, 125, reps=5)
    k125_resident = check_kernels(dev, 125, reps=2, ring=125)
    k7 = check_kernels(dev, HEADLINE["N"], reps=10, P=7, qps_per_block=4)
    if not (k125["epoch"]["plan"]["ring"] < 125
            and 7 % k7["epoch"]["plan"]["qps_per_block"] != 0):
        fail("phase 3 did not reach a streamed ring and a ragged block")
    # phase 3b: the epoch kernel on the NL planner's QPs
    knl = {c: check_nl_epoch(dev, c, reps=10) for c in ("eu", "hp_opt")}
    knl["hp_opt_resident"] = check_nl_epoch(dev, "hp_opt", reps=10,
                                            ring=HEADLINE["N"])

    # phase 4: the main path
    B, STEPS = 256, 20
    cfg, track, state0 = fleet(dev, B)
    rollout = make_lpv_fleet_rollout(track, cfg, STEPS)
    cuda_lqr.admm_epoch_batched.launches = 0
    cuda_lqr.lqr_affine_solve_batched.launches = 0
    final, (xh, uh, met) = rollout(state0)
    torch.cuda.synchronize()
    launches = {"epoch": cuda_lqr.admm_epoch_batched.launches,
                "affine": cuda_lqr.lqr_affine_solve_batched.launches}
    if not all_finite(list(final) + [xh, uh]):
        fail("main path: a state is not finite")
    el = cfg.solver.epoch_len or default_epoch_len(cfg.N)
    # per step the solve runs as many epochs as its slowest problem
    expected = int((met.iterations.amax(dim=(0, 2)) // el).sum())
    if launches["epoch"] != expected or expected == 0:
        fail(f"main path: epoch kernel launched {launches['epoch']} times, "
             f"the solves ran {expected} epochs")
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(state0)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / STEPS)
    solves_per_s = B * cfg.n_agents / best
    feas = float(met.feasible.float().mean())
    mean_it = float(met.iterations.float().mean())
    min_exec = float(met.min_dist_exec.min())
    print(f"phase 4: {solves_per_s:.1f} solves/s ({best * 1e3:.3f} ms/step, "
          f"best of 3), feasible share {feas:.4f}, mean ADMM iterations "
          f"{mean_it:.2f}, min_dist_exec {min_exec:.4f} m, epoch-kernel "
          f"launches {launches['epoch']} ({launches['epoch'] / STEPS:.2f} "
          f"per step) [{card}]", flush=True)

    # phase 5: end to end, kernel vs plain twins on the CPU
    phase5 = rollout_iterations_agree(dev)

    nl_path = nl_main_path(dev, card)
    phase7 = nl_end_to_end(dev)
    single = nl_single_fleet(dev, card)
    layers = layer_split(dev, card)

    src = "colaborativempc_tpu_torch/csrc/lqr_kernels.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "roofline_share",
            "max_abs_err", "plan")

    def shapes(name, **runs):
        return {tag: {k: r[name][k] for k in keys} if name in r
                else {k: r[k] for k in keys} for tag, r in runs.items()}
    kernels = [
        dict(name="admm_epoch_batched", route="cuda", source=src,
             replaces="colaborativempc_tpu/ops/pallas_lqr.py:88",
             launches=launches["epoch"] + nl_path["launches"]["epoch"],
             launches_lpv=launches["epoch"],
             launches_nl=nl_path["launches"]["epoch"],
             launches_per_step_lpv=launches["epoch"] / STEPS,
             launches_per_step_nl=nl_path["launches"]["epoch"] / NL_STEPS,
             max_abs_err=k20["epoch"]["max_abs_err"],
             max_abs_err_resid=k20["epoch"]["max_abs_err_resid"],
             ms=k20["epoch"]["ms"], plain_ms=k20["epoch"]["plain_ms"],
             bound_ms=k20["epoch"]["bound_ms"],
             bound_by=k20["epoch"]["bound_by"],
             roofline_share=k20["epoch"]["roofline_share"],
             library_ms=None, plan=k20["epoch"]["plan"],
             shapes=shapes("epoch", n125=k125, n125_resident=k125_resident,
                           p7=k7,
                           **{f"nl_{c}": r for c, r in knl.items()})),
        dict(name="lqr_affine_solve_batched", route="cuda", source=src,
             replaces="colaborativempc_tpu/ops/pallas_lqr.py:40",
             launches=launches["affine"] + nl_path["launches"]["affine"],
             on_main_path=False,
             max_abs_err=k20["affine"]["max_abs_err"],
             ms=k20["affine"]["ms"], plain_ms=k20["affine"]["plain_ms"],
             bound_ms=k20["affine"]["bound_ms"],
             bound_by=k20["affine"]["bound_by"],
             roofline_share=k20["affine"]["roofline_share"],
             library_ms=None, plan=k20["affine"]["plan"],
             shapes=shapes("affine", n125=k125,
                           n125_resident=k125_resident, p7=k7)),
    ]
    print(json.dumps({"main_path": {
        "card": card, "solves_per_s": solves_per_s, "ms_per_step": best * 1e3,
        "feasible_share": feas, "mean_admm_iterations": mean_it,
        "min_dist_exec": min_exec}}))
    print(json.dumps({"nl_main_path": {
        k: v for k, v in nl_path.items() if k != "launches"},
        "nl_single_fleet": single, "phase5": phase5, "phase7": phase7,
        "layers": layers}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
