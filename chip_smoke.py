"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's two main paths through the hand-written CUDA kernels —
the collaborative LPV fleet rollout of ``bench.py`` (Highway, 3 agents,
H=20, 256 scenarios, 20 control steps, admm_iters=300) and the NL-OCD
Monte-Carlo of ``scripts/monte_carlo.py --pipeline nl`` (64 fleets) — and
checks them:

1. a CUDA device is present; prints the card's name and power limit;
2. builds the kernels from ``colaborativempc_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch twin on the card, at the headline
   shape (768 QPs, N=20, nz=11, nc=2, mr=6, epoch_len=20) and at N=125,
   with the time of each;
3b. the epoch kernel against its twin on the NL planner's own QPs (256
   fleets x 3 agents, N=20): eu (nc=2, mr=6) and hp_opt (nc=6, mr=10);
4. the LPV path: launch counts reset, one 20-step rollout, every state
   finite, the epoch kernel launched once per ADMM epoch the solves ran;
   then solves/s as the best of 3 rollouts;
5. end to end, kernel vs plain: the same config at B=4 for 5 steps on the
   card and on the CPU (plain twins) agree;
6. the NL path: the NL-OCD Monte-Carlo (64 fleets x 3 agents, N=20,
   eu, Jacobi) for 20 control steps: launch counts reset, every state
   finite, the epoch kernel launched once per ADMM epoch its solves ran;
   then fleet-steps/s as the best of 2 rollouts;
7. NL end to end, kernel vs plain: B=2 fleets x 3 steps on the card and
   on the CPU, for eu/Jacobi and hp_opt/Gauss-Seidel — plans within 1e-3,
   equal feasible flags and OCD iteration counts;
8. one fleet's closed loop (``run_nl_experiment``, 20 steps): p50/p95 step
   latency.

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


def check_kernels(dev, N, reps):
    """Phase 3 at one shape: both kernels vs their plain twins."""
    from colaborativempc_tpu_torch.ops import (
        LQRCost, LQRDynamics, StageQP, admm_epoch_inputs, cuda_lqr,
    )
    shape = dict(HEADLINE, N=N)
    rng = np.random.default_rng(1000 + N)
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

    aff_args = (data.F, data.G, data.d, data.K, data.Quu_inv, data.Qxu,
                data.m, data.q, data.r, z0)
    got = cuda_lqr.lqr_affine_solve_batched(*aff_args)
    torch.cuda.synchronize()
    ref = cuda_lqr.lqr_affine_solve_batched_plain(*aff_args)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    if not err <= TOL_AFFINE:
        fail(f"affine kernel vs plain at N={N}: max |err| {err} > "
             f"{TOL_AFFINE}")
    out["affine"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: cuda_lqr.lqr_affine_solve_batched(*aff_args),
                   reps),
        plain_ms=cuda_ms(
            lambda: cuda_lqr.lqr_affine_solve_batched_plain(*aff_args), 2))

    kw = dict(epoch_len=EPOCH_LEN, alpha=ALPHA)
    got = cuda_lqr.admm_epoch_batched(data, z0, w0, y0, **kw)
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
        ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched(
            data, z0, w0, y0, **kw), reps),
        plain_ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched_plain(
            data, z0, w0, y0, **kw), 1))
    print(f"phase 3 N={N}: affine kernel {out['affine']['ms']:.4f} ms vs "
          f"plain {out['affine']['plain_ms']:.4f} ms (err {err:.3g}); "
          f"epoch kernel {out['epoch']['ms']:.4f} ms vs plain "
          f"{out['epoch']['plain_ms']:.4f} ms (err {err_zcwy:.3g}, "
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


def check_nl_epoch(dev, coupling, reps):
    """Phase 3b at one coupling: the epoch kernel vs its plain twin on the
    NL planner's QPs of 256 perturbed 3-agent fleets (N=20), as the Jacobi
    sweep hands them to the solver."""
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
    kw = dict(epoch_len=EPOCH_LEN, alpha=ALPHA)
    got = cuda_lqr.admm_epoch_batched(data, z0, w0, y0, **kw)
    torch.cuda.synchronize()
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0, **kw)
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
               ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched(
                   data, z0, w0, y0, **kw), reps),
               plain_ms=cuda_ms(lambda: cuda_lqr.admm_epoch_batched_plain(
                   data, z0, w0, y0, **kw), 1))
    print(f"phase 3b {coupling} {shape}: epoch kernel {out['ms']:.4f} ms vs "
          f"plain {out['plain_ms']:.4f} ms (err {err_zcwy:.3g}, resid err "
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


def nl_end_to_end(dev):
    """Phase 7: the NL path on the kernels vs on the CPU's plain twins."""
    from colaborativempc_tpu_torch.scripts import monte_carlo
    for coupling, sweep in (("eu", "jacobi"), ("hp_opt", "gauss_seidel")):
        outs = {}
        for name in ("cuda", "cpu"):
            _, rollout, st = monte_carlo.setup(
                "nl", scenarios=2, agents=3, N=20, steps=3,
                device=torch.device(name), coupling=coupling, sweep=sweep)
            fin, (_, _, m) = rollout(st)
            outs[name] = (fin.x_pred.cpu(), m.feasible.cpu(),
                          m.ocd_iterations.cpu())
        dx = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
        same_feas = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
        same_its = bool(torch.equal(outs["cuda"][2], outs["cpu"][2]))
        if not (dx <= TOL_ROLLOUT and same_feas and same_its):
            fail(f"NL {coupling}/{sweep} kernel vs plain: max |dx_pred| {dx} "
                 f"(tol {TOL_ROLLOUT}), feasible flags equal: {same_feas}, "
                 f"OCD iterations equal: {same_its} "
                 f"({outs['cuda'][2].tolist()} vs {outs['cpu'][2].tolist()})")
        print(f"phase 7: NL {coupling}/{sweep} B=2 x 3 steps, max |dx_pred| "
              f"cuda vs cpu {dx:.3g} ({dx / TOL_ROLLOUT:.3f} of the "
              f"tolerance), feasible flags and OCD iterations "
              f"{outs['cuda'][2].tolist()} equal", flush=True)


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
    # phase 3b: the epoch kernel on the NL planner's QPs
    knl = {c: check_nl_epoch(dev, c, reps=10) for c in ("eu", "hp_opt")}

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
          f"launches {launches['epoch']} [{card}]", flush=True)

    # phase 5: end to end, kernel vs plain twins on the CPU
    outs = {}
    for name in ("cuda", "cpu"):
        cfg5, track5, st5 = fleet(torch.device(name), 4)
        fin, (_, _, m5) = make_lpv_fleet_rollout(track5, cfg5, 5)(st5)
        outs[name] = (fin.x_pred.cpu(), m5.feasible.cpu())
    dx = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    same_feas = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
    if not (dx <= TOL_ROLLOUT and same_feas):
        fail(f"rollout kernel vs plain: max |dx_pred| {dx} (tol "
             f"{TOL_ROLLOUT}), feasible flags equal: {same_feas}")
    print(f"phase 5: B=4 x 5 steps, max |dx_pred| cuda vs cpu {dx:.3g}, "
          "feasible flags equal", flush=True)

    nl_path = nl_main_path(dev, card)
    nl_end_to_end(dev)
    single = nl_single_fleet(dev, card)

    src = "colaborativempc_tpu_torch/csrc/lqr_kernels.cu"
    kernels = [
        dict(name="admm_epoch_batched", route="cuda", source=src,
             replaces="colaborativempc_tpu/ops/pallas_lqr.py:88",
             launches=launches["epoch"] + nl_path["launches"]["epoch"],
             launches_lpv=launches["epoch"],
             launches_nl=nl_path["launches"]["epoch"],
             max_abs_err=k20["epoch"]["max_abs_err"],
             ms=k20["epoch"]["ms"], plain_ms=k20["epoch"]["plain_ms"],
             max_abs_err_resid=k20["epoch"]["max_abs_err_resid"],
             ms_n125=k125["epoch"]["ms"],
             plain_ms_n125=k125["epoch"]["plain_ms"],
             max_abs_err_n125=k125["epoch"]["max_abs_err"],
             **{f"{k}_nl_{c}": v for c, r in knl.items()
                for k, v in r.items()}),
        dict(name="lqr_affine_solve_batched", route="cuda", source=src,
             replaces="colaborativempc_tpu/ops/pallas_lqr.py:40",
             launches=launches["affine"] + nl_path["launches"]["affine"],
             on_main_path=False,
             max_abs_err=k20["affine"]["max_abs_err"],
             ms=k20["affine"]["ms"], plain_ms=k20["affine"]["plain_ms"],
             ms_n125=k125["affine"]["ms"],
             plain_ms_n125=k125["affine"]["plain_ms"],
             max_abs_err_n125=k125["affine"]["max_abs_err"]),
    ]
    print(json.dumps({"main_path": {
        "card": card, "solves_per_s": solves_per_s, "ms_per_step": best * 1e3,
        "feasible_share": feas, "mean_admm_iterations": mean_it,
        "min_dist_exec": min_exec}}))
    print(json.dumps({"nl_main_path": {
        k: v for k, v in nl_path.items() if k != "launches"},
        "nl_single_fleet": single}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
