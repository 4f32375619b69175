"""Monte-Carlo scenario sweep: many perturbed fleets advance in lock-step
as one batch; the port of the JAX package's ``scripts/monte_carlo.py``.

    python -m colaborativempc_tpu_torch.scripts.monte_carlo [--pipeline lpv|nl]
        [--scenarios 64] [--agents 3] [--N 20] [--steps 60] [--device cuda]
        [--mesh SxA]

Reports the distribution of safety and performance metrics across
scenarios; ``--pipeline nl`` runs the full NL-OCD coordination loop (the
per-fleet freeze keeps each scenario's OCD iteration counts those of a
standalone run) and reports the per-scenario OCD iteration distribution.
``--device`` defaults to ``cuda`` and raises when there is no card;
``--device cpu`` runs on the CPU.

``--mesh SxA`` runs the sweep sharded over a ``(scen, agent)`` mesh of
S*A ranks (``parallel/fleet.py``, ``parallel/ocd.py``), one process per
rank, started by ``torchrun --nproc-per-node S*A -m
colaborativempc_tpu_torch.scripts.monte_carlo --mesh SxA ...`` (NCCL on
cards, one card per rank; gloo with ``--device cpu``), or by a plain
``python -m`` when S*A is 1. Every rank builds the same perturbed batch
and runs its block; rank 0 prints the report from the gathered metrics,
the same lines as the run without ``--mesh``.
"""

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch


def perturb_x0(shape, noise, rng) -> np.ndarray:
    """x0 perturbation of (vx, vy, wz) only: the pose states (ey, epsi,
    theta, s, X, Y) are redundant Frenet/Cartesian pairs that must stay
    consistent. Draws ``rng.normal(size=shape)`` as the JAX script does."""
    pert = rng.normal(size=shape) * noise
    pert[..., 3:] = 0.0
    return pert


def setup(pipeline="nl", scenarios=64, agents=3, N=20, steps=60,
          map_type="Highway", noise=0.05, device="cuda", seed=0,
          coupling="eu", sweep="jacobi", mesh=None):
    """The sweep's configuration, its rollout function and the perturbed
    initial batch: ``(cfg, rollout, state)``; ``rollout(state)`` returns
    ``(final_state, (x0_hist, u_hist, metrics))`` with ``(scenarios,
    steps, ...)`` histories. ``coupling`` and ``sweep`` apply to the NL
    pipeline. ``device`` defaults to CUDA and raises without a card.

    With a ``mesh`` (a ``("scen", "agent")`` ``DeviceMesh`` over every
    rank), ``state`` is this rank's block of the batch and ``rollout`` the
    sharded rollout: ``state -> (final_state, metrics)``, the metrics
    with a leading ``(steps, ...)`` time axis."""
    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, OCDConfig, SolverConfig, lpv_gains, nl_gains,
    )
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.parallel import batch_fleet_state
    from colaborativempc_tpu_torch.runtime import (
        init_lpv_fleet, init_nl_fleet, make_lpv_fleet_rollout,
        make_nl_ocd_rollout,
    )
    from colaborativempc_tpu_torch.utils import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if pipeline == "nl":
        cfg = ExperimentConfig(
            n_agents=agents, N=N, dt=0.02, map_type=map_type,
            coupling=coupling, gains=nl_gains(), ocd=OCDConfig(sweep=sweep),
            solver=SolverConfig(admm_iters=200, sqp_iters=2))
        init, make = init_nl_fleet, make_nl_ocd_rollout
        if mesh is not None:
            from colaborativempc_tpu_torch.parallel import (
                make_sharded_nl_ocd_rollout,
            )
            make = make_sharded_nl_ocd_rollout
    else:
        cfg = ExperimentConfig(
            n_agents=agents, N=N, dt=0.02, map_type=map_type,
            gains=lpv_gains(), solver=SolverConfig(admm_iters=300))
        init, make = init_lpv_fleet, make_lpv_fleet_rollout
        if mesh is not None:
            from colaborativempc_tpu_torch.parallel import (
                make_sharded_lpv_rollout,
            )
            make = make_sharded_lpv_rollout
    track = make_track(cfg.map_type, device=device)
    state = batch_fleet_state(init(track, cfg, device=device), scenarios,
                              device=device)
    pert = perturb_x0(tuple(state.x0.shape), noise, rng)
    state = state._replace(x0=state.x0 + torch.tensor(
        pert, dtype=state.x0.dtype, device=state.x0.device))
    if mesh is None:
        return cfg, make(track, cfg, steps), state
    from colaborativempc_tpu_torch.parallel import shard_fleet_state
    return (cfg, make(track, cfg, mesh, steps),
            shard_fleet_state(state, mesh))


def report(pipeline, final, metrics):
    """The JAX script's summary lines for one sweep."""
    min_dist = metrics.min_dist_exec.amin(dim=1).cpu().numpy()
    feas = metrics.feasible.flatten(1).all(dim=1).cpu().numpy()
    prog = final.x0[:, :, 6].mean(dim=1).cpu().numpy()
    S = len(feas)
    lines = [f"feasible scenarios: {int(feas.sum())}/{S}",
             f"min separation: p5={np.percentile(min_dist, 5):.3f} "
             f"median={np.median(min_dist):.3f} worst={min_dist.min():.3f}",
             f"progress [m]:   p5={np.percentile(prog, 5):.2f} "
             f"median={np.median(prog):.2f} best={prog.max():.2f}"]
    if pipeline == "nl":
        its = metrics.ocd_iterations.cpu().numpy()       # (scen, steps)
        per_scen = its.mean(axis=1)
        lines.append(f"OCD iterations/step: per-scenario mean "
                     f"p5={np.percentile(per_scen, 5):.2f} "
                     f"median={np.median(per_scen):.2f} "
                     f"p95={np.percentile(per_scen, 95):.2f} "
                     f"max-step={int(its.max())}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", choices=("lpv", "nl"), default="lpv")
    ap.add_argument("--scenarios", type=int, default=64)
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--N", type=int, default=20)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--map", default="Highway")
    ap.add_argument("--noise", type=float, default=0.05,
                    help="x0 perturbation scale")
    ap.add_argument("--coupling", choices=("eu", "hp", "hp_opt"),
                    default="eu", help="NL coupling")
    ap.add_argument("--sweep", choices=("jacobi", "gauss_seidel"),
                    default="jacobi", help="NL coordination sweep order")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which raises without "
                    "a card; --device cpu runs on the CPU)")
    ap.add_argument("--mesh", default=None, metavar="SxA",
                    help="run sharded over a (scen, agent) mesh of S*A "
                    "ranks, e.g. 2x1: one process per rank under torchrun "
                    "--nproc-per-node S*A (a plain python -m when S*A is "
                    "1); scenario and agent counts must divide the mesh "
                    "axes; rank 0 prints the report")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        s_ax, a_ax = (int(v) for v in args.mesh.lower().split("x"))
        if args.scenarios % s_ax or args.agents % a_ax:
            raise SystemExit(
                f"--mesh {args.mesh}: scenarios ({args.scenarios}) and "
                f"agents ({args.agents}) must divide the axes")
        return _main_mesh(args, s_ax, a_ax)
    device = args.device
    from colaborativempc_tpu_torch.utils import synchronize

    cfg, rollout, state = setup(args.pipeline, args.scenarios, args.agents,
                                args.N, args.steps, args.map, args.noise,
                                device, coupling=args.coupling,
                                sweep=args.sweep)
    t0 = time.perf_counter()
    final, (_, _, metrics) = rollout(state)
    synchronize(device)
    secs = time.perf_counter() - t0
    name = "NL-OCD: " if args.pipeline == "nl" else ""
    print(f"{name}{args.scenarios} scenarios x {args.agents} agents x "
          f"{args.steps} steps on {device} in {secs:.2f} s")
    for line in report(args.pipeline, final, metrics):
        print(line)



def _main_mesh(args, s_ax, a_ax):
    """``main`` over a mesh: joins the process group (``env://`` under
    torchrun; a private one-rank group when S*A is 1; a group the caller
    already joined is used as it is), runs this rank's block and prints
    the report on rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from colaborativempc_tpu_torch.parallel import (
        gather_sharded, initialize_distributed,
    )
    from colaborativempc_tpu_torch.utils import resolve_device, synchronize
    n = s_ax * a_ax
    own, tmp = not dist.is_initialized(), None
    device = resolve_device(args.device)
    if own:
        if "RANK" in os.environ:
            device = initialize_distributed(device)
        elif n == 1:
            tmp = tempfile.mkdtemp()
            device = initialize_distributed(
                device, init_method=f"file://{tmp}/rendezvous", rank=0,
                world_size=1)
        else:
            raise SystemExit(f"--mesh {args.mesh} needs {n} ranks: run it "
                             f"under torchrun --nproc-per-node {n}")
    try:
        if dist.get_world_size() != n:
            raise SystemExit(f"--mesh {args.mesh} needs {n} ranks, have "
                             f"{dist.get_world_size()} (hint: torchrun "
                             f"--nproc-per-node {n})")
        mesh = init_device_mesh(device.type, (s_ax, a_ax),
                                mesh_dim_names=("scen", "agent"))
        _, rollout, state = setup(
            args.pipeline, args.scenarios, args.agents, args.N, args.steps,
            args.map, args.noise, device, coupling=args.coupling,
            sweep=args.sweep, mesh=mesh)
        t0 = time.perf_counter()
        final, metrics = rollout(state)
        synchronize(device)
        secs = time.perf_counter() - t0
        final = gather_sharded(final, mesh)
        # (steps, scenarios, ...) -> (scenarios, steps, ...)
        metrics = type(metrics)(*(t.transpose(0, 1) for t in
                                  gather_sharded(metrics, mesh,
                                                 time_axis=True)))
        if dist.get_rank() == 0:
            name = "NL-OCD: " if args.pipeline == "nl" else ""
            print(f"{name}{args.scenarios} scenarios x {args.agents} agents "
                  f"x {args.steps} steps on {device} over a {args.mesh} "
                  f"mesh in {secs:.2f} s")
            for line in report(args.pipeline, final, metrics):
                print(line)
    finally:
        if own:
            dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
