"""Process groups, the fleet mesh and the agent exchange (PyTorch port of
``colaborativempc_tpu/parallel/multihost.py``).

Scale-out is one process per rank, SPMD: every rank runs the same program
on its own block of the scenario batch and of the fleet. The JAX package
builds one global mesh of devices and runs collectives inside a
``shard_map``; here ``torch.distributed`` wires the processes together,
a ``DeviceMesh`` with axes ``("scen", "agent")`` names each rank's
coordinates, and the agent axis's process group carries the per-step plan
exchange (``AgentExchange``). Scenario shards exchange nothing inside a
step.

Backends follow the device: NCCL for CUDA (one rank per card), gloo for
the CPU. Ranks that share one card over gloo are asked for explicitly,
with ``backend="gloo"``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from colaborativempc_tpu_torch.utils.device import resolve_device

# the fleet mesh's axes: scenario shards and agent shards
SCEN, AGENT = "scen", "agent"


def initialize_distributed(device="cuda", init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           timeout: datetime.timedelta =
                           datetime.timedelta(minutes=10),
                           backend: Optional[str] = None) -> torch.device:
    """Join this process to the default process group and return the
    device its rank computes on.

    ``init_method`` defaults to ``env://`` (``torchrun`` sets ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and the master's address); otherwise pass
    it (``file://...`` or ``tcp://localhost:<port>``) with ``rank`` and
    ``world_size``. The backend follows ``device``: ``nccl`` for ``cuda``,
    where each rank takes the card ``LOCAL_RANK`` (or its rank), and
    ``gloo`` for ``cpu``. ``backend="gloo"`` with ``device="cuda"`` runs
    ranks that share card 0 over gloo. The default ``cuda`` raises without
    a card; a process group that is already initialised raises too."""
    if dist.is_initialized():
        raise RuntimeError("the default process group is already initialised")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if init_method is None:
        init_method = "env://"
    else:
        kw = dict(rank=rank, world_size=world_size)
    if dev.type == "cuda":
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK",
                                       rank if rank is not None else 0))
            dev = torch.device("cuda", local)
            kw["device_id"] = dev
        else:
            dev = torch.device("cuda", 0 if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method=init_method,
                            timeout=timeout, **kw)
    return dev


def fleet_mesh(n_agents: int) -> Tuple[object, int]:
    """A ``(scenarios x agents)`` ``DeviceMesh`` over every rank of the
    default group: the agent axis gets the largest divisor of the world
    size that also divides ``n_agents`` (so a fleet is split across ranks),
    the rest becomes the scenario axis. Returns ``(mesh,
    n_scenario_shards)``. The mesh's device type is ``cuda`` under NCCL and
    ``cpu`` otherwise. Raises without an initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh
    require_group()
    n = dist.get_world_size()
    agent_ax = 1
    for f in range(min(n_agents, n), 0, -1):
        if n % f == 0 and n_agents % f == 0:
            agent_ax = f
            break
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (n // agent_ax, agent_ax),
                            mesh_dim_names=(SCEN, AGENT))
    return mesh, n // agent_ax


def require_group() -> None:
    """Raise unless the default process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the sharded paths need an initialised process group: call "
            "parallel.initialize_distributed (or "
            "torch.distributed.init_process_group) first")


def check_mesh(mesh) -> None:
    """Raise unless a process group is initialised and ``mesh`` spans every
    rank of it."""
    require_group()
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} ranks, the process "
                         f"group {dist.get_world_size()}")


def mesh_position(mesh) -> int:
    """This rank's index in the row-major flattening of ``mesh``."""
    flat = mesh.mesh.flatten().tolist()
    return flat.index(dist.get_rank())


def _gather(t: torch.Tensor, group) -> list:
    """``all_gather`` of ``t`` over ``group``, in group-rank order; a bool
    tensor travels as uint8 (gloo reduces no bools)."""
    size = dist.get_world_size(group)
    src = t.contiguous()
    if src.dtype == torch.bool:
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    if t.dtype == torch.bool:
        parts = [p.bool() for p in parts]
    return parts


def gather_over_mesh(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` in the row-major order
    of ``mesh``'s coordinates (the whole mesh read as one axis)."""
    parts = _gather(t, None)
    return torch.cat([parts[r] for r in mesh.mesh.flatten().tolist()],
                     dim=dim)


def gather_axis(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate the blocks of ``t`` held along mesh axis ``axis`` on
    ``dim``, in the order of the axis's coordinates."""
    group = mesh.get_group(axis)
    if dist.get_world_size(group) == 1:
        return t
    return torch.cat(_gather(t, group), dim=dim)


def _rank_entry(fn, rank, world_size, args, results):
    torch.set_num_threads(1)        # local ranks share the host's cores
    try:
        results.put((rank, fn(rank, world_size, *args)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local_ranks(fn, world_size: int, args=(), timeout: float = 600.0):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    on this host (``spawn``; ``fn`` is a module-level function that joins
    the process group itself, e.g. through :func:`initialize_distributed`)
    and return their results in rank order. The results travel pickled,
    so a rank returns numpy arrays or plain values, not tensors. Each rank
    runs one torch thread. A rank that fails, or the ``timeout`` (seconds)
    running out, kills every rank and raises ``RuntimeError``."""
    import multiprocessing as mp
    import queue
    import time
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                r, v = results.get(timeout=0.2)
                out[r] = v
                continue
            except queue.Empty:
                pass
            failed = [(i, p.exitcode) for i, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"local ranks failed (rank, exit code): "
                                   f"{failed}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"local ranks passed their {timeout} s "
                                   f"deadline; ranks done: {sorted(out)}")
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"a local rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [out[r] for r in range(world_size)]


class AgentExchange:
    """The per-step plan exchange over the agent axis of ``mesh``: the
    sharded counterpart of ``runtime/simulate.py LocalExchange``. A rank
    holds agents ``a * A .. a * A + A - 1`` of its fleets, where ``a`` is
    its agent coordinate and ``A`` its agent count; ``gather`` concatenates
    the agent blocks on dim 1 in coordinate order. Every call is a
    collective, so every rank of the agent group makes the same calls in
    the same order, world size 1 included."""

    def __init__(self, mesh):
        self.group = mesh.get_group(AGENT)
        self.a_idx = mesh.get_local_rank(AGENT)
        # a group rank is not a mesh coordinate: the gathers concatenate in
        # group-rank order, which must be the agent coordinate's
        if dist.get_rank(self.group) != self.a_idx:
            raise RuntimeError(
                f"agent group rank {dist.get_rank(self.group)} is not the "
                f"agent coordinate {self.a_idx}")

    def gids(self, n_local: int, device) -> torch.Tensor:
        return self.a_idx * n_local + torch.arange(n_local, device=device)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(_gather(t, self.group), dim=1)

    def all_agents(self, flag: torch.Tensor) -> torch.Tensor:
        v = flag.to(torch.int32)
        dist.all_reduce(v, op=dist.ReduceOp.MIN, group=self.group)
        return v.bool()

    def any_fleet(self, flag: torch.Tensor) -> bool:
        v = flag.any().to(torch.int32).reshape(1)
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
        return bool(v)
