"""Scenario batching and mesh-sharded fleet execution (PyTorch port of
``colaborativempc_tpu/parallel/fleet.py``).

The reference deploys one ROS process per agent and exchanges plans over
TCPROS with hand-rolled barrier flags (``LPV_ROS_main.py:124-151``). Here
every rank of a ``("scen", "agent")`` ``DeviceMesh`` (``parallel/
multihost.py fleet_mesh``) runs the same LPV fleet step as the single
process, ``runtime/simulate.py _lpv_step``, on its block of the batch:

    x0: (S_local, A_local, 9), x_pred: (S_local, A_local, N+1, 9), ...

with the per-step (X, Y) plan and hold-flag exchange, the separation
filter's anchors and candidates and the fleet-wide distances gathered over
the agent axis's process group (``AgentExchange``). The single-process
step is the same code with the world-size-1 exchange, so a ``(1, 1)`` mesh
reproduces it bit for bit. Scenario shards exchange nothing.
"""

from __future__ import annotations

import torch

from colaborativempc_tpu_torch.parallel.multihost import (
    AGENT, SCEN, AgentExchange, check_mesh, gather_axis,
)
from colaborativempc_tpu_torch.runtime.simulate import StepMetrics, _lpv_step
# the scenario tiling lives beside FleetState; re-exported under the JAX
# module's path
from colaborativempc_tpu_torch.runtime.simulate import (  # noqa: F401
    batch_fleet_state,
)

# fields held whole along the agent axis (replicated over its ranks)
SCEN_ONLY = frozenset({"lambdas", "min_dist", "min_dist_exec",
                       "ocd_iterations", "lambda_max"})


def _axis(mesh, name: str):
    """(this rank's coordinate, size) of mesh axis ``name``."""
    return (mesh.get_local_rank(name),
            mesh.shape[mesh.mesh_dim_names.index(name)])


def check_fleet_mesh(cfg, mesh) -> None:
    """Raise unless a process group is initialised, ``mesh`` spans every
    rank of it, and its agent axis divides the fleet."""
    check_mesh(mesh)
    _, size = _axis(mesh, AGENT)
    if cfg.n_agents % size:
        raise ValueError(f"{cfg.n_agents} agents do not divide the agent "
                         f"axis ({size} ranks)")


def shard_fleet_state(record, mesh):
    """This rank's block of a scenario-batched record ``(S, n_ag, ...)``
    (a ``FleetState``, or any record of the sharded paths): the scenario
    axis split over the mesh's ``"scen"`` axis, the agent axis over its
    ``"agent"`` axis (fields in :data:`SCEN_ONLY` stay whole there). Each
    block is a copy on the record's device; raises where an axis does not
    divide."""
    out = []
    for f, x in zip(record._fields, record):
        for dim, name in ((0, SCEN), (1, AGENT)):
            if dim == 1 and f in SCEN_ONLY:
                continue
            idx, size = _axis(mesh, name)
            if x.shape[dim] % size:
                raise ValueError(f"{f}: {x.shape[dim]} rows on dim {dim} "
                                 f"do not divide mesh axis {name!r} "
                                 f"({size} ranks)")
            k = x.shape[dim] // size
            x = x.narrow(dim, idx * k, k)
        out.append(x.clone())
    return type(record)(*out)


def gather_sharded(record, mesh, time_axis: bool = False):
    """The global record back on every rank: each field's blocks gathered
    over the agent axis on the agent dim (fields in :data:`SCEN_ONLY` are
    whole there already), then over the scenario axis. ``time_axis``: the
    record carries a leading time axis (a sharded rollout's metrics)."""
    d = 1 if time_axis else 0
    out = []
    for f, x in zip(record._fields, record):
        if f not in SCEN_ONLY:
            x = gather_axis(x, mesh, AGENT, d + 1)
        out.append(gather_axis(x, mesh, SCEN, d))
    return type(record)(*out)


def make_sharded_lpv_step(track, cfg, mesh):
    """The sharded one-control-step function: ``state -> (state,
    metrics)`` on this rank's block ``(S_local, A_local, ...)``
    (:func:`shard_fleet_state`); ``min_dist`` and ``min_dist_exec`` are
    per local scenario, the rest per local (scenario, agent). Every rank
    of the mesh calls it in lock-step. Raises without an initialised
    process group, when the mesh does not span the world, or when the agent
    axis does not divide the fleet."""
    check_fleet_mesh(cfg, mesh)
    return _lpv_step(track, cfg, AgentExchange(mesh))


def _rollout(step, steps: int, metrics_type):
    """``state -> (final_state, metrics)`` over ``steps`` calls of
    ``step``, the metrics stacked on a leading ``(steps, ...)`` time axis."""
    def rollout(state):
        ms = []
        for _ in range(steps):
            state, m = step(state)
            ms.append(m)
        return state, metrics_type(*(torch.stack(f) for f in zip(*ms)))

    return rollout


def make_sharded_lpv_rollout(track, cfg, mesh, steps: int):
    """Fixed-step sharded closed-loop rollout: ``state -> (final_state,
    metrics)``, the metrics with a leading ``(steps, ...)`` time axis — the
    layout of the JAX package's sharded rollout."""
    return _rollout(make_sharded_lpv_step(track, cfg, mesh), steps,
                    StepMetrics)
