"""Mesh-sharded OCD coordination: the distributed NL planner over ranks
(PyTorch port of ``colaborativempc_tpu/parallel/ocd.py``).

The reference's distributed deployment is one ROS process per agent with a
barrier-flag and termination protocol (``OCD_ROS_main.py:172-241``). Here
every rank of a ``("scen", "agent")`` mesh runs the single-process
coordination loop, ``runtime/ocd.py _build_ocd_core``, on its block of the
batch: each OCD iteration solves the rank's agents' SQP sub-problems, then
gathers every agent's plan and refined planes over the agent axis, computes
the dual ascent from the gathered plans on every rank (the coupling prices
stay replicated, ``lambdas (S_local, n_ag, n_ag, N)``), and takes a
fleet's convergence as the AND of its ranks' tests, so every rank of a
fleet freezes at the same iteration. The loop runs while any fleet of the
agent group still runs, decided by one all-reduce per iteration; scenario
shards exchange nothing and may run different iteration counts (the JAX
package's loop runs until every scenario shard is done; the per-fleet
freeze makes the extra iterations no-ops there).
"""

from __future__ import annotations

from colaborativempc_tpu_torch.parallel.fleet import (
    _rollout, check_fleet_mesh, shard_fleet_state,
)
from colaborativempc_tpu_torch.parallel.multihost import AgentExchange
from colaborativempc_tpu_torch.runtime.ocd import (
    OCDFleetState, OCDStepMetrics, _build_ocd_core, _coordinate,
)


def make_sharded_nl_ocd_step(track, cfg, mesh):
    """Sharded one-control-step (the whole OCD loop) on this rank's block:
    ``state -> (state, metrics)``; ``ocd_iterations``, ``min_dist``,
    ``min_dist_exec`` and ``lambda_max`` per local scenario. Raises for
    ``ocd.sweep="gauss_seidel"``, without an initialised process group,
    when the mesh does not span the world, or when the agent axis does not
    divide the fleet."""
    if cfg.ocd.sweep == "gauss_seidel":
        raise ValueError(
            "ocd.sweep='gauss_seidel' serialises the agents within an "
            "iteration and cannot run on the agent-sharded mesh step "
            "(agents are parallel ranks); use the single-process "
            "runtime.ocd path or sweep='jacobi'. Measured with stress_study "
            "gs-tradeoff (B=16, N=20) on an NVIDIA H100 80GB HBM3 at 700 W: "
            "Jacobi 38.9 fleet-steps/s at 5.88 OCD iterations, "
            "Gauss-Seidel 14.2 at 5.62, so scaling out keeps Jacobi.")
    check_fleet_mesh(cfg, mesh)
    core = _build_ocd_core(track, cfg, AgentExchange(mesh))

    def step(state: OCDFleetState):
        new_state, metrics, _ = _coordinate(core, state)
        return new_state, metrics

    return step


def make_sharded_nl_ocd_rollout(track, cfg, mesh, steps: int):
    """Fixed-step sharded NL-OCD rollout: ``state -> (final_state,
    metrics)``, the metrics with a leading ``(steps, ...)`` time axis."""
    return _rollout(make_sharded_nl_ocd_step(track, cfg, mesh), steps,
                    OCDStepMetrics)


# an already-batched (leading scenario axis) ``OCDFleetState`` splits as a
# fleet state does; ``lambdas`` stays whole on the agent axis (SCEN_ONLY)
place_ocd_batch = shard_fleet_state


def shard_ocd_state(state: OCDFleetState, n_scen: int,
                    mesh) -> OCDFleetState:
    """Tile a single-fleet ``OCDFleetState`` into ``n_scen`` scenarios
    (on its own device) and take this rank's block."""
    tiled = type(state)(*(x[None].expand((n_scen,) + x.shape)
                          for x in state))
    return shard_fleet_state(tiled, mesh)
