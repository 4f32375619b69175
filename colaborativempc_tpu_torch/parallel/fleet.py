"""Scenario batching of fleet states (PyTorch port of the batching part of
``colaborativempc_tpu/parallel/fleet.py``; sharding is not ported yet)."""

from __future__ import annotations

from colaborativempc_tpu_torch.utils.device import resolve_device


def batch_fleet_state(state, n_scen: int, device="cuda"):
    """Tile a single-fleet ``(n_ag, ...)`` state — a ``FleetState`` or an
    ``OCDFleetState`` — into a scenario batch ``(n_scen, n_ag, ...)`` on
    ``device`` (each scenario its own copy; the default ``cuda`` raises
    without a card)."""
    dev = resolve_device(device)
    return type(state)(*(
        x.to(dev)[None].expand((n_scen,) + x.shape).clone() for x in state))
