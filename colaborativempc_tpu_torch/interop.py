"""Carry values across from the JAX package, as numpy arrays.

Each ``*_from_numpy`` takes an object with the record's field names —
the JAX package's NamedTuple itself (``np.asarray`` reads its arrays) or a
dict of numpy arrays — and builds the port's record on ``device``: float
arrays in ``dtype``, integer and boolean arrays in their own type. Each
``*_to_numpy`` turns a port record into a dict of numpy arrays (nested
records into nested dicts), which the ``*_from_numpy`` functions also take.
This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from colaborativempc_tpu_torch.config.params import Gains
from colaborativempc_tpu_torch.geometry.tracks import Track
from colaborativempc_tpu_torch.ops.admm import ADMMEpochData, StageQP
from colaborativempc_tpu_torch.ops.lqr import LQRCost, LQRDynamics
from colaborativempc_tpu_torch.runtime.ocd import OCDFleetState
from colaborativempc_tpu_torch.runtime.simulate import FleetState
from colaborativempc_tpu_torch.utils.device import resolve_device


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(v, device, dtype):
    a = np.asarray(v)
    if np.issubdtype(a.dtype, np.floating):
        return torch.tensor(a, dtype=dtype, device=device)
    return torch.tensor(a, device=device)  # int / bool keep their type


def _record(cls, obj, device, dtype, nested=None):
    dev = resolve_device(device)
    nested = nested or {}
    vals = {}
    for f in cls._fields:
        v = _get(obj, f)
        if f in nested:
            vals[f] = _record(nested[f], v, dev, dtype)
        else:
            vals[f] = None if v is None else _tensor(v, dev, dtype)
    return cls(**vals)


def track_from_numpy(track, device="cpu", dtype=torch.float32) -> Track:
    return _record(Track, track, device, dtype)


def gains_from_numpy(gains, device="cpu", dtype=torch.float32) -> Gains:
    """One set of gains, or a batch whose arrays carry a leading batch
    axis. A scalar ``wq`` stays a float; a batch of them becomes a ``(B,)``
    tensor."""
    dev = resolve_device(device)
    wq = np.asarray(_get(gains, "wq"))
    return Gains(*(_tensor(_get(gains, f), dev, dtype)
                   for f in ("q", "qs", "r", "dr")),
                 wq=float(wq) if wq.ndim == 0 else _tensor(wq, dev, dtype))


def fleet_state_from_numpy(state, device="cpu",
                           dtype=torch.float32) -> FleetState:
    return _record(FleetState, state, device, dtype)


def ocd_state_from_numpy(state, device="cpu",
                         dtype=torch.float32) -> OCDFleetState:
    return _record(OCDFleetState, state, device, dtype)


def stage_qp_from_numpy(qp, device="cpu", dtype=torch.float32) -> StageQP:
    return _record(StageQP, qp, device, dtype,
                   nested={"dyn": LQRDynamics, "cost": LQRCost})


def epoch_data_from_numpy(data, device="cpu",
                          dtype=torch.float32) -> ADMMEpochData:
    return _record(ADMMEpochData, data, device, dtype)


def to_numpy(record) -> dict:
    """Any port record (NamedTuple of tensors, possibly nested) as a dict of
    numpy arrays; non-tensor fields are kept as they are."""
    out = {}
    for f in record._fields:
        v = getattr(record, f)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out[f] = to_numpy(v)
        elif isinstance(v, torch.Tensor):
            out[f] = v.detach().cpu().numpy()
        else:
            out[f] = v
    return out


track_to_numpy = to_numpy
gains_to_numpy = to_numpy
fleet_state_to_numpy = to_numpy
ocd_state_to_numpy = to_numpy
stage_qp_to_numpy = to_numpy
epoch_data_to_numpy = to_numpy
