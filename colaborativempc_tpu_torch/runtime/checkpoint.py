"""Mid-run checkpoint and resume of the outer control loop (PyTorch port).

Counterpart of ``colaborativempc_tpu/runtime/checkpoint.py``: the whole
carried fleet state (trajectories, duals, ADMM splitting variables,
adaptive-rho state) and the step counter round-trip through one ``.npz``,
so an experiment can be stopped and resumed exactly.

The arrays are keyed by the record's field names. A checkpoint whose fields
differ from the template's (a record that gained or lost a field since it
was written) raises a ``ValueError`` that names them — where the JAX
package keys by leaf index and fails on the leaf count alone.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

_FIELD = "field_"


def save_checkpoint(path: str, state, step: int, meta: dict | None = None):
    """Write a ``FleetState``/``OCDFleetState`` and the step counter."""
    payload = {_FIELD + f: getattr(state, f).detach().cpu().numpy()
               for f in state._fields}
    payload["__step"] = np.asarray(step)
    payload["__record"] = np.asarray(type(state).__name__)
    for k, v in (meta or {}).items():
        payload[f"meta_{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, template) -> Tuple[object, int]:
    """Restore a record with ``template``'s fields, each on the device and
    in the dtype of the template's field. Returns ``(state, step)``."""
    with np.load(path) as data:
        saved = [k[len(_FIELD):] for k in data.files if k.startswith(_FIELD)]
        want = list(template._fields)
        if sorted(saved) != sorted(want):
            missing = [f for f in want if f not in saved]
            extra = [f for f in saved if f not in want]
            raise ValueError(
                f"checkpoint {path!r} does not match "
                f"{type(template).__name__}: missing fields {missing}, "
                f"unknown fields {extra}")
        fields = {}
        for f in want:
            ref = getattr(template, f)
            fields[f] = torch.as_tensor(data[_FIELD + f]).to(
                device=ref.device, dtype=ref.dtype)
        step = int(data["__step"])
    return type(template)(**fields), step
