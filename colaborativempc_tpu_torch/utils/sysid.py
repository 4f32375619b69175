"""Small analysis utilities from the reference's misc toolbox (PyTorch
port of ``colaborativempc_tpu/utils/sysid.py``).

- ``regression``: ridge least-squares estimation of linear dynamics from
  recorded data (reference ``utilities/misc.py:51-74``), used for system
  identification of (A, B) from trajectories.
- ``gbellmf``: generalised bell membership function
  (``utilities/misc.py:129-141``).
"""

from __future__ import annotations

import torch


def regression(x: torch.Tensor, u: torch.Tensor, lamb: float):
    """Estimate ``x_{k+1} ~ A x_k + B u_k`` by ridge regression.

    Args:
      x: (T, n) states; u: (T, m) inputs; lamb: ridge coefficient.
    Returns: (A, B, error) where error stacks per-column (max, min)
    residuals — same contract as the reference.
    """
    Y = x[2:, :]
    X = torch.cat([x[1:-1, :], u[1:-1, :]], dim=1)
    n = x.shape[1]
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    Q = torch.linalg.inv(X.T @ X + lamb * eye)
    W = Q @ (X.T @ Y)
    A = W.T[:, :n]
    B = W.T[:, n:]
    E = X @ W - Y
    return A, B, torch.stack([E.amax(dim=0), E.amin(dim=0)])


def gbellmf(x, a, b, c):
    """Generalised bell membership ``1 / (1 + ((x-c)/a)^(2b))``; at
    ``x == c`` it is 0.5 for ``b == 0`` and 0 for ``b < 0``."""
    t = ((x - c) / a) ** 2
    b = torch.as_tensor(b, dtype=t.dtype, device=t.device)
    return torch.where((t == 0) & (b == 0), 0.5,
                       torch.where((t == 0) & (b < 0), 0.0,
                                   1.0 / (1.0 + t ** b)))
