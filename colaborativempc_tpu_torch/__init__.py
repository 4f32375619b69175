"""PyTorch/CUDA port of the collaborative-MPC framework.

A second package beside ``colaborativempc_tpu`` (the JAX reference, which
it never imports). It covers the collaborative LPV fleet step end to end
(track geometry, the LPV bicycle model, stage-QP assembly, the
Riccati+ADMM QP engine with a hand-written CUDA ADMM-epoch kernel,
``csrc/lqr_kernels.cu``, the safety layer, the batched fleet rollout) and
the NL-OCD family (the SQP planner and the dual-coordination loop over the
same engine), with the closed-loop experiment runners, batteries, IO and
checkpoints.

``vmap`` over agents and scenarios is a written-out leading batch axis; a
kernel runs whenever its tensors are on a CUDA device, and its plain
PyTorch twin runs on CPU tensors.
"""

import torch as _torch

# The Riccati path runs in full float32 (the JAX package pins
# Precision.HIGHEST for the same reason): TF32 keeps ~3 decimal digits,
# which the P-matrix products at long horizons cannot afford.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
