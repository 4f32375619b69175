from colaborativempc_tpu_torch.dynamics.bicycle import (
    NX, NU, LOW_VEL_THRESH, lpv_coeffs, lpv_matrices, f_continuous,
    discretize_euler, lpv_discrete_horizon,
)
