from colaborativempc_tpu_torch.dynamics.bicycle import (
    NX, NU, LOW_VEL_THRESH, lpv_coeffs, lpv_matrices, f_continuous,
    discretize_euler, lpv_discrete_horizon, step_euler, step_rk4,
)
from colaborativempc_tpu_torch.dynamics.pacejka import (
    PacejkaParams, slip_angles, tire_forces, f_continuous_pacejka,
    friction_ellipse_residual, slip_angle_residuals, linearize_pacejka,
    tire_row_jacobians,
)
