from colaborativempc_tpu_torch.ops.lqr import (
    LQRCost, LQRDynamics, LQRFactors,
    lqr_factorize, lqr_affine_solve, lqr_solve,
)
from colaborativempc_tpu_torch.ops.admm import (
    StageQP, ADMMSolution, ADMMEpochData, build_admm_cost, admm_epoch_inputs,
    admm_solve,
)
from colaborativempc_tpu_torch.ops.cuda_lqr import (
    admm_epoch_batched, admm_epoch_batched_plain,
    lqr_affine_solve_batched, lqr_affine_solve_batched_plain,
)
