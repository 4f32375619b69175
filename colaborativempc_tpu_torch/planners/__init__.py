from colaborativempc_tpu_torch.planners.lpv import (
    LPVSolution, SOFT_WEIGHT_CAP, build_lpv_qp, lpv_solve,
)
from colaborativempc_tpu_torch.planners.nl import (
    NLSolution, build_nl_qp, nl_solve,
)
