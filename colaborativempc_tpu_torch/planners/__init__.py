from colaborativempc_tpu_torch.planners.lpv import (
    LPVSolution, SOFT_WEIGHT_CAP, build_lpv_qp, lpv_solve,
)
from colaborativempc_tpu_torch.planners.nl import (
    NLSolution, build_nl_qp, nl_solve,
)
from colaborativempc_tpu_torch.planners.mpcc import (
    MPCCBounds, MPCCConfig, MPCCGains, MPCCNormalization, MPCCSolution,
    build_mpcc_qp, mpcc_config_from_json, mpcc_config_to_json, mpcc_solve,
)
