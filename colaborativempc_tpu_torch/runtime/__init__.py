from colaborativempc_tpu_torch.runtime.simulate import (
    FleetState, StepMetrics, make_lpv_fleet_step, make_lpv_fleet_rollout,
    init_lpv_fleet,
)
