from colaborativempc_tpu_torch.runtime.simulate import (
    FleetState, StepMetrics, ExperimentResult, make_lpv_fleet_step,
    make_lpv_fleet_rollout, init_lpv_fleet, resolve_single_fleet_schedule,
    run_lpv_experiment,
)
from colaborativempc_tpu_torch.runtime.ocd import (
    OCDFleetState, OCDStepMetrics, NLExperimentResult, make_nl_ocd_step,
    make_nl_ocd_rollout, make_nl_ocd_rollout_gains, make_nl_ocd_instrumented,
    init_nl_fleet, run_nl_experiment,
)
from colaborativempc_tpu_torch.runtime.battery import (
    BatteryResult, NLBatteryResult, gain_grid, run_lpv_battery,
    run_nl_battery,
)
from colaborativempc_tpu_torch.runtime.checkpoint import (
    save_checkpoint, load_checkpoint,
)
from colaborativempc_tpu_torch.runtime.io import (
    ExperimentIO, load_lambdas, load_experiment,
)
