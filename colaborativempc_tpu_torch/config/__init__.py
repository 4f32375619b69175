from colaborativempc_tpu_torch.config.params import (
    ModelParams, SysLimits, Gains, OCDConfig, SolverConfig, ExperimentConfig,
    lpv_gains, nl_gains, X0_DATABASE, x0_database,
)
