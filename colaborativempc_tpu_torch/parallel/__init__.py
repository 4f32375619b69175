from colaborativempc_tpu_torch.parallel.fleet import (
    batch_fleet_state, gather_sharded, make_sharded_lpv_rollout,
    make_sharded_lpv_step, shard_fleet_state,
)
from colaborativempc_tpu_torch.parallel.multihost import (
    AgentExchange, fleet_mesh, initialize_distributed,
)
from colaborativempc_tpu_torch.parallel.ocd import (
    make_sharded_nl_ocd_rollout, make_sharded_nl_ocd_step, place_ocd_batch,
    shard_ocd_state,
)
