from colaborativempc_tpu_torch.utils.device import resolve_device, synchronize
from colaborativempc_tpu_torch.utils.sysid import regression, gbellmf
# rollout_euler / rollout_rk4 are imported from utils.rollout: the geometry
# package imports utils.device, so utils cannot import geometry here.
