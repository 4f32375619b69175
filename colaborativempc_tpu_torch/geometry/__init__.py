from colaborativempc_tpu_torch.geometry.tracks import (
    Track, make_track, TRACK_NAMES,
)
from colaborativempc_tpu_torch.geometry.frenet import (
    wrap_s, segment_index, curvature, halfwidth, frenet_to_cartesian,
    wrap_to_pi, check_lap, check_end,
)
from colaborativempc_tpu_torch.geometry.planes import (
    compute_hyperplanes, separation_weights,
)
