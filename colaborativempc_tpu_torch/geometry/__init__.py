from colaborativempc_tpu_torch.geometry.tracks import (
    Track, make_track, TRACK_NAMES,
)
from colaborativempc_tpu_torch.geometry.frenet import (
    wrap_s, segment_index, curvature, halfwidth, frenet_to_cartesian,
    wrap_to_pi, check_lap, check_end, cartesian_to_frenet, check_lane,
    relocalize, select_lane,
)
from colaborativempc_tpu_torch.geometry.planes import (
    compute_hyperplanes, plane_signed_distance, separation_weights,
)
from colaborativempc_tpu_torch.geometry.spline import (
    remove_outliers, fit_centerline, halfwidth_from_boundaries,
    load_track_json, track_from_json, project_on_spline,
)
