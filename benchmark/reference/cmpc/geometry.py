"""The geometry the copied fleet steps import (the port's
``colaborativempc_tpu_torch/geometry/__init__.py`` without the spline
fitting, which no Highway fleet reaches)."""
from .tracks import Track, make_track, TRACK_NAMES  # noqa: F401
from .frenet import (  # noqa: F401
    wrap_s, segment_index, curvature, halfwidth, frenet_to_cartesian,
    wrap_to_pi, check_lap, check_end, cartesian_to_frenet, check_lane,
    relocalize, select_lane,
)
from .planes import (  # noqa: F401
    compute_hyperplanes, plane_signed_distance, separation_weights,
)
