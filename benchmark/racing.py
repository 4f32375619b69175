"""What a traced run of the racing family says that the fleets' readers do
not: the device's idle time split by the racing step's layers, the SQP
loop's ADMM iterations and the MPCC build kernel's share of its roofline.

The racing step's spans (``runtime/racing.py``, ``planners/mpcc.py``) name
their layer ``cmpc.mpcc.*`` (the planner: the SQP loop and its builds),
``cmpc.admm.*`` (the ADMM loop) and otherwise the rollout (``cmpc.step``,
``cmpc.guess``, ``cmpc.plant``). ``benchmark/spans.py`` charges only
``lpv`` and ``nl`` spans to the planner, so the split here hands it the
planner's spans renamed to ``cmpc.nl.*``. Every reader returns None where
the run has nothing to read.
"""

from __future__ import annotations

from benchmark import readers, spans
from benchmark import trace as tl
from benchmark.reference.cmpc.tracks import make_track
from benchmark.roofline import bound_s
from benchmark.roofline import mpcc as rl_mpcc

LAYER_OF_PART = {"admm": "admm", "mpcc": "planner"}
BUILD_KERNEL = "mpcc_qp_kernel"


def layer(name: str) -> str:
    """The layer a racing span's own time is charged to: ``admm``,
    ``planner`` or ``rollout``."""
    parts = name.split(".")
    return LAYER_OF_PART.get(parts[1] if len(parts) > 2 else "", "rollout")


def idle_split(sp: list, evs, lo: float, hi: float) -> dict:
    """Idle seconds of ``[lo, hi]`` by the racing layer whose own time the
    host was in, and ``spans.OUTSIDE`` where no program span was open; the
    values sum to the window's idle time. ``spans.idle_split`` itself, on
    the spans renamed to the part it charges alike: ``cmpc.mpcc.*`` to
    ``cmpc.nl.*`` (the planner)."""
    named = [s._replace(name="cmpc.nl." + s.name.split(".", 2)[2])
             if layer(s.name) == "planner" else s for s in sp]
    return spans.idle_split(named, evs, lo, hi)


def idle_pct(run, name: str):
    """Share of the traced window in which the device was idle while the
    host was in racing layer ``name``'s own time, %; None where the window
    has no span of that layer. Notes the share outside the program and the
    sum of the split against ``device_idle_pct``."""
    sp = spans.program_spans(run)
    if sp is None or not any(layer(s.name) == name for s in sp):
        return None
    t = run.trace
    pct = {k: 100.0 * v / t.window_s
           for k, v in idle_split(sp, t.events, t.lo, t.hi).items()}
    run.note(f"racing idle_{name}_pct {pct.get(name, 0.0):.4f}; "
             f"{spans.OUTSIDE} {pct.get(spans.OUTSIDE, 0.0):.4f}; the split "
             f"sums to {sum(pct.values()):.4f}, device_idle_pct "
             f"{readers.device_idle_pct(run):.4f}")
    return pct.get(name, 0.0)


def admm_iters_per_step(run):
    """ADMM iterations of the SQP loop per race-step, mean over the
    window (the step's own count)."""
    if run.conf["family"] != "mpcc" or run.steps == 0:
        return None
    return float(run.efforts.mean())


def mpcc_build_roofline(run):
    """The MPCC stage-QP builds' share of their roofline: the least time of
    every traced build (``roofline/mpcc.py build_counts``, one per launch
    of the build kernel) over the kernel's device time."""
    t = run.trace
    if t is None or run.conf["family"] != "mpcc":
        return None
    counts, secs = tl.kernels_matching(t.events, (BUILD_KERNEL,))
    n = counts[BUILD_KERNEL]
    if n == 0 or secs <= 0:
        return None
    c = run.conf["mpcc"]
    track = make_track(c["map_type"], device="cpu")
    bound, by = bound_s(*rl_mpcc.build_counts(run.fleets, c["N"],
                                              track.n_lanes,
                                              track.n_segments))
    run.note(f"{BUILD_KERNEL}: {n} launches, {secs:.6f} s of device time, "
             f"least {bound:.9f} s each, bound by {by} (H100 SXM peaks; "
             f"the card's power limit is in the context line)")
    return 100.0 * n * bound / secs
