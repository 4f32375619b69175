"""What the metric files (``benchmark/metrics/<name>.py``) read from a
finished run: the window's host clock, the program's launch counters and
step outputs, and the profiler's trace. Every function returns None where
the run has nothing for it to read (no trace, no device time, a counter
that did not move), never 0 for a share."""

from __future__ import annotations

import numpy as np

from benchmark import roofline as rl
from benchmark import trace as tl

EPOCH_KERNELS = ("admm_epoch_kernel", "epoch_data_kernel")
BUILD_KERNELS = ("nl_qp_kernel",)


def solves_per_s(run):
    """Agent QPs solved per second: fleets x agents x control steps
    completed over the whole window."""
    return run.fleet_steps * run.system.n_agents / run.window_s


def fleet_steps_per_s(run):
    """Fleet control steps completed per second over the whole window."""
    return run.fleet_steps / run.window_s


def step_ms(run, q: float):
    """The ``q``-th percentile of every step's time in the window (host
    clock around a step that ends in a synchronise), ms; courses only."""
    if len(run.step_times) == 0:
        return None
    return float(np.percentile(np.asarray(run.step_times) * 1e3, q))


def device_idle_pct(run):
    """Share of the traced window in which nothing ran on the device."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    busy = tl.busy_seconds(t.events, t.lo, t.hi)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / t.window_s)


def _shape(run) -> dict:
    """The ADMM epoch's shape of the run's configuration, as its family
    file's ``epoch_shape`` gives it: ``N, nz, nc, mr, agents,
    epoch_len``."""
    return run.system.family.epoch_shape(run.conf)


def _epoch_work(run):
    s = _shape(run)
    return rl.epoch_work(run.fleets * s["agents"], s["N"], s["nz"], s["nc"],
                         s["mr"], s["epoch_len"])


def _build_work(run):
    from benchmark.reference.cmpc.tracks import make_track
    conf = run.conf["experiment"]
    track = make_track(conf["map_type"], device="cpu")
    return rl.nl_build_counts(run.fleets * conf["n_agents"], conf["N"],
                              conf["n_agents"], conf["coupling"],
                              track.n_lanes, track.n_segments)


def _roofline(run, kernels, work, count_of):
    t = run.trace
    if t is None:
        return None
    counts, secs = tl.kernels_matching(t.events, kernels)
    n = counts[count_of]
    if n == 0 or secs <= 0:
        return None
    nbytes, flops = work
    bound, by = rl.bound_s(nbytes, flops)
    run.note(f"{'+'.join(kernels)}: {n} launches, {secs:.6f} s of device "
             f"time, least {bound:.9f} s each, bound by {by} "
             f"(H100 SXM peaks; the card's power limit is in the context "
             f"line)")
    return 100.0 * n * bound / secs


def admm_epoch_roofline(run):
    """The ADMM epochs' share of their roofline: the least time of every
    traced epoch's work (``roofline.epoch_work``, one per launch of the
    epoch kernel) over the device time of the epoch-data and epoch
    kernels."""
    return _roofline(run, EPOCH_KERNELS, _epoch_work(run),
                     "admm_epoch_kernel")


def nl_build_roofline(run):
    """The NL stage-QP builds' share of their roofline: the least time of
    every traced build (``roofline.nl_build_counts``) over the device time
    of the build kernel."""
    if run.conf["family"] != "nl":
        return None
    return _roofline(run, BUILD_KERNELS, _build_work(run), "nl_qp_kernel")


def epochs_per_step(run):
    """ADMM epochs per control step of the batch, from the program's
    launch counter of the epoch kernel over the whole window."""
    n = run.counters.get("admm_epoch_batched.launches", 0)
    if n == 0 or run.steps == 0:
        return None
    return n / run.steps


def ocd_iters_per_step(run):
    """OCD iterations per control step: the mean over the window's steps
    of the batch's largest (a lock-step batch waits for its slowest
    fleet)."""
    if run.conf["family"] != "nl" or run.steps == 0:
        return None
    return float(np.mean(run.efforts.max(axis=1)))

