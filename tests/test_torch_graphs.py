"""The graphed phases (``utils/graphs.py``) of the racing step
(``runtime/racing.py _guess_phase`` / ``_advance_phase``) and of the LPV
fleet step (``runtime/simulate.py _hold_phase`` / ``_plant_phase``) on
the CPU.

A CUDA graph records whatever the card is asked to do while it captures,
so a phase that built a tensor from Python data on the card (a host to
device copy) or read a value back (``float(t)``, ``bool(t)``) would fail
to record or replay a stale number. No card is needed to see that: the
ops each phase dispatches are listed here on CPU tensors (racing at N=8
and the benchmark's N=60, from a cold start and from a warm one; LPV at
N=8, with dynamic lanes, and at the benchmark's N=125), and none of them
may move data between host and device. The replay against the op-by-op
step, bit for bit, is tests/test_torch_cuda.py's
``test_cuda_graphed_race_keeps_the_bits`` and
``test_cuda_graphed_lpv_step_keeps_the_bits``.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch.geometry import make_track
from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
from colaborativempc_tpu_torch.runtime import racing, simulate
from colaborativempc_tpu_torch.utils.graphs import graphed

torch.set_num_threads(2)

# ops that move data between host and device, or read a tensor's value
# on the host: none of them may run inside a recorded phase
HOST_OPS = {"_local_scalar_dense", "item", "lift_fresh", "lift_fresh_copy",
            "_to_copy", "copy_", "to", "nonzero", "is_nonzero", "equal",
            "masked_select", "unique", "_unique2"}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []
        self.kwargs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        self.kwargs.append(dict(kwargs or {}))
        return func(*args, **(kwargs or {}))


class _Listing:
    """Stands in for ``graphed``: runs the phase and lists its ops."""
    seen = {}

    def __init__(self, fn, counter=None):
        self.fn = fn

    def __call__(self, *args):
        with _Ops() as ops:
            out = self.fn(*args)
        _Listing.seen.setdefault(self.fn.func.__name__, []).append(
            (ops.names, args, out, ops.kwargs))
        return out


@pytest.fixture(scope="module", params=[8, 60])
def listed(request):
    """Three steps of one race at N (the first cold, then warm), the ops
    of each phase call."""
    mp = pytest.MonkeyPatch()
    mp.setattr(racing, "graphed", _Listing)
    _Listing.seen = {}
    try:
        cfg = MPCCConfig(N=request.param, dt=0.02, n_sqp=2, sqp_mixing=0.8,
                         admm_iters=60, epoch_len=15, assoc=False)
        track = make_track(cfg.map_type, device="cpu", dtype=torch.float32)
        step = racing.make_mpcc_step(track, cfg)
        state = racing.init_mpcc(track, cfg, device="cpu")
        for _ in range(3):
            state, _ = step(state)
    finally:
        mp.undo()
    return cfg, dict(_Listing.seen)


@pytest.mark.parametrize("phase", ["_guess_phase", "_advance_phase"])
def test_racing_phases_move_nothing_between_host_and_device(listed, phase):
    cfg, seen = listed
    calls = seen[phase]
    assert len(calls) == 3
    for names, _, _, _ in calls:
        assert len(names) > 100          # the step's own ops are there
        assert not HOST_OPS & set(names), sorted(HOST_OPS & set(names))


@pytest.mark.parametrize("phase", ["_guess_phase", "_advance_phase"])
def test_racing_phases_take_and_give_fixed_shapes(listed, phase):
    """A graph replays one layout: every call of a phase takes and gives
    tensors of the same shapes and dtypes, cold start or warm."""
    _, seen = listed
    layouts = {tuple((t.shape, t.dtype) for t in args + tuple(out))
               for _, args, out, _ in seen[phase]}
    assert len(layouts) == 1
    for _, args, out, _ in seen[phase]:
        assert all(isinstance(t, torch.Tensor) for t in args + tuple(out))


# name: (ExperimentConfig keywords, fleets)
LPV_SYSTEMS = {
    "n8": (dict(N=8, dt=0.025), 2),
    "n8_dynamic_lane": (dict(N=8, dt=0.025, map_type="Oval2",
                             dynamic_lane=True), 2),
    "n125": (dict(N=125, dt=0.025), 1),
}


@pytest.fixture(scope="module", params=list(LPV_SYSTEMS))
def lpv_listed(request):
    """Three LPV fleet steps, the first escalating agent 0 of fleet 0 to
    the cold rung of the hold ladder, the ops of each phase call."""
    mp = pytest.MonkeyPatch()
    mp.setattr(simulate, "graphed", _Listing)
    _Listing.seen = {}
    kw, fleets = LPV_SYSTEMS[request.param]
    try:
        cfg = tcfg.ExperimentConfig(
            gains=tcfg.lpv_gains(), **kw,
            solver=tcfg.SolverConfig(admm_iters=15, epoch_len=15))
        track = make_track(cfg.map_type, device="cpu", dtype=torch.float32)
        step = simulate.make_lpv_fleet_step(track, cfg)
        state = simulate.batch_fleet_state(
            simulate.init_lpv_fleet(track, cfg, device="cpu"), fleets,
            device="cpu")
        hold = state.hold_count.clone()
        hold[0, 0] = cfg.hold_cold_k
        state = state._replace(hold_count=hold)
        for _ in range(3):
            state, _ = step(state)
    finally:
        mp.undo()
    return cfg, dict(_Listing.seen)


def _moves_data(name, kwargs):
    """Whether a dispatched op moves data between host and device or reads
    a value on the host; a ``_to_copy`` that names no device only casts
    on the tensor's own device."""
    if name == "_to_copy":
        return "device" in kwargs or kwargs.get("pin_memory")
    return name in HOST_OPS


@pytest.mark.parametrize("phase", ["_hold_phase", "_plant_phase"])
def test_lpv_phases_move_nothing_between_host_and_device(lpv_listed, phase):
    _, seen = lpv_listed
    calls = seen[phase]
    assert len(calls) == 3
    for names, _, _, kwargs in calls:
        assert len(names) > 100          # the step's own ops are there
        moved = [(n, k) for n, k in zip(names, kwargs) if _moves_data(n, k)]
        assert not moved, moved


@pytest.mark.parametrize("phase", ["_hold_phase", "_plant_phase"])
def test_lpv_phases_take_and_give_fixed_shapes(lpv_listed, phase):
    """A graph replays one layout: every call of a phase takes and gives
    tensors of the same shapes and dtypes, on a step that escalates an
    agent or on one that escalates none."""
    _, seen = lpv_listed
    layouts = {tuple((t.shape, t.dtype) for t in args + tuple(out))
               for _, args, out, _ in seen[phase]}
    assert len(layouts) == 1
    for _, args, out, _ in seen[phase]:
        assert all(isinstance(t, torch.Tensor) for t in args + tuple(out))


def test_graphed_runs_cpu_tensors_as_they_are():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b, a * b

    g = graphed(fn)
    a, b = torch.arange(3.0), torch.full((3,), 2.0)
    out = g(a, b)
    assert torch.equal(out[0], a + b) and torch.equal(out[1], a * b)
    assert len(calls) == 1
