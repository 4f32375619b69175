"""The racing cell's plain reference (``benchmark/reference/cmpc``'s
``racing.py``, ``mpcc.py``, ``pacejka.py``, ``spline.py``) on the CPU: it
is the port's plain racing path bit for bit, from cold and warm starts, at
N=8 and at the cell's N=60, and a copy whose matrix products ran in TF32
is not; in float64 it stays near the port's float32 step; its ADMM reaches
each racing stage QP's optimum as a dense interior point finds it
(``benchmark/reference/exact.py``); it imports nothing of the port or of
JAX."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import control, systems, traffic  # noqa: E402
from benchmark.reference import exact  # noqa: E402
from benchmark.reference.cmpc import mpcc as ref_mpcc  # noqa: E402

CONF = json.loads(
    (ROOT / "benchmark" / "configs" / "mpcc-race-oval-n60.json").read_text())
# seeds of the starts: (vx, vy, wz) perturbed at 0.002, under which every
# racing QP solves (0.05 makes the cold-started SQP fail its QPs)
SEEDS = (3, 2 ** 31 + 11, 2 ** 33 + 5)
NOISE = 0.002
STEPS = 5
# the copy runs the port's plain torch ops in the same order, in one
# process: the same bits, so no gap is allowed (TF32 products leave one)
TOL = 0.0


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _conf(N: int) -> dict:
    conf = json.loads(json.dumps(CONF))
    conf["mpcc"]["N"] = N
    return conf


def _start(system, seed: int):
    return system.start(1, traffic.start_perturbation(
        {"fleets": 1, "noise": NOISE}, 1, seed, 0))


def _gap(a, b) -> float:
    """The widest gap between two states (or metrics) of the same layout,
    every field compared; a field whose non-finite entries differ counts as
    an infinite gap."""
    worst = 0.0
    for x, y in zip(a, b):
        x, y = x.double(), y.double()
        if not torch.equal(torch.isfinite(x), torch.isfinite(y)):
            return float("inf")
        fin = torch.isfinite(x)
        if fin.any():
            worst = max(worst, float((x[fin] - y[fin]).abs().max()))
    return worst


def _race(prog, ref, seed: int, warm: bool, ref_step=None):
    """The port's and the copy's ``STEPS`` steps from one start (after one
    port step when ``warm``: a valid guess and ADMM warm starts); the widest
    gap of the states and of the step metrics."""
    a = _start(prog, seed)
    if warm:
        a, _ = prog.step(a)
        assert bool(a.valid_guess.all())
    b = type(ref.base)(*a)
    step = ref_step or ref.step
    gap = 0.0
    for _ in range(STEPS):
        a, ma = prog.step(a)
        b, mb = step(b)
        gap = max(gap, _gap(a, b), _gap(ma, mb))
    return gap, a


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("N", [8, 60])
def test_the_racing_copy_is_the_ports_plain_path(N, seed, warm):
    conf = _conf(N)
    prog = systems.program(conf, "cpu")
    ref = systems.reference(conf, "cpu", "float32")
    for x, y in zip(_start(prog, seed), _start(ref, seed)):
        assert torch.equal(x, y)
    gap, state = _race(prog, ref, seed, warm)
    assert gap <= TOL
    assert bool(torch.isfinite(state.x).all())
    assert int(state.n_non_solves.max()) == 0


def test_tf32_products_in_the_copy_break_the_tolerance():
    # the control's rounding (benchmark/control.py) reaches the copy's
    # products: every one is written with @
    conf = _conf(8)
    prog = systems.program(conf, "cpu")
    ref = systems.reference(conf, "cpu", "float32")
    gap, _ = _race(prog, ref, SEEDS[0], False,
                   ref_step=control.TF32(ref).step)
    assert gap > TOL


def test_float64_copy_stays_near_the_ports_float32_step():
    # what the check compares on the card, one step from the port's state:
    # float32 rounding through 2 SQP iterations of ADMM at N=8 moves the
    # executed state by well under 1e-4
    conf = _conf(8)
    prog = systems.program(conf, "cpu")
    ref = systems.reference(conf, "cpu")
    state, _ = prog.step(_start(prog, SEEDS[1]))
    post, _ = prog.step(state)
    want, _ = ref.step(type(ref.base)(*(
        t.double() if t.is_floating_point() else t for t in state)))
    assert ref.base.x.dtype == torch.float64
    assert float((post.x.double() - want.x).abs().max()) < 1e-4


@pytest.mark.parametrize("which", ["cold", "warm"])
def test_the_copys_admm_reaches_each_racing_qps_optimum(which, monkeypatch):
    # a racing stage QP of the float64 copy (its first SQP iteration from
    # the cold guess, or the last of the second step's warm SQP loop), in
    # the solver's scaled variables, solved by the copy's ADMM to a tight
    # tolerance and by a dense interior point that shares none of its code
    real, seen = ref_mpcc.admm_solve, []

    def spy(qp, z0, **kw):
        seen.append((qp, z0, kw))
        return real(qp, z0, **kw)

    monkeypatch.setattr(ref_mpcc, "admm_solve", spy)
    ref = systems.reference(_conf(8), "cpu")
    state = _start(ref, SEEDS[2])
    for _ in range(1 if which == "cold" else 2):
        state, _ = ref.step(state)
    qp, z0, kw = seen[0] if which == "cold" else seen[-1]
    tight = real(qp, z0, **{**kw, "iters": 60000, "eps": 1e-11})
    assert float(tight.r_prim.max()) < 1e-10
    z, c = exact.stage_qp_optimum(qp, 0, z0[0])
    scale = 1.0 + np.abs(z).max()
    assert np.abs(tight.z[0].numpy() - z).max() < 1e-8 * scale
    assert np.abs(tight.c[0].numpy() - c).max() < 1e-8 * scale


def test_the_racing_copy_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.cmpc.racing, "
            "benchmark.reference.cmpc.mpcc, benchmark.reference.cmpc.pacejka, "
            "benchmark.reference.cmpc.spline\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('colaborativempc_tpu_torch', 'colaborativempc_tpu', 'jax')))"
            % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
