"""The check fails a broken timed path. Each run skips only the harness's
look for a card and drives the rest (set-up's warm steps, the window, the
check) with the program's step broken underneath, at a size the CPU runs
in seconds; the cells' own runs are on one card, so there is no exchange
between chips to leave out. The control (the reference one precision
down: float32 with every matrix product in TF32) has to fail as well."""

import pytest
import torch

from benchmark import control, harness, systems
from benchmark.tests.conftest import tiny_bench


class Broken:
    """The program with one fault planted in its step."""

    def __init__(self, inner, fault: str):
        self.inner, self.fault = inner, fault

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self, state):
        new, m = self.inner.step(state)
        if self.fault == "unchanged":
            # a step that returns its state unchanged
            return state, m
        if self.fault == "half_batch":
            # half of the batch left out: its fleets do not move
            h = state.x0.shape[0] // 2
            return type(new)(*(torch.cat([a[:h], b[h:]]) for a, b in
                               zip(new, state))), m
        if self.fault == "altered":
            # an answer altered where it is produced: agent 0's executed
            # lateral offset moved by 1 cm
            x0 = new.x0.clone()
            x0[:, 0, 3] += 0.01
            return new._replace(x0=x0), m
        raise ValueError(self.fault)


def _run(tmp_path, cell_name, fault=None, samples=3):
    bench, spec = tiny_bench(tmp_path, samples)
    cell = harness.load_cell(cell_name, bench)
    system = systems.program(cell.conf, "cpu")
    if fault is not None:
        system = Broken(system, fault)
    return harness.execute(cell, 2 ** 31 + 99, 0.4, False, system, spec,
                           bench)


@pytest.mark.parametrize("cell", ["tiny-lpv-mc", "tiny-nl-mc",
                                  "tiny-lpv-f1"])
def test_a_sound_run_is_correct(tmp_path, cell):
    res = _run(tmp_path, cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny-lpv-mc", "unchanged"), ("tiny-nl-mc", "unchanged"),
    ("tiny-lpv-f1", "unchanged"), ("tiny-nl-f1", "unchanged"),
    ("tiny-lpv-mc", "half_batch"), ("tiny-nl-mc", "half_batch"),
    ("tiny-lpv-mc", "altered"), ("tiny-nl-mc", "altered"),
    ("tiny-lpv-f1", "altered"), ("tiny-nl-f1", "altered"),
])
def test_a_broken_step_is_not_correct(tmp_path, cell, fault):
    res = _run(tmp_path, cell, fault)
    assert not res["correct"]
    assert res["checks"]["x0_gap"]["value"] > \
        res["checks"]["x0_gap"]["limit"]


@pytest.mark.parametrize("cell", ["tiny-lpv-mc", "tiny-nl-mc",
                                  "tiny-lpv-f1", "tiny-nl-f1"])
def test_the_control_is_not_correct(tmp_path, cell):
    bench, _ = tiny_bench(tmp_path, 3)
    for row in control.readings(cell, [1, 2, 3], "control", 0.3,
                                torch.device("cpu"), bench):
        assert not row["correct"], row


def test_the_reference_writes_every_matrix_product_with_the_operator():
    # the control rounds the operands of ``@``; a product written another
    # way would stay float32 under it
    import ast
    from benchmark.tests.conftest import BENCH
    banned = {"matmul", "bmm", "mm", "mv", "einsum", "tensordot", "baddbmm",
              "addmm", "linear", "dot", "inner"}
    for path in (BENCH / "reference" / "cmpc").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert node.attr not in banned, (path, node.lineno)
