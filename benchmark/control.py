"""The readings the check's limits are set from (card only; the
benchmark's own runs never run this):

    python benchmark/control.py --workload <cell> --seeds 1,2,3
        [--sut control|program] [--seconds 2]

``--sut control`` puts the plain reference in the program's place,
computed one precision below the configuration's (float32 with every
matrix product in TF32: :class:`TF32`), runs the cell's traffic per seed
and prints the check's numbers against the float64 reference: one of
them has to come out above its limit. ``--sut program`` reads the
program's numbers the same way, the set-up shared by every seed. One JSON
line per seed.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (float32 with 10 explicit mantissa bits, to
    nearest) by Veltkamp's split: ``c = (2**13 + 1) x`` and ``c - (c - x)``
    keep the high 11 significant bits; other dtypes unchanged."""
    if x.dtype != torch.float32:
        return x
    c = x * 8193.0
    return c - (c - x)


_MATMUL = torch.Tensor.__matmul__


def _tf32_matmul(a, b):
    return _MATMUL(to_tf32(a), to_tf32(b))


@contextlib.contextmanager
def _tf32():
    """Every matrix product of the block in TF32: the operands of ``@``
    rounded to TF32 and TF32 allowed to the card's libraries. The flag
    alone leaves these small products in full float32 on the card (the
    libraries keep float32 kernels for 11x11 blocks and matrix-vector
    shapes), so the rounding is explicit. The reference writes every
    matrix product with ``@`` (a test holds it to that); its 2x2 Cholesky
    solves and its sums of elementwise products stay float32. Restored
    after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.Tensor.__matmul__ = _tf32_matmul
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = _MATMUL
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class TF32:
    """A system (``systems.FleetSystem``) whose steps run with every
    matrix product in TF32: the control, the reference in float32 put in
    the program's place."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self, state):
        with _tf32():
            return self.inner.step(state)


def readings(cell_name: str, seeds, sut: str, seconds: float, device,
             bench: Path = None, ref_device=None):
    """One row per seed, as each is read: the check's numbers (and limits)
    of ``sut`` on ``cell_name``, with the steps run and the seconds of the
    window and the check."""
    from benchmark import harness, systems
    bench = bench or harness.BENCH
    cell = harness.load_cell(cell_name, bench)
    if sut == "control":
        system = TF32(systems.reference(cell.conf, device, "float32", bench))
    else:
        system = systems.program(cell.conf, device, bench)
    for i, seed in enumerate(seeds):
        if i == 0 and sut == "program":
            harness.warm_up(system, cell, seed)
        run = harness.run_window(system, cell, seed, seconds)
        run.efforts = harness.efforts(run)
        failed = harness.failed_fleet_steps(run)
        checks, ok, check_s = harness.check_window(run, seed, ref_device)
        yield {"workload": cell_name, "sut": sut, "seed": seed,
               "steps": run.steps, "window_s": run.window_s,
               "check_s": check_s, "failed": failed,
               "correct": bool(ok and failed == 0),
               "checks": {k: v["value"] for k, v in checks.items()},
               "limits": {k: v["limit"] for k, v in checks.items()}}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--sut", choices=("control", "program"),
                    default="control")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--ref-device", default=None,
                    help="where the float64 reference runs (default: the "
                    "workload file's check.device)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.perf_counter()
    for row in readings(args.workload, seeds, args.sut, args.seconds,
                        torch.device("cuda", 0), ref_device=args.ref_device):
        row["elapsed_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
