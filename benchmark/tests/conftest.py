"""Shared pieces of the benchmark's tests: the checkout's root on the
path, and a small copy of the benchmark's files (the family files,
configurations at N=8, four fleets, one-step episodes) that the CPU can
run in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_bench(tmp: Path, samples: int = 3) -> tuple:
    """A benchmark directory under ``tmp`` with the real metric and family
    files, both configurations cut to N=8 (LPV with 300 ADMM iterations)
    and one cell per family and traffic kind (``tiny-<lpv|nl>-<mc|f1>``);
    returns ``(directory, spec)`` with every metric reported by every
    cell."""
    bench = tmp / "bench"
    for d in ("metrics", "families"):
        shutil.copytree(BENCH / d, bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic", "workloads"):
        (bench / d).mkdir(parents=True)
    for name, fam in (("lpv-highway-3ag-n125", "lpv"),
                      ("nl-ocd-highway-3ag-n20", "nl")):
        conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        conf["name"] = f"tiny-{fam}"
        conf["experiment"]["N"] = 8
        if fam == "lpv":
            conf["solver"]["admm_iters"] = 300
        (bench / "configs" / f"tiny-{fam}.json").write_text(json.dumps(conf))
        for tr in ("mc", "f1"):
            # the port's CPU float32 path reads at most 4.4e-6 / 2.8e-5 /
            # 2.2e-7 here, the control (every product in TF32) 4e-4 /
            # 5e-3 / 5.8e-4 and more
            limits = {"start_gap": 0.0, "x0_gap": 1e-4, "plan_gap": 1e-3}
            if fam == "nl":
                limits["price_gap"] = 1e-4
            (bench / "workloads" / f"tiny-{fam}-{tr}.json").write_text(
                json.dumps({"name": f"tiny-{fam}-{tr}",
                            "config": f"tiny-{fam}", "traffic": tr,
                            "why": "test", "warm_steps": 1,
                            "trace_seconds": 0.2,
                            "check": {"samples": samples, "device": "cpu",
                                      "limits": limits}}))
    (bench / "traffic" / "mc.json").write_text(json.dumps(
        {"kind": "sweep", "fleets": 4, "episode_steps": 1, "noise": 0.05}))
    (bench / "traffic" / "f1.json").write_text(json.dumps(
        {"kind": "course", "fleets": 1, "noise": 0.05}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    return bench, spec
