"""The benchmark of ``colaborativempc_tpu_torch`` on one NVIDIA H100.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything a cell needs is found by name, so a later change adds a cell,
a configuration, a traffic mix or a metric by adding files:

- ``BENCHMARK.json`` (the checkout's root): the cells, and which metrics
  each reports;
- ``benchmark/workloads/<cell>.json``: the cell's configuration, traffic,
  warm steps and the check's sample size, reference device and limits;
- ``benchmark/configs/<config>.json``: every setting of the deployment,
  and its controller ``family``;
- ``benchmark/families/<family>.py``: everything that depends on the
  controller and its state's layout: its program and plain reference
  packages, how the configuration becomes each one's config, the track,
  start and step, the agents of a fleet and a course's step limit, where
  the sweep's perturbation goes, the executed state, plans and prices the
  check compares, a fleet-step's work, the launch counters and the ADMM
  epoch's shape (``benchmark/systems.py`` lists each name);
- ``benchmark/traffic/<traffic>.json``: the generator's parameters
  (``benchmark/traffic.py``);
- ``benchmark/metrics/<metric>.py``: ``read(run)``, the metric's value
  from a finished run, or None where the run has nothing to read.

A run: set-up (imports, the CUDA context, the program's kernel library,
the track and fleet, the cell's warm steps), the measured window of
``--seconds`` (with ``--trace 1`` the first ``trace_seconds`` of it under
``torch.profiler``), then the check of the window's answers against the
plain reference (``benchmark/check.py``), then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "colaborativempc_tpu")


class Refused(Exception):
    """A run that must end without a result, with the reason."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: Path = BENCH) -> SimpleNamespace:
    """The cell ``name``: its workload file, configuration and traffic,
    each found by name under ``bench``."""
    wl = load_json(bench / "workloads" / f"{name}.json")
    return SimpleNamespace(
        name=name, workload=wl,
        conf=load_json(bench / "configs" / f"{wl['config']}.json"),
        traffic=load_json(bench / "traffic" / f"{wl['traffic']}.json"))


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries of ``BENCHMARK.json`` that ``cell`` reports: its
    end-to-end metrics with ``--trace 0``, its per-layer ones with 1."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_reader(name: str, bench: Path = BENCH):
    """``read`` of ``bench/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run, entries: list, bench: Path = BENCH) -> dict:
    """``name -> {"value", "unit"}`` of every entry whose reader found
    something to read."""
    out = {}
    for m in entries:
        v = load_reader(m["name"], bench)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``colaborativempc_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counters() -> dict:
    """The launch counters that the loaded families name, where their
    modules are loaded."""
    from benchmark import systems
    out = {}
    for family in systems.loaded_families():
        for mod, fn in family.COUNTERS:
            m = sys.modules.get(mod)
            if m is not None:
                out[f"{fn}.launches"] = getattr(m, fn).launches
    return out


def dispatch_floor_ms(device) -> float:
    """Best of 10 synchronised calls of a trivial device operation, ms."""
    import torch
    z = torch.zeros((), device=device) + 1.0
    _sync(device)
    best = float("inf")
    for _ in range(10):
        t0 = time.perf_counter()
        z = z + 1.0
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def card_context() -> dict:
    """The card's name, clocks, power draw and limit and temperature from
    ``nvidia-smi`` (what it reads; "not read" where it cannot)."""
    q = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"not read: {e}"}
    return {"nvidia_smi": q, "reading": out.splitlines()}


def _account(system, sampler, bad, pre, post, metrics):
    """The window's bookkeeping of one step, on the device with no host
    read: adds its fleets whose executed state is not finite to ``bad``,
    updates the check's sample and returns its ``(B,)`` work."""
    import torch
    effort = system.effort(metrics)
    sampler.observe(pre, post, effort)
    bad += (~torch.isfinite(system.executed(post)).flatten(1).all(1)).sum()
    return effort


def warm_up(system, cell, seed: int) -> None:
    """The cell's warm steps on its own shapes, with the window's
    bookkeeping, so every kernel the window runs is loaded (counted as
    set-up)."""
    import torch
    from benchmark import traffic as gen
    from benchmark.check import Sampler
    tr = cell.traffic
    state = system.start(tr["fleets"], gen.warm_perturbation(
        tr, system.n_agents, seed))
    sampler = Sampler(cell.workload["check"]["samples"], tr["fleets"], seed)
    bad = torch.zeros((), dtype=torch.long, device=system.device)
    for _ in range(cell.workload["warm_steps"]):
        new, m = system.step(state)
        _account(system, sampler, bad, state, new, m)
        state = new
    if tr["kind"] == "course":
        system.course_ended(state)
    _sync(system.device)


def run_window(system, cell, seed: int, seconds: float,
               trace_seconds: float = 0.0) -> SimpleNamespace:
    """The measured window: the cell's traffic through ``system`` for
    ``seconds`` (the last step started before the time is up ends it, and
    the device is waited for). Keeps each step's work, a count of failed
    fleet-steps and the check's sample (``check.Sampler``), all on the
    device, and each episode's start. With ``trace_seconds`` the window's
    first ``trace_seconds`` run under ``torch.profiler``."""
    import torch
    from benchmark import traffic as gen
    from benchmark.check import Sampler
    tr = cell.traffic
    dev = system.device
    course = tr["kind"] == "course"
    max_steps = system.max_steps if course else tr["episode_steps"]
    sampler = Sampler(cell.workload["check"]["samples"], tr["fleets"], seed)
    work, starts, perts, times = [], [], [], []
    bad = torch.zeros((), dtype=torch.long, device=dev)
    prof, marker = None, None
    if trace_seconds > 0:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        marker = torch.autograd.profiler.record_function("benchmark_window")
        marker.__enter__()
    c0 = counters()
    t0 = time.perf_counter()

    def stop_trace():
        nonlocal prof
        _sync(dev)
        marker.__exit__(None, None, None)
        prof.stop()
        done, prof = prof, None
        return done

    finished_prof = None
    episode = 0
    while True:
        pert = gen.start_perturbation(tr, system.n_agents, seed, episode)
        state = system.start(tr["fleets"], pert)
        starts.append(state)
        perts.append(pert)
        for _ in range(max_steps):
            ts = time.perf_counter()
            new, m = system.step(state)
            if course:
                _sync(dev)
                times.append(time.perf_counter() - ts)
            work.append(_account(system, sampler, bad, state, new, m))
            state = new
            elapsed = time.perf_counter() - t0
            if prof is not None and elapsed >= trace_seconds:
                finished_prof = stop_trace()
            if elapsed >= seconds:
                break
            if course and (not bool(torch.isfinite(
                    system.executed(state)).all())
                           or system.course_ended(state)):
                break
        if time.perf_counter() - t0 >= seconds:
            break
        episode += 1
    _sync(dev)
    window = time.perf_counter() - t0
    if prof is not None:
        finished_prof = stop_trace()
    c1 = counters()
    run = SimpleNamespace(
        cell=cell.name, conf=cell.conf, traffic=tr, workload=cell.workload,
        system=system, work=work, bad=bad, sampler=sampler, starts=starts,
        perts=perts, step_times=np.asarray(times), window_s=window,
        steps=len(work), fleets=tr["fleets"],
        fleet_steps=len(work) * tr["fleets"],
        counters={k: c1[k] - c0.get(k, 0) for k in c1},
        trace=None, notes=[])
    run.note = run.notes.append
    if finished_prof is not None:
        from benchmark import trace as tl
        evs = tl.events(finished_prof, ("benchmark_window",))
        mark = [e for e in evs if e.name == "benchmark_window"
                and not e.on_device]
        lo, hi = ((mark[0].start, mark[0].end) if mark else
                  (min(e.start for e in evs), max(e.end for e in evs)))
        run.trace = SimpleNamespace(events=evs, lo=lo, hi=hi,
                                    window_s=hi - lo)
    return run


def efforts(run) -> np.ndarray:
    """``(steps, B)`` work of every fleet-step of the window."""
    import torch
    return torch.stack(run.work).cpu().numpy()


def failed_fleet_steps(run) -> int:
    """Fleet-steps whose executed state is not finite."""
    return int(run.bad)


def check_window(run, seed: int, ref_device=None) -> tuple:
    """The check of the window's answers (``benchmark/check.py``): frees
    the window's states, runs the float64 reference and returns
    ``(checks, ok, seconds)``."""
    import torch
    from benchmark import check as ck
    from benchmark import systems
    t0 = time.perf_counter()
    wl = run.workload["check"]
    pulled = run.sampler.pull()
    starts = [tuple(t.detach().cpu() for t in s) for s in run.starts]
    run.sampler, run.starts = None, []
    if run.system.device.type == "cuda":
        torch.cuda.empty_cache()
    dev = ref_device or wl["device"]
    bench = run.system.bench
    ref = systems.reference(run.conf, dev, bench=bench)
    start_ref = systems.reference(run.conf, run.system.device,
                                  run.conf["dtype"], bench)
    gaps = ck.compare(ref, pulled, start_ref, starts, run.perts)
    checks, ok = ck.verdict(gaps, wl["limits"])
    return checks, ok, time.perf_counter() - t0


def execute(cell, seed: int, seconds: float, trace: bool, system,
            spec: dict, bench: Path = BENCH, ref_device=None,
            t_start: float = None) -> dict:
    """Set-up's warm steps, the window, the check and the result of one
    run of ``cell`` on ``system`` (already built). Returns the result
    object; ``"checks"`` is its last key."""
    import torch
    warm_up(system, cell, seed)
    setup_s = time.perf_counter() - (t_start if t_start is not None
                                     else time.perf_counter())
    dev = system.device
    cuda = dev.type == "cuda"
    if cuda:
        # the peak is the window's: the program's state and what its steps
        # allocate, with the harness's small sample
        torch.cuda.reset_peak_memory_stats(dev)
    run = run_window(system, cell, seed, seconds,
                     cell.workload["trace_seconds"] if trace else 0.0)
    run.setup_s = setup_s
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    card = card_context() if cuda else {}
    run.failed = failed_fleet_steps(run)
    run.efforts = efforts(run)
    metrics = read_metrics(run, cell_metrics(spec, cell.name, trace), bench)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": run.fleet_steps,
              "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        from benchmark import trace as tl
        t = run.trace
        device["busy_s"] = tl.busy_seconds(t.events, t.lo, t.hi)
        device["window_s"] = t.window_s
        result["breakdown"] = {
            "device_ops": tl.top_device_ops(t.events),
            "idle_gaps": tl.idle_gaps(t.events, t.lo, t.hi)}
        run.trace = None
    checks, ok, check_s = check_window(run, seed, ref_device)
    result["correct"] = bool(ok and run.failed == 0)
    result["checks"] = checks
    result["_context"] = {"steps": run.steps, "window_s": run.window_s,
                          "setup_s": setup_s, "check_s": check_s,
                          "notes": run.notes, **card}
    return result


def _json_number(v):
    return v if v is not None and np.isfinite(v) else None


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        return _main(args, t_start)
    except Refused as e:
        print(f"benchmark: no result: {e}", file=sys.stderr)
        return 2


def _main(args, t_start: float) -> int:
    if importlib.util.find_spec("colaborativempc_tpu_torch") is None:
        raise Refused("the program colaborativempc_tpu_torch is not in "
                      "this checkout")
    spec = load_json(ROOT / "BENCHMARK.json")
    entry = [w for w in spec["workloads"] if w["name"] == args.workload]
    if not entry:
        raise Refused(f"no cell {args.workload!r} in BENCHMARK.json")
    cell = load_cell(args.workload)
    from benchmark import systems
    systems.load_family(cell.conf["family"])
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device")
    if torch.cuda.device_count() < entry[0]["chips"]:
        raise Refused(f"{entry[0]['chips']} cards asked for, "
                      f"{torch.cuda.device_count()} present")
    torch.set_num_threads(4)
    from colaborativempc_tpu_torch.ops import _build
    lib_before = _build.library_path().exists()
    dev = torch.device("cuda", 0)
    system = systems.program(cell.conf, dev)
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     system, spec, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules of JAX or the JAX package loaded: {bad}")
    ctx = result.pop("_context")
    ctx.update(torch=torch.__version__, cuda=torch.version.cuda,
               dispatch_floor_ms=dispatch_floor_ms(dev),
               library_built_in_this_run=(not lib_before
                                          and _build.library_path().exists()),
               seed=args.seed, workload=args.workload)
    print("context " + json.dumps(ctx), flush=True)
    for n in ctx["notes"]:
        print(f"note: {n}", file=sys.stderr)
    for k, r in result["checks"].items():
        r["value"] = _json_number(r["value"])
        print(f"check {k} {r['value']} limit {r['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
