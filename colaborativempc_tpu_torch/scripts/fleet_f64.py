"""Hold a fleet's closed loop on the card against the CPU's plain path in
float32 and in float64, over several seeds (card only).

A closed loop whose ADMM solves stop an epoch apart on two float32 paths
(LPV with 32 agents: the card and the CPU differ by ~1e-2 in the plans)
cannot be held to a fixed distance from another float32 run. For each
seed the script runs the same fleet from the same perturbed start on the
card, on the CPU in float32 and on the CPU in float64, and prints the
plans' max |dx_pred| between each pair and two ratios of (card to
float64) over (CPU float32 to float64): of the max over the batch, which
one scenario sets, and of the mean over the scenarios of each one's max
(:func:`f64_ratios`). The kernels are as accurate as the float32 plain
path where the ratios stay near 1. ``chip_smoke.py`` phase 22 holds LPV
32 agents to the second (:data:`chip_smoke.TOL_ROLLOUT_F64`):

    python -m colaborativempc_tpu_torch.scripts.fleet_f64 --seeds 0,1,2,3

The fleet is phase 22's LPV one (:data:`FLEET`: Highway, 32 agents, B=8,
N=20, 5 steps).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

# ``monte_carlo.setup`` arguments of the fleet: chip_smoke.py LARGE_FLEETS'
# LPV 32 agents
FLEET = dict(pipeline="lpv", scenarios=8, agents=32, N=20, steps=5)


def float64_plans(pipeline, cfg, state, steps):
    """The closed loop of ``cfg`` (``pipeline`` "lpv" or "nl") on the CPU
    in float64 from ``state`` (any device, any float dtype): its final
    x_pred."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.runtime import (
        make_lpv_fleet_rollout, make_nl_ocd_rollout,
    )
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    make = make_nl_ocd_rollout if pipeline == "nl" else make_lpv_fleet_rollout
    track = make_track(cfg.map_type, device="cpu", dtype=torch.float64)
    st = type(state)(*(x.detach().cpu().double() if x.is_floating_point()
                       else x.detach().cpu() for x in state))
    return make(track, cfg64, steps)(st)[0].x_pred


def f64_ratios(card, cpu, f64) -> dict:
    """Plans of one batch (scenarios first) on the card, on the CPU in
    float32 and in float64: the max |dx| of card and CPU float32 from
    float64 over the batch and their ratio (``ratio_max``), and the mean
    over the scenarios of each scenario's max |dx| and their ratio
    (``ratio_mean``)."""
    def per_scenario(a, b):
        return (a.double().cpu() - b.double().cpu()).abs().flatten(1).amax(1)
    dc, dp = per_scenario(card, f64), per_scenario(cpu, f64)
    out = dict(card_vs_f64=float(dc.max()), cpu_f32_vs_f64=float(dp.max()),
               card_vs_f64_mean=float(dc.mean()),
               cpu_f32_vs_f64_mean=float(dp.mean()))
    out["ratio_max"] = out["card_vs_f64"] / out["cpu_f32_vs_f64"]
    out["ratio_mean"] = (out["card_vs_f64_mean"]
                         / out["cpu_f32_vs_f64_mean"])
    return out


def distances(seed, device="cuda", **kw):
    """Max |dx_pred| between the card's, the CPU float32 and the CPU
    float64 plans of one fleet (``monte_carlo.setup`` arguments ``kw``)
    from seed ``seed``, and the seconds of each run."""
    from colaborativempc_tpu_torch.scripts import monte_carlo
    plans, secs = {}, {}
    for name in (device, "cpu"):
        cfg, rollout, st = monte_carlo.setup(device=torch.device(name),
                                             seed=seed, **kw)
        t0 = time.perf_counter()
        plans[name] = rollout(st)[0].x_pred.double().cpu()
        secs[name] = time.perf_counter() - t0
        if name == "cpu":
            t0 = time.perf_counter()
            plans["f64"] = float64_plans(kw["pipeline"], cfg, st,
                                          kw["steps"])
            secs["f64"] = time.perf_counter() - t0

    return dict(seed=seed, seconds=secs, card_vs_cpu=float(
        (plans[device] - plans["cpu"]).abs().max()),
        **f64_ratios(plans[device], plans["cpu"], plans["f64"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3",
                    help="comma-separated seeds of the perturbed starts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("fleet_f64: needs a CUDA device")
    from colaborativempc_tpu_torch.scripts.clock_split import card
    info = card()
    print(info, flush=True)
    recs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = distances(seed, **FLEET)
        recs.append(rec)
        print(f"seed {seed}: max |dx_pred| card vs CPU float32 "
              f"{rec['card_vs_cpu']:.6g}, card vs CPU float64 "
              f"{rec['card_vs_f64']:.6g}, CPU float32 vs float64 "
              f"{rec['cpu_f32_vs_f64']:.6g}, ratio {rec['ratio_max']:.4f};"
              f" mean over scenarios: card vs float64 "
              f"{rec['card_vs_f64_mean']:.6g}, CPU float32 vs float64 "
              f"{rec['cpu_f32_vs_f64_mean']:.6g}, ratio "
              f"{rec['ratio_mean']:.4f}", flush=True)
    print(json.dumps({"card": info, "fleet": FLEET, "seeds": recs}))


if __name__ == "__main__":
    main()
