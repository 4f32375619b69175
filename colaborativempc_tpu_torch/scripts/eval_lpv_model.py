"""Validate the model discretisation against a recorded input sequence
(reference ``planner/scripts/eval_LPV_model.py``); the port of the JAX
package's ``scripts/eval_lpv_model.py``. Replays the applied inputs of
``u.pkl`` through the Euler/LPV rollout (``utils/rollout.py
rollout_euler``) on ``--device`` and reports the divergence from the
recorded states.

    python -m colaborativempc_tpu_torch.scripts.eval_lpv_model data/LPV3r
        [--agent 0] [--map Highway] [--dt 0.025] [--steps 50] [--device cuda]

``--device`` defaults to ``cuda`` and raises when there is no card;
``--device cpu`` runs on the CPU.
"""

import argparse

import numpy as np

STATE_NAMES = ["vx", "vy", "wz", "ey", "epsi", "theta", "s", "X", "Y"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--agent", type=int, default=0)
    ap.add_argument("--map", default="Highway")
    ap.add_argument("--dt", type=float, default=0.025)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which raises without "
                    "a card; --device cpu runs on the CPU)")
    args = ap.parse_args(argv)
    from colaborativempc_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)

    import torch
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.runtime.io import load_experiment
    from colaborativempc_tpu_torch.utils.rollout import rollout_euler

    s_hist, u_hist = load_experiment(args.path, args.agent)
    recorded = np.stack([s[0] for s in s_hist])          # executed states
    us = np.stack([u[0] for u in u_hist])                # applied inputs
    # T inputs take recorded row 0 to row T, so T is at most the rows
    # after the first (the JAX script takes len(us) and fails on a run
    # shorter than --steps)
    T = min(args.steps, len(us) - 1)

    track = make_track(args.map, device=device)
    sim = rollout_euler(
        track, torch.tensor(recorded[0], dtype=torch.float32, device=device),
        torch.tensor(us[:T], dtype=torch.float32, device=device),
        args.dt).cpu().numpy()
    err = np.abs(sim[1:T + 1] - recorded[1:T + 1])
    print(f"open-loop rollout vs recorded over {T} steps:")
    for i, nm in enumerate(STATE_NAMES):
        print(f"  {nm:>5}: max err {err[:, i].max():.4f}")
    return sim, err


if __name__ == "__main__":
    main()
