"""How far rounding alone moves the NL-OCD closed loop: the B=2 x 3-step
rollout of ``chip_smoke.py`` phase 7 on the card, with each epoch's two
steps, its fixed data (``admm_epoch_inputs``) and its iterations
(``admm_epoch_batched``), each either the CUDA kernel or the plain version
on the card's tensors (the algebra of the CPU path, only the card's
rounding), in the four combinations, each against the CPU path.

    python -m colaborativempc_tpu_torch.scripts.rounding_control

Prints one line per coupling/sweep and variant: max |dx_pred| against the
CPU path, and whether the OCD iteration counts agree. Needs a CUDA device.

``--oracle`` reads the same four variants on one LPV QP instead, each
against the float64 C++ twin (``colaborativempc_tpu_torch.native``): agent
0 of 3 and of 197 on the Highway at N=125 (600 iterations, eps 1e-6, the
``chip_smoke.py`` phase 24 inputs), beside the CPU path; one line per QP
and variant with max |dx_pred|, |du_pred| and the ADMM iterations.
"""

import argparse

import torch


def rollout(coupling, sweep, device, steps):
    from colaborativempc_tpu_torch.scripts import monte_carlo
    _, roll, st = monte_carlo.setup("nl", scenarios=2, agents=3, N=20,
                                    steps=steps, device=device,
                                    coupling=coupling, sweep=sweep)
    fin, (_, _, m) = roll(st)
    return fin.x_pred.cpu(), m.ocd_iterations.cpu()


def lpv_qp_solver(agents, N, device):
    """One LPV solve of agent 0 of ``agents`` on the Highway at horizon
    N (dt 0.02, the port's warm start of ``x0_database``), as a function
    of ``eps``, and the same QP through the float64 C++ twin: ``(solve,
    (x_pred, u_pred, iterations) of the twin)``."""
    from colaborativempc_tpu_torch import native
    from colaborativempc_tpu_torch.config import (
        ModelParams, SysLimits, lpv_gains, x0_database,
    )
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.planners.lpv import lpv_solve
    from colaborativempc_tpu_torch.utils.warmstart import initialise_agents
    g, lim, mp = lpv_gains(), SysLimits(), ModelParams()
    track = make_track("Highway", device=device)
    x0s = torch.tensor(x0_database(agents), dtype=torch.float32,
                       device=device)
    xy, x_pred, u_pred = initialise_agents(track, x0s, N, 0.02)
    x0, xl, ul, nb = x_pred[:1, 0], x_pred[:1], u_pred[:1], xy[None, :, 1:]
    _, x_nat, u_nat, res = native.lpv_solve_native(
        track, g, lim, mp, N, 0.02, x0[0], xl[0], ul[0], [0.0, 0.0],
        neighbours_xy=nb[0])

    def solve(eps):
        return lpv_solve(track, g, lim, mp, N, 0.02, x0, xl, ul,
                         torch.zeros_like(x0[:, :2]), nb, admm_iters=600,
                         eps=eps)
    return solve, (x_nat, u_nat, int(res[2]))


def oracle_distances(sol, ref):
    x_nat, u_nat, _ = ref
    return (float((sol.x_pred[0].double().cpu() - torch.from_numpy(x_nat))
                  .abs().max()),
            float((sol.u_pred[0].double().cpu() - torch.from_numpy(u_nat))
                  .abs().max()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--oracle", action="store_true",
                    help="the four variants on one LPV QP against the "
                    "float64 C++ twin")
    args = ap.parse_args(argv)
    from colaborativempc_tpu_torch.ops import admm, cuda_lqr
    from colaborativempc_tpu_torch.utils import resolve_device
    dev = resolve_device("cuda")
    inputs, epoch = admm.admm_epoch_inputs, admm.admm_epoch_batched
    variants = (
        ("both kernels", inputs, epoch),
        ("epoch-data kernel, plain epoch on the card", inputs,
         cuda_lqr.admm_epoch_batched_plain),
        ("plain epoch data on the card, epoch kernel",
         admm.admm_epoch_inputs_plain, epoch),
        ("both plain on the card", admm.admm_epoch_inputs_plain,
         cuda_lqr.admm_epoch_batched_plain))
    card = torch.cuda.get_device_name(0)
    if args.oracle:
        for agents in (3, 197):
            solve_cpu, ref = lpv_qp_solver(agents, 125, torch.device("cpu"))
            solve, _ = lpv_qp_solver(agents, 125, dev)
            runs = [("CPU path", solve_cpu, 1e-6, inputs, epoch)]
            runs += [(name, solve, 1e-6, i, e) for name, i, e in variants]
            runs.append(("both kernels, eps 0", solve, 0.0, inputs, epoch))
            for name, fn, eps, inputs_fn, epoch_fn in runs:
                admm.admm_epoch_inputs = inputs_fn
                admm.admm_epoch_batched = epoch_fn
                try:
                    sol = fn(eps)
                finally:
                    admm.admm_epoch_inputs, admm.admm_epoch_batched = (
                        inputs, epoch)
                dx, du = oracle_distances(sol, ref)
                print(f"oracle, agent 0 of {agents}, N=125, {name}: max "
                      f"|dx_pred| {dx:.4g} |du_pred| {du:.4g} from the "
                      f"float64 twin, {int(sol.iterations[0])} iterations "
                      f"(the twin {ref[2]}) [{card}]", flush=True)
        return
    for coupling, sweep in (("eu", "jacobi"), ("hp_opt", "gauss_seidel")):
        x_cpu, its_cpu = rollout(coupling, sweep, torch.device("cpu"),
                                 args.steps)
        for name, inputs_fn, epoch_fn in variants:
            admm.admm_epoch_inputs = inputs_fn
            admm.admm_epoch_batched = epoch_fn
            try:
                x, its = rollout(coupling, sweep, dev, args.steps)
            finally:
                admm.admm_epoch_inputs, admm.admm_epoch_batched = (inputs,
                                                                   epoch)
            print(f"{coupling}/{sweep}, {name}: max |dx_pred| vs the CPU "
                  f"path {float((x - x_cpu).abs().max()):.4g}, OCD "
                  f"iterations equal: {bool(torch.equal(its, its_cpu))} "
                  f"[{torch.cuda.get_device_name(0)}]", flush=True)


if __name__ == "__main__":
    main()
