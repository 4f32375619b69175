"""How far rounding alone moves the NL-OCD closed loop: the B=2 x 3-step
rollout of ``chip_smoke.py`` phase 7 on the card, once with the epoch
kernel and once with the epoch's plain twin on the card's tensors (the
algebra of the CPU path, only the card's rounding), each against the CPU
path.

    python -m colaborativempc_tpu_torch.scripts.rounding_control

Prints one line per coupling/sweep and variant: max |dx_pred| against the
CPU path, and whether the OCD iteration counts agree. Needs a CUDA device.
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    from colaborativempc_tpu_torch.ops import admm, cuda_lqr
    from colaborativempc_tpu_torch.utils import resolve_device
    dev = resolve_device("cuda")
    kernel = admm.admm_epoch_batched
    for coupling, sweep in (("eu", "jacobi"), ("hp_opt", "gauss_seidel")):
        x_cpu, its_cpu = rollout(coupling, sweep, torch.device("cpu"),
                                 args.steps)
        for name, epoch in (("kernel", kernel),
                            ("plain twin on the card",
                             cuda_lqr.admm_epoch_batched_plain)):
            admm.admm_epoch_batched = epoch
            try:
                x, its = rollout(coupling, sweep, dev, args.steps)
            finally:
                admm.admm_epoch_batched = kernel
            print(f"{coupling}/{sweep}, {name}: max |dx_pred| vs the CPU "
                  f"path {float((x - x_cpu).abs().max()):.4g}, OCD "
                  f"iterations equal: {bool(torch.equal(its, its_cpu))} "
                  f"[{torch.cuda.get_device_name(0)}]", flush=True)


if __name__ == "__main__":
    main()
