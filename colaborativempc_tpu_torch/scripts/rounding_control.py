"""How far rounding alone moves the NL-OCD closed loop: the B=2 x 3-step
rollout of ``chip_smoke.py`` phase 7 on the card, with each epoch's two
steps, its fixed data (``admm_epoch_inputs``) and its iterations
(``admm_epoch_batched``), each either the CUDA kernel or the plain version
on the card's tensors (the algebra of the CPU path, only the card's
rounding), in the four combinations, each against the CPU path.

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
    inputs, epoch = admm.admm_epoch_inputs, admm.admm_epoch_batched
    variants = (
        ("both kernels", inputs, epoch),
        ("epoch-data kernel, plain epoch on the card", inputs,
         cuda_lqr.admm_epoch_batched_plain),
        ("plain epoch data on the card, epoch kernel",
         admm.admm_epoch_inputs_plain, epoch),
        ("both plain on the card", admm.admm_epoch_inputs_plain,
         cuda_lqr.admm_epoch_batched_plain))
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
