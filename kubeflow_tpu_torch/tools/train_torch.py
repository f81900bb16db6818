"""PyTorch worker entrypoint: the port of kubeflow_tpu/tools/train_torch.py.

The JAX package's torch profile runs a deliberately minimal loop (linear
regression) through the same ``KFT_*`` gang machinery as its JAX jobs:
the contract is translated into torch.distributed's variables
(``MASTER_ADDR`` et al., ``runtime/bootstrap.torch_dist_env``), and a
multi-process job averages its gradients with DDP.  The port runs the
same loop, with the same flags and seeds, on CUDA unless ``--device
cpu`` is given (an error without a GPU): a multi-process job's group is
NCCL on CUDA and gloo on the CPU (``KFT_DIST_BACKEND=gloo`` when several
processes share one GPU).  The JAX package's torch_xla branch (its TPU
image) has no counterpart here.

    python -m kubeflow_tpu_torch.tools.train_torch --steps 10
    python -m kubeflow_tpu_torch.tools.train_torch --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None) -> list:
    """``main``'s work; returns every step's loss (floats)."""
    ap = argparse.ArgumentParser(prog="kubeflow-tpu-torch-train-torch")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--features", type=int, default=8)
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (cuda is an error without a GPU)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.runtime import bootstrap

    device = resolve_device(args.device)
    env = bootstrap.worker_env()
    for key, value in bootstrap.torch_dist_env(env).items():
        os.environ.setdefault(key, value)

    import torch

    distributed = env.is_distributed
    if distributed:
        import torch.distributed as dist

        bootstrap.initialize(env, device=device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())

    torch.manual_seed(env.process_id)
    model = torch.nn.Linear(args.features, 1).to(device)
    if distributed:
        model = torch.nn.parallel.DistributedDataParallel(model)
    opt = torch.optim.SGD(model.parameters(), lr=args.learning_rate)
    true_w = torch.arange(args.features, dtype=torch.float32,
                          device=device)

    losses = []
    loss = None
    for step in range(args.steps):
        x = torch.randn(args.batch_size, args.features, device=device)
        y = (x @ true_w)[:, None]
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()  # DDP averages the gradients over the gang here
        opt.step()
        losses.append(loss.item())
        if step % max(1, args.steps // 5) == 0:
            logging.info("step %d loss %.4f", step, losses[-1])

    if distributed:
        dist.destroy_process_group()
    if loss is not None:  # --steps 0 runs no iterations
        logging.info("torch training done: loss %.4f", losses[-1])
    else:
        logging.info("torch training done: 0 steps")
    return losses


if __name__ == "__main__":
    sys.exit(main())
