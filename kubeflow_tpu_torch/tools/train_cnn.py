"""CNN training entry point of the port: the counterpart of
kubeflow_tpu/tools/train_cnn.py, with the same flags plus ``--device``.

    python -m kubeflow_tpu_torch.tools.train_cnn --model resnet50 \\
        --batch-size-per-device 256 --steps 100        # on the GPU
    python -m kubeflow_tpu_torch.tools.train_cnn --device cpu \\
        --model resnet18 --image-size 32 --batch-size-per-device 2 --steps 2

It trains a ResNet (models/resnet.py) with ``classification_task``, SGD
with momentum 0.9 (optax's semantics), the ``Trainer`` and the
``TrainSupervisor`` on one device: CUDA unless ``--device cpu`` is
given, and an error when there is no GPU.  Data is synthetic (a numpy
``RandomState`` seeded by the process id, as in the JAX entry point) or,
with ``--data-dir``, the KFTR shards of ``{"image", "label"}`` examples
under it through the record pipeline (data/).  ``--checkpoint-dir``
saves verified checkpoints every ``--checkpoint-every`` steps, and a
rerun resumes from the newest verified step.  MFU is reported over the
bf16 peak of the shape ``KFT_SLICE_TYPE`` names, else of the card
(runtime/topology.py's table).

A multi-process gang (the operator's ``KFT_NUM_PROCESSES`` /
``KFT_PROCESS_ID`` / ``KFT_COORDINATOR_ADDRESS``, or ``torchrun``; one
GPU a process, or ``KFT_DIST_BACKEND=gloo`` when several share one)
trains data-parallel as the JAX entry point does: ``MeshSpec(data=N)``
over its N processes and ``Trainer(mesh=)``, each process on
``--batch-size-per-device`` rows of its own (the KFTR shards split
``RecordDataset(...).shard(process_id, N)``, the synthetic stream
seeded with its process id), the step's examples the global batch, and
BatchNorm's statistics the global batch's (models/classification.py).
The trainer wraps the model with FSDP2 at its root over that mesh,
which is data alone (fsdp 1): the parameters are replicated, and the
gradients all-reduced over the data ranks once a step.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys


def main(argv=None) -> int:
    trainer = run(argv)
    return 0 if trainer is not None else 1


def run(argv=None):
    """``main``'s work: trains as the flags say and returns the
    ``Trainer`` (its ``last_metrics`` hold the final step's loss,
    grad_norm and accuracy), or None when ``--data-dir`` holds no
    shards."""
    ap = argparse.ArgumentParser(prog="kubeflow-tpu-torch-train-cnn")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch-size-per-device", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--data-dir", default="",
                    help="directory of KFTR shards with image/label "
                         "examples; synthetic data when unset")
    ap.add_argument("--shuffle-buffer", type=int, default=4096)
    ap.add_argument("--data-threads", type=int, default=4)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--learning-rate", type=float, default=0.1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="in-process supervised restarts from the last "
                         "verified checkpoint (0 = fail on the first "
                         "fault)")
    ap.add_argument("--stall-factor", type=float, default=10.0,
                    help="flag a stall when the current dispatch age "
                         "exceeds this multiple of the rolling median "
                         "step time")
    ap.add_argument("--heartbeat-s", type=float, default=10.0,
                    help="stall-watchdog poll period (also the "
                         "kft_train_heartbeat_age_seconds refresh)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (cuda is an error without a GPU)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.testing import faults

    # Honor KFT_FAULTS as the JAX entry point does: the same scripted
    # chaos (train.step, checkpoint.*) drives a deployed container and
    # in-process tests.
    faults.install_from_env()
    env = bootstrap.initialize(device=args.device)

    import numpy as np
    import torch

    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models.classification import classification_task
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
    from kubeflow_tpu_torch.runtime.supervisor import TrainSupervisor
    from kubeflow_tpu_torch.runtime.topology import mfu_peak
    from kubeflow_tpu_torch.runtime.train import Trainer

    files = []
    if args.data_dir:
        files = sorted(glob.glob(os.path.join(args.data_dir, "*.kftr")))
        if not files:
            logging.error("no *.kftr shards under %s", args.data_dir)
            return None
    device = resolve_device(args.device)
    mesh = None
    if env.is_distributed:
        from kubeflow_tpu_torch.parallel.mesh import MeshSpec

        mesh = MeshSpec(data=env.num_processes).build(device)
    batch = args.batch_size_per_device  # this process's rows
    size = args.image_size
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cfg = ResNetConfig(name=args.model, num_classes=args.num_classes,
                       dtype=dtype)
    init_fn, loss_fn = classification_task(
        cfg.build(device=device), (1, size, size, 3), device=device,
        mesh=mesh)
    ckpt = (CheckpointManager(args.checkpoint_dir)
            if args.checkpoint_dir else None)
    trainer = Trainer(
        init_fn=init_fn, loss_fn=loss_fn,
        tx=optim.sgd(args.learning_rate, momentum=0.9), device=device,
        mesh=mesh,
        checkpoints=ckpt, checkpoint_every=args.checkpoint_every,
        metrics=MetricsLogger(static={"job": env.job_name,
                                      "process": env.process_id}),
        flops_per_example=cfg.fwd_flops_per_image * (size / 224) ** 2,
        peak_flops_per_chip=mfu_peak(env.slice_type, device),
    )

    if files:
        from kubeflow_tpu_torch.data import RecordDataset, tensor_batches

        def data_factory():
            ds = RecordDataset(
                files, num_threads=args.data_threads,
                shuffle_buffer=args.shuffle_buffer, seed=env.process_id,
                repeat=-1,  # cycle forever; steps bound the run
            )
            if env.num_processes > 1:
                ds = ds.shard(env.process_id, env.num_processes)
            return tensor_batches(ds, batch)
    else:
        def data_factory():
            # Fresh RNG per attempt: a supervised restart replays the
            # SAME stream, and fit's resume drain re-aligns it.
            rng = np.random.RandomState(env.process_id)
            while True:
                yield {
                    "image": rng.randn(batch, size, size, 3).astype(
                        np.float32),
                    "label": rng.randint(0, args.num_classes,
                                         size=(batch,)),
                }

    supervisor = TrainSupervisor(
        trainer, max_restarts=args.max_restarts,
        stall_factor=args.stall_factor, heartbeat_s=args.heartbeat_s)
    supervisor.run(data_factory, args.steps,
                   examples_per_step=batch * env.num_processes,
                   log_every=args.log_every)
    logging.info("training done: %s", trainer.last_metrics)
    return trainer


if __name__ == "__main__":
    sys.exit(main())
