"""LM training entry point of the port: the counterpart of
kubeflow_tpu/tools/train_lm.py, with the same flags plus ``--device``.

    python -m kubeflow_tpu_torch.tools.train_lm --attention flash --remat \\
        --steps 100                       # on the GPU
    python -m kubeflow_tpu_torch.tools.train_lm --device cpu --d-model 64 \\
        --n-layers 2 --seq-len 64 --vocab-size 256 --steps 2

It trains on one device: CUDA unless ``--device cpu`` is given, and an
error when there is no GPU.  ``--optimizer adafactor``, ``--data-files``
(KFTR shards of {"tokens": [s]} examples, data/) and
``--checkpoint-dir`` / ``--checkpoint-every`` (verified checkpoints,
runtime/checkpoint.py; a rerun resumes from the newest verified step)
are wired as in the JAX entry point.  The parallel flags raise
``NotPortedError`` naming their ROADMAP item.  ``--metrics-out`` writes
the JAX entry point's JSON ({"config": ..., "history": [...]}).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

# Published dense bf16 tensor-core peak per card (NVIDIA's data sheet,
# SXM part), keyed by a substring of torch.cuda.get_device_name(); the
# MFU denominator.  A card not listed reports no MFU.
PEAK_BF16_FLOPS = {"H100": 989e12}


def peak_bf16_flops(device) -> float:
    """The card's bf16 peak FLOP/s from ``PEAK_BF16_FLOPS``, or 0 (no
    MFU) on the CPU or an unlisted card."""
    import torch

    if device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in PEAK_BF16_FLOPS.items() if k in name), 0.0)


def _not_ported(args) -> str:
    """The first flag this port does not serve yet, with its ROADMAP
    item, or ''."""
    checks = [
        (args.mesh, "--mesh (parallel training, ROADMAP queue 1 item 11)"),
        (args.pipeline_microbatches > 0,
         "--pipeline-microbatches (parallel training, ROADMAP queue 1 "
         "item 11)"),
        (args.moe_experts > 0, "--moe-experts (MoE, ROADMAP queue 1 item 13)"),
        (args.attention == "ring",
         "--attention ring (parallel training, ROADMAP queue 1 item 11)"),
    ]
    return next((what for hit, what in checks if hit), "")


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None):
    """``main``'s work: trains as the flags say and returns the
    ``Trainer``, whose ``last_metrics`` hold the final step's loss,
    grad_norm and task metrics."""
    ap = argparse.ArgumentParser(prog="kubeflow-tpu-torch-train-lm")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--n-layers", type=int, default=8)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--n-kv-heads", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=1408)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--vocab-size", type=int, default=32_000)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--moe-experts", type=int, default=0)
    ap.add_argument("--pipeline-microbatches", type=int, default=0)
    ap.add_argument("--attention", default="dot",
                    choices=["dot", "flash", "ring"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ce-dtype", default="f32",
                    choices=["f32", "compute"],
                    help="cross-entropy input precision (see "
                         "TransformerConfig.ce_dtype)")
    ap.add_argument("--batch-size-per-device", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="train steps per fit call (Trainer.fit)")
    ap.add_argument("--learning-rate", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help=">0 = linear warmup to --learning-rate then "
                         "cosine decay over --steps")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--moe-capacity-factor", type=float, default=1.25)
    ap.add_argument("--metrics-out", default="",
                    help="write the final metrics history as JSON "
                         "(loss-curve artifact)")
    ap.add_argument("--mesh", default="")
    ap.add_argument("--data-files", nargs="*", default=[],
                    help="KFTR shards with {'tokens': [s]} examples "
                         "(synthetic stream if empty)")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=100)
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
                    help="stall-watchdog poll period")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (cuda is an error without a GPU)")
    args = ap.parse_args(argv)

    from kubeflow_tpu_torch import NotPortedError

    missing = _not_ported(args)
    if missing:
        raise NotPortedError(f"not ported yet: {missing}")

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.testing import faults

    # Honor KFT_FAULTS as the JAX entry point does: the same scripted
    # chaos (train.step) drives a deployed container and in-process tests.
    faults.install_from_env()
    env = bootstrap.initialize()

    import numpy as np

    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
    from kubeflow_tpu_torch.runtime.supervisor import TrainSupervisor
    from kubeflow_tpu_torch.runtime.train import Trainer

    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads, d_ff=args.d_ff,
        head_dim=args.head_dim, max_seq_len=args.seq_len,
        moe_capacity_factor=args.moe_capacity_factor,
        attention=args.attention,
        remat=args.remat, ce_dtype=args.ce_dtype,
    )
    init_fn, loss_fn = lm_task(cfg, device=device)
    batch = args.batch_size_per_device  # one device
    peak = peak_bf16_flops(device)
    if args.warmup_steps > 0:
        lr = optim.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=args.learning_rate,
            warmup_steps=args.warmup_steps, decay_steps=args.steps,
            end_value=args.learning_rate * 0.1)
    else:
        lr = args.learning_rate
    tx = (optim.adafactor(lr) if args.optimizer == "adafactor"
          else optim.adamw(lr))
    trainer = Trainer(
        init_fn=init_fn, loss_fn=loss_fn, tx=tx, device=device,
        checkpoints=(CheckpointManager(args.checkpoint_dir)
                     if args.checkpoint_dir else None),
        checkpoint_every=args.checkpoint_every,
        metrics=MetricsLogger(static={"job": env.job_name,
                                      "process": env.process_id}),
        flops_per_example=cfg.flops_per_token() * args.seq_len,
        peak_flops_per_chip=peak,
    )

    if args.data_files:
        from kubeflow_tpu_torch.data import RecordDataset, tensor_batches

        def data_factory():
            ds = RecordDataset(
                args.data_files, shuffle_buffer=1024, repeat=-1,
            ).shard(env.process_id, max(env.num_processes, 1))
            return tensor_batches(ds, batch)
    else:
        def data_factory():
            # Fresh RNG per attempt: a supervised restart replays the
            # SAME stream, and fit's resume drain re-aligns it.
            rng = np.random.RandomState(env.process_id)
            while True:
                yield {"tokens": rng.randint(
                    0, args.vocab_size,
                    size=(batch, args.seq_len)).astype(np.int32)}

    supervisor = TrainSupervisor(
        trainer, max_restarts=args.max_restarts,
        stall_factor=args.stall_factor, heartbeat_s=args.heartbeat_s)
    supervisor.run(data_factory, args.steps, examples_per_step=batch,
                   log_every=args.log_every,
                   steps_per_call=args.steps_per_call)
    logging.info("training done: %s", trainer.last_metrics)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({
                "config": {k: v for k, v in vars(args).items()
                           if isinstance(v, (int, float, str, bool))},
                "history": trainer.metrics.history,
            }, f, indent=1, default=float)
            f.write("\n")
        logging.info("metrics history -> %s", args.metrics_out)
    return trainer


if __name__ == "__main__":
    sys.exit(main())
