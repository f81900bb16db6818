"""LM training entry point of the port: the counterpart of
kubeflow_tpu/tools/train_lm.py, with the same flags plus ``--device``.

    python -m kubeflow_tpu_torch.tools.train_lm --attention flash --remat \\
        --steps 100                       # on the GPU
    python -m kubeflow_tpu_torch.tools.train_lm --device cpu --d-model 64 \\
        --n-layers 2 --seq-len 64 --vocab-size 256 --steps 2

It trains on CUDA unless ``--device cpu`` is given, and an error when
there is no GPU: on one device, or over a mesh of processes, one GPU
each, with ``--mesh data=2,fsdp=2,pipeline=2,sequence=2,tensor=2``
(parsed as the JAX entry point parses it; ``model`` is ``tensor``'s
other name), ``--attention ring`` for the sequence axis,
``--pipeline-microbatches M`` for the pipeline axis (GPipe: each stage
holds ``n_layers / pipeline`` layers; ``pipeline`` > 1 without it is an
error, as in JAX) and ``--mesh expert=N`` with ``--moe-experts E`` for
the expert axis (each rank holds E/N experts; N divides E).  A
multi-process job is started by the operator's ``KFT_*`` variables or by
``torchrun`` (runtime/bootstrap.py);
without ``--mesh`` it is data-parallel over every rank, as the JAX entry
point's default mesh is, and so is ``--attention ring`` alone.  Each
rank trains on ``--batch-size-per-device`` rows (the ranks of a
``sequence`` group share theirs, each keeping its shard of the
sequence, and the ranks of a ``tensor`` group theirs, each holding its
slice of the heads, mlp and vocab, and the ranks of a ``pipeline``
group theirs, each holding its stage's layers, and the ranks of an
``expert`` group theirs, each holding its share of the experts), drawn
by its (data, fsdp) coordinate: KFTR shards ``RecordDataset(...).shard(i,
data * fsdp)``, or a synthetic stream seeded with i.  ``--moe-experts N``
(with ``--moe-capacity-factor``) trains the mixture-of-experts LM
(models/moe.py; top-2, the einsum dispatch, as in the JAX entry point),
under any mesh, its routing groups JAX's whichever ranks hold their
tokens.  ``--optimizer adafactor`` trains under every axis, its
statistics those of the whole JAX leaves (runtime/optim.py).
``--optimizer adafactor``, ``--data-files``
(KFTR shards of {"tokens": [s]} examples, data/) and
``--checkpoint-dir`` / ``--checkpoint-every`` (verified checkpoints,
runtime/checkpoint.py; a rerun resumes from the newest verified step)
are wired as in the JAX entry point.  ``--metrics-out`` writes the JAX
entry point's JSON ({"config": ..., "history": [...]}).  MFU is over the
bf16 peak of the shape ``KFT_SLICE_TYPE`` names (``h100-8``; the JAX
entry point's rule), else of the card (runtime/topology.py's table).
With ``KFT_LOG_LAUNCHES`` set in its environment it logs, after each
step and at the end, ``KFT_LAUNCHES {"step": N, "counts": {...}}`` on
stderr: the flash kernels' launch counters of this process (a worker
the operator started reports them in its log).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

# Set in a worker's environment to have it log its kernel launch
# counters (module docstring).
LAUNCHES_ENV = "KFT_LOG_LAUNCHES"

def parse_mesh(flag: str) -> dict:
    """``--mesh`` as the JAX entry point parses it: ``axis=size`` pairs
    separated by commas, ``model`` another name for ``tensor``; an axis
    named twice is an error."""
    axes = {}
    for pair in filter(None, flag.split(",")):
        k, _, v = pair.partition("=")
        k = k.strip()
        if k == "model":
            k = "tensor"
        if k in axes:
            raise ValueError(f"--mesh declares axis {k!r} twice (note "
                             "'model' aliases 'tensor')")
        axes[k] = int(v)
    return axes


def _not_ported(args, mesh_axes: dict) -> str:
    """The first flag this port does not serve yet, with its ROADMAP
    item, or ''.  Every flag of the JAX entry point trains now."""
    return ""


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

    try:
        mesh_axes = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    if mesh_axes.get("pipeline", 1) > 1 and not args.pipeline_microbatches:
        # Without microbatches the stages would run one after another on
        # the whole batch: the pipeline axis would only idle all but one.
        ap.error("--mesh pipeline>1 requires --pipeline-microbatches>0 "
                 "(otherwise the pipeline axis is pure overhead: the "
                 "layer stack is sharded over it but the GPipe schedule "
                 "never runs)")
    missing = _not_ported(args, mesh_axes)
    if missing:
        raise NotPortedError(f"not ported yet: {missing}")

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.testing import faults

    # Honor KFT_FAULTS as the JAX entry point does: the same scripted
    # chaos (train.step) drives a deployed container and in-process tests.
    faults.install_from_env()
    env = bootstrap.initialize(device=args.device)

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
    from kubeflow_tpu_torch.runtime.topology import mfu_peak
    from kubeflow_tpu_torch.runtime.train import Trainer

    device = resolve_device(args.device)
    mesh = None
    dp_index, dp_count = 0, 1
    if args.mesh or env.is_distributed or args.attention == "ring":
        from kubeflow_tpu_torch.parallel.mesh import (
            DATA,
            FSDP,
            MeshSpec,
        )

        mesh = MeshSpec(**mesh_axes).build(device)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        dp_index = mesh.get_local_rank(DATA) * sizes[FSDP] \
            + mesh.get_local_rank(FSDP)
        dp_count = sizes[DATA] * sizes[FSDP]
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads, d_ff=args.d_ff,
        head_dim=args.head_dim, max_seq_len=args.seq_len,
        moe_experts=args.moe_experts,
        moe_capacity_factor=args.moe_capacity_factor,
        attention=args.attention,
        remat=args.remat, ce_dtype=args.ce_dtype,
        pipeline_microbatches=args.pipeline_microbatches,
    )
    init_fn, loss_fn = lm_task(cfg, device=device, mesh=mesh)
    # Rows of this rank (one GPU a process), and of the global batch: the
    # ranks of a sequence group, of a tensor group and of a pipeline
    # group share their rows, and only the (data, fsdp) coordinate picks
    # them.
    batch = args.batch_size_per_device
    global_batch = batch * dp_count
    peak = mfu_peak(env.slice_type, device)
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
        init_fn=init_fn, loss_fn=loss_fn, tx=tx, device=device, mesh=mesh,
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
            ).shard(dp_index, dp_count)
            return tensor_batches(ds, batch)
    else:
        def data_factory():
            # Fresh RNG per attempt: a supervised restart replays the
            # SAME stream, and fit's resume drain re-aligns it.
            rng = np.random.RandomState(dp_index)
            while True:
                yield {"tokens": rng.randint(
                    0, args.vocab_size,
                    size=(batch, args.seq_len)).astype(np.int32)}

    supervisor = TrainSupervisor(
        trainer, max_restarts=args.max_restarts,
        stall_factor=args.stall_factor, heartbeat_s=args.heartbeat_s)
    on_step = None
    if os.environ.get(LAUNCHES_ENV):
        from kubeflow_tpu_torch.ops import flash

        def on_step(step):
            print("KFT_LAUNCHES " + json.dumps(
                {"step": int(step), "counts": dict(flash.launch_counts)}),
                file=sys.stderr, flush=True)
    state = supervisor.run(
        data_factory, args.steps, examples_per_step=global_batch,
        log_every=args.log_every, steps_per_call=args.steps_per_call,
        on_step=on_step)
    if on_step is not None:
        on_step(state.step)
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
