"""One rank of the mesh-training jobs of tests/test_torch_parallel_train.py.

JAX-free: the test writes the JAX model's converted weights and the
batches to ``WORKDIR/inputs.pt``, starts the ranks with
``kubeflow_tpu_torch.testing.ranks.run_ranks`` (the ``KFT_*`` variables
name each), and reads what each rank writes to ``WORKDIR/rank<r>.pt``:

    python tests/torch_mesh_train_worker.py mesh8 WORKDIR    # 8 ranks
    python tests/torch_mesh_train_worker.py world1 WORKDIR   # 1 rank
    python tests/torch_mesh_train_worker.py train_lm WORKDIR  # 2 ranks

``mesh8`` trains the LM at data=2, fsdp=2, sequence=2 with ring attention
(adamw, sgd, remat, identical rows on every data shard, checkpoints and
their resume, adafactor's refusal); ``world1`` holds a one-rank mesh
trainer to the trainer without a mesh; ``train_lm`` is
``tools/train_lm.py`` through the bootstrap at fsdp=2.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kubeflow_tpu_torch import NotPortedError  # noqa: E402
from kubeflow_tpu_torch.models.convert import load_params  # noqa: E402
from kubeflow_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    lm_task,
)
from kubeflow_tpu_torch.parallel.mesh import (  # noqa: E402
    DATA,
    FSDP,
    MeshSpec,
    axis_sizes,
)
from kubeflow_tpu_torch.runtime import bootstrap, optim  # noqa: E402
from kubeflow_tpu_torch.runtime.checkpoint import (  # noqa: E402
    CheckpointManager,
)
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger  # noqa: E402
from kubeflow_tpu_torch.runtime.train import Trainer  # noqa: E402


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def trainer(spec, mesh, tx, checkpoints=None, **overrides):
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(spec["cfg"], **overrides))
    base_init, loss_fn = lm_task(cfg, device="cpu", mesh=mesh)

    def init_fn(gen):
        model, mutable = base_init(gen)
        return load_params(model, _clone(spec["params"])), mutable

    return Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=tx, device="cpu",
                   mesh=mesh, checkpoints=checkpoints, checkpoint_every=1,
                   metrics=MetricsLogger(stream=open(os.devnull, "w")))


def full_params(model):
    """Every parameter gathered whole (a collective on every rank)."""
    return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
            .detach().clone() for n, p in model.named_parameters()}


def run_steps(tr, batches, rows):
    state = tr.create_state(seed=0)
    step = tr.compile_step()
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, tr.shard_batch(rows(batch)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def mesh8(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    mesh = MeshSpec(data=2, fsdp=2, sequence=2).build("cpu", timeout_s=60)
    sizes = axis_sizes(mesh)
    dp = mesh.get_local_rank(DATA) * sizes[FSDP] + mesh.get_local_rank(FSDP)
    dp_count = sizes[DATA] * sizes[FSDP]

    def rows(batch):
        b = batch.shape[0] // dp_count
        return {"tokens": batch[dp * b:(dp + 1) * b]}

    out = {}
    tr = trainer(spec, mesh, optim.adamw(1e-3))
    state = tr.create_state(seed=0)
    names = [n for n, _ in state.params.named_parameters()]
    out["shard_shapes"] = {n: tuple(_local(p).shape)
                           for n, p in state.params.named_parameters()}
    out["placements"] = {n: str(p.placements)
                         for n, p in state.params.named_parameters()}
    out["mu_shapes"] = {n: tuple(_local(m).shape)
                        for n, m in zip(names, state.opt_state.mu)}
    state, out["adamw_losses"], out["adamw_norms"] = run_steps(
        tr, spec["batches"], rows)
    out["adamw_params"] = full_params(state.params)

    _, out["remat_losses"], out["remat_norms"] = run_steps(
        trainer(spec, mesh, optim.adamw(1e-3), remat=True),
        spec["batches"][:2], rows)

    state, out["sgd_losses"], _ = run_steps(
        trainer(spec, mesh, optim.sgd(spec["sgd_lr"])), spec["batches"][:3],
        rows)
    out["sgd_params"] = full_params(state.params)

    _, out["same_rows_losses"], out["same_rows_norms"] = run_steps(
        trainer(spec, mesh, optim.sgd(spec["sgd_lr"])), [spec["same_rows"]],
        rows)

    ckdir = workdir / "ckpt"
    tr = trainer(spec, mesh, optim.adamw(1e-3), CheckpointManager(ckdir))
    state = tr.fit(iter([rows(b) for b in spec["batches"]]), 2, log_every=0)
    out["ckpt_params"] = full_params(state.params)
    tr = trainer(spec, mesh, optim.adamw(1e-3), CheckpointManager(ckdir))
    tr.fit(iter([rows(b) for b in spec["batches"]]), 3, log_every=0)
    out["resumed_loss"] = tr.last_metrics["loss"]

    try:
        trainer(spec, mesh, optim.adafactor(1e-3)).create_state(seed=0)
        out["adafactor"] = "trained"
    except NotPortedError as e:
        out["adafactor"] = str(e)
    return out


def world1(spec, workdir):
    """A one-rank mesh (its group started by MeshSpec.build) against no
    mesh, on the same weights and batches: flash with remat, and the
    ring (a ring of one) against flash."""
    mesh = MeshSpec(data=1).build("cpu", timeout_s=60)
    out = {}
    for name, mesh_over, plain_over in (
            ("flash_remat", dict(attention="flash", remat=True),
             dict(attention="flash", remat=True)),
            ("ring", dict(attention="ring"), dict(attention="flash"))):
        runs = []
        for m, over in ((mesh, mesh_over), (None, plain_over)):
            state, losses, norms = run_steps(
                trainer(spec, m, optim.adamw(1e-3), **over),
                spec["batches"][:3], lambda b: {"tokens": b[:2]})
            runs.append((losses, norms, full_params(state.params)))
        out[name] = runs
    return out


def train_lm(spec, workdir):
    from kubeflow_tpu_torch.tools import train_lm as tool

    trainer = tool.run(spec["train_lm_argv"])
    return {"history": trainer.metrics.history,
            "last": trainer.last_metrics,
            "world": dist.get_world_size()}


def main(scenario, workdir):
    workdir = Path(workdir)
    spec = torch.load(workdir / "inputs.pt", weights_only=True)
    out = {"mesh8": mesh8, "world1": world1, "train_lm": train_lm}[
        scenario](spec, workdir)
    rank = dist.get_rank() if dist.is_initialized() else 0
    torch.save(out, workdir / f"{scenario}-rank{rank}.pt")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
