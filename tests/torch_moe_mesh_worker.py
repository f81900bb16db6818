"""One rank of the MoE mesh jobs of tests/test_torch_moe_mesh.py.

JAX-free: the test writes the JAX models' converted weights, the configs
and the batches to ``WORKDIR/inputs.pt``, starts the ranks with
``kubeflow_tpu_torch.testing.ranks.run_ranks`` (the ``KFT_*`` variables
name each), and reads what each rank writes to
``WORKDIR/<job>-rank<r>.pt``:

    python tests/torch_moe_mesh_worker.py moe8 WORKDIR        # 8 ranks
    python tests/torch_moe_mesh_worker.py moe_batch4 WORKDIR  # 4 ranks
    python tests/torch_moe_mesh_worker.py moe_pipe8 WORKDIR   # 8 ranks
    python tests/torch_moe_mesh_worker.py train_lm WORKDIR    # 2 ranks

``moe8`` trains the MoE LM at data=2, expert=2, tensor=2 (adamw steps,
shard shapes, a checkpoint, adafactor steps); ``moe_batch4`` at
data=2, sequence=2 with the ring and the trainer without a mesh on the
global batch, with each rank's aux over its own tokens alone and a
routing group that spans ranks, then at fsdp=2, expert=2 with the gather
dispatch and without a mesh; ``moe_pipe8`` at data=2, pipeline=2,
expert=2 (one loss and its gradients from each rank's contiguous rows,
which the loss exchanges into JAX's microbatches, the rows it then holds
and the aux of its own contiguous microbatches, a routing group that
spans ranks, the trainer's steps, adamw and adafactor), then at
pipeline=2, sequence=2, expert=2 with the ring (one step);
``train_lm`` is ``tools/train_lm.py --mesh expert=2 --moe-experts 4``.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kubeflow_tpu_torch import NotPortedError  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    load_params,
    params_to_jax,
    whole_parameters,
)
from kubeflow_tpu_torch.models.moe import Spread  # noqa: E402
from kubeflow_tpu_torch.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
    lm_task,
    microbatch_rows,
    to_microbatch_order,
)
from kubeflow_tpu_torch.parallel.mesh import (  # noqa: E402
    DATA,
    FSDP,
    SEQUENCE,
    MeshSpec,
    axis_sizes,
    batch_group,
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


def _cfg(cfg, **overrides):
    return TransformerConfig(dtype=torch.float32, **dict(cfg, **overrides))


def trainer(cfg, params, mesh, tx, checkpoints=None, **overrides):
    """The port's trainer at ``cfg`` with ``overrides``, from the JAX
    initial weights ``params``."""
    base_init, loss_fn = lm_task(_cfg(cfg, **overrides), device="cpu",
                                 mesh=mesh)

    def init_fn(gen):
        model, mutable = base_init(gen)
        return load_params(model, _clone(params)), mutable

    return Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=tx, device="cpu",
                   mesh=mesh, checkpoints=checkpoints, checkpoint_every=1,
                   metrics=MetricsLogger(stream=open(os.devnull, "w")))


def model(cfg, params, mesh, **overrides):
    return load_params(Transformer(_cfg(cfg, **overrides), device="cpu",
                                   mesh=mesh), _clone(params))


def dp_rows(mesh):
    """A batch -> this rank's rows (its data x fsdp shard)."""
    sizes = axis_sizes(mesh)
    dp = mesh.get_local_rank(DATA) * sizes[FSDP] + mesh.get_local_rank(FSDP)
    count = sizes[DATA] * sizes[FSDP]

    def rows(batch):
        b = batch.shape[0] // count
        return {"tokens": batch[dp * b:(dp + 1) * b]}

    return rows


def run_steps(tr, batches, rows):
    state = tr.create_state(seed=0)
    step = tr.compile_step()
    metrics = {"loss": [], "grad_norm": [], "moe_aux": []}
    for batch in batches:
        state, m = step(state, tr.shard_batch(rows(batch)))
        for key, values in metrics.items():
            values.append(float(m[key]))
    return state, metrics


def full_params(module):
    """Every parameter of the whole model, gathered (a collective)."""
    return {n: p.clone() for n, p in whole_parameters(module).items()}


def refused(fn) -> str:
    try:
        fn()
    except (NotPortedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "accepted"


def moe8(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    mesh = MeshSpec(data=2, expert=2, tensor=2).build("cpu", timeout_s=60)
    cfg, params, rows = spec["cfg"], spec["params"], dp_rows(mesh)
    tr = trainer(cfg, params, mesh, optim.adamw(1e-3))
    state = tr.create_state(seed=0)
    out = {"shard_shapes": {n: tuple(_local(p).shape)
                            for n, p in state.params.named_parameters()}}
    state, out["adamw"] = run_steps(tr, spec["batches"], rows)
    out["adamw_params"] = full_params(state.params)

    ckdir = workdir / "ckpt_moe8"
    tr = trainer(cfg, params, mesh, optim.adamw(1e-3),
                 CheckpointManager(ckdir))
    state = tr.fit(iter([rows(b) for b in spec["batches"]]), 2, log_every=0)
    out["ckpt_params"] = full_params(state.params)
    # adafactor over the expert x tensor slices of wi and wo.
    state, out["adafactor"] = run_steps(
        trainer(cfg, params, mesh, optim.adafactor(1e-3)), spec["batches"],
        rows)
    out["adafactor_params"] = full_params(state.params)
    return out


def moe_batch4(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    mesh = MeshSpec(data=2, sequence=2).build("cpu", timeout_s=60)
    cfg, params = spec["cfg"], spec["params"]
    batches = spec["long_batches"]
    group = dict(moe_group_size=spec["ring_group"])
    out = {}
    for name, m, over in (("mesh", mesh, dict(attention="ring")),
                          ("plain", None, dict(attention="flash"))):
        feed = dp_rows(mesh) if m is not None else (lambda b: {"tokens": b})
        state, out[name] = run_steps(
            trainer(cfg, params, m, optim.adamw(1e-3), **group, **over),
            batches, feed)
        out[f"{name}_params"] = full_params(state.params)

    # The aux of this rank's own tokens alone (each MoE layer's spread
    # taken away) on the first batch, beside the global one.
    ring = model(cfg, params, mesh, attention="ring", **group)
    n, r = axis_sizes(mesh)[SEQUENCE], mesh.get_local_rank(SEQUENCE)
    tokens = dp_rows(mesh)(batches[0])["tokens"]
    s = tokens.shape[1] // n
    tokens = tokens[:, r * s:(r + 1) * s]
    with torch.no_grad():
        out["global_aux"] = float(ring(tokens, return_aux=True)[1])
        for block in ring.layers:
            block.moe.spread = Spread()
        out["local_aux"] = float(ring(tokens, return_aux=True)[1])
    out["spanning"] = refused(lambda: model(
        cfg, params, mesh, attention="ring",
        moe_group_size=2 * spec["ring_group"])(tokens))

    # fsdp=2, expert=2 with the gather dispatch: FSDP2 shards each rank's
    # experts on their embed dim.
    mesh = MeshSpec(fsdp=2, expert=2).build("cpu", timeout_s=60)
    for name, m in (("fsdp", mesh), ("fsdp_plain", None)):
        feed = dp_rows(mesh) if m is not None else (lambda b: {"tokens": b})
        state, out[name] = run_steps(
            trainer(cfg, params, m, optim.adamw(1e-3), moe_impl="gather"),
            spec["batches"][:2], feed)
        out[f"{name}_params"] = full_params(state.params)
    return out


def grads_tree(module, mesh):
    """The whole model's gradient as the JAX tree (torch leaves): each
    rank's share summed over the ranks of other rows, then gathered over
    the experts and the stages (collectives)."""
    for p in module.parameters():
        dist.all_reduce(p.grad, group=batch_group(mesh))

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        return torch.from_numpy(node)

    return to_torch(params_to_jax(module, grads=True))


def moe_pipe8(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    out = {}
    # data=2, pipeline=2, expert=2: each rank is fed its contiguous rows
    # of the global batch, as train_lm feeds them; the loss exchanges
    # them so that rank d's local microbatch m is its share of JAX's
    # microbatch m, global rows [m B/M + d mb, m B/M + (d + 1) mb).
    mesh = MeshSpec(data=2, pipeline=2, expert=2).build("cpu", timeout_s=60)
    cfg, params, pipe = spec["cfg"], spec["params"], spec["pipe"]
    n_micro = pipe["pipeline_microbatches"]
    own = dp_rows(mesh)(spec["pipe_tokens"])
    _, loss_fn = lm_task(_cfg(cfg, **pipe), device="cpu", mesh=mesh)
    piped = model(cfg, params, mesh, **pipe)
    loss, (metrics, _) = loss_fn(piped, {}, own, None)
    loss.backward()
    out["pipe_loss"] = float(loss)
    out["pipe_aux"] = float(metrics["moe_aux"])
    out["pipe_grads"] = grads_tree(piped, mesh)
    out["data_index"] = mesh.get_local_rank(DATA)
    out["held_rows"] = microbatch_rows(own["tokens"].shape[0], mesh,
                                       n_micro).tolist()
    mine = to_microbatch_order(own["tokens"], mesh, n_micro)
    with torch.no_grad():
        # The aux of the rank's own contiguous rows as its microbatches.
        out["own_rows_aux"] = float(model(cfg, params, mesh, **pipe)(
            own["tokens"], return_aux=True)[1])
    out["spanning"] = refused(lambda: model(
        cfg, params, mesh, **dict(pipe, moe_group_size=2 * pipe[
            "moe_group_size"]))(mine))

    # The trainer on the same mesh, each rank fed its contiguous rows as
    # train_lm feeds them, against the JAX trainer on the same global
    # batches.
    state, out["pipe_trainer"] = run_steps(
        trainer(cfg, params, mesh, optim.adamw(1e-3), **pipe),
        spec["batches"][:spec["pipe_steps"]], dp_rows(mesh))
    out["pipe_trainer_params"] = full_params(state.params)

    # pipeline=2, sequence=2, expert=2 with the ring (JAX's
    # test_pp_ring_moe_all_compose): one step.
    mesh = MeshSpec(pipeline=2, sequence=2, expert=2).build("cpu",
                                                            timeout_s=60)
    tr = trainer(spec["pps_cfg"], spec["pps_params"], mesh,
                 optim.adamw(1e-3))
    _, out["pps"] = run_steps(tr, [spec["pps_tokens"]],
                              lambda b: {"tokens": b})
    return out


def train_lm(spec, workdir):
    from kubeflow_tpu_torch.tools import train_lm as tool

    trainer = tool.run(spec["train_lm_argv"])
    return {"history": trainer.metrics.history,
            "world": dist.get_world_size()}


def main(scenario, workdir):
    workdir = Path(workdir)
    spec = torch.load(workdir / "inputs.pt", weights_only=True)
    out = {"moe8": moe8, "moe_batch4": moe_batch4, "moe_pipe8": moe_pipe8,
           "train_lm": train_lm}[scenario](spec, workdir)
    rank = dist.get_rank() if dist.is_initialized() else 0
    torch.save(out, workdir / f"{scenario}-rank{rank}.pt")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
