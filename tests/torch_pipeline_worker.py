"""One rank of the GPipe jobs of tests/test_torch_pipeline.py.

JAX-free: the test writes the JAX model's converted weights, the tanh
layers' parameters and the batches to ``WORKDIR/inputs.pt``, starts the
ranks with ``kubeflow_tpu_torch.testing.ranks.run_ranks`` (the ``KFT_*``
variables name each), and reads what each rank writes to
``WORKDIR/<job>-rank<r>.pt``:

    python tests/torch_pipeline_worker.py prim WORKDIR      # 4 ranks
    python tests/torch_pipeline_worker.py pipe2 WORKDIR     # 2 ranks
    python tests/torch_pipeline_worker.py pipe8 WORKDIR     # 8 ranks
    python tests/torch_pipeline_worker.py pipe4 WORKDIR     # 4 ranks
    python tests/torch_pipeline_worker.py train_lm WORKDIR  # 2 ranks

``prim`` runs ``pipelined_scan`` over 4 stages of the tanh layers at M 4
and 8 and with an aux that reads each layer's input, then as the second
stage of a group whose first never sends; ``pipe2`` the LM at
data=1, pipeline=2 (logits with and without remat, adamw and adafactor
steps, dropout at 0 microbatches against no mesh, a checkpoint saved
without a mesh restored onto the stages, the MoE LM against the mean of
its microbatches without a mesh, the refusals);
``pipe8`` at data=2, pipeline=2, tensor=2 (adamw steps, shard shapes, a
checkpoint and its resume); ``pipe4`` at pipeline=2, sequence=2 with the
ring (one loss and its gradients) and at fsdp=2, pipeline=2 (adamw
steps and FSDP2's reduce-scatters a step); ``train_lm`` is
``tools/train_lm.py --mesh pipeline=2 --pipeline-microbatches 4``.
"""

import datetime
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kubeflow_tpu_torch import NotPortedError  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    load_params,
    param_tree,
    params_to_jax,
    whole_parameters,
)
from kubeflow_tpu_torch.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
    lm_task,
)
from kubeflow_tpu_torch.parallel.mesh import (  # noqa: E402
    DATA,
    FSDP,
    PIPELINE,
    SEQUENCE,
    MeshSpec,
    axis_sizes,
)
from kubeflow_tpu_torch.parallel.pipeline import (  # noqa: E402
    microbatch,
    pipelined_scan,
    unmicrobatch,
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


def _cfg(spec, **overrides):
    return TransformerConfig(dtype=torch.float32,
                             **dict(spec["cfg"], **overrides))


def trainer(spec, mesh, tx, checkpoints=None, **overrides):
    """The port's trainer at the job's config with ``overrides``, from the
    JAX initial weights."""
    cfg = _cfg(spec, **overrides)
    base_init, loss_fn = lm_task(cfg, device="cpu", mesh=mesh)

    def init_fn(gen):
        model, mutable = base_init(gen)
        return load_params(model, _clone(spec["params"])), mutable

    return Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=tx, device="cpu",
                   mesh=mesh, checkpoints=checkpoints, checkpoint_every=1,
                   metrics=MetricsLogger(stream=open(os.devnull, "w")))


def model(spec, mesh, **overrides):
    return load_params(Transformer(_cfg(spec, **overrides), device="cpu",
                                   mesh=mesh), _clone(spec["params"]))


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
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, tr.shard_batch(rows(batch)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def full_params(module):
    """Every parameter of the whole model, gathered (a collective)."""
    return {n: p.clone() for n, p in whole_parameters(module).items()}


def grads_tree(module):
    """The whole model's gradients as the JAX tree, torch leaves (a
    collective)."""
    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        return torch.from_numpy(node)

    return to_torch(params_to_jax(module, grads=True))


def refused(fn) -> str:
    try:
        fn()
    except (NotPortedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "accepted"


# -- the primitive -----------------------------------------------------------


def prim(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    group, rank, stages = dist.group.WORLD, dist.get_rank(), \
        dist.get_world_size()
    w_all, b_all = spec["prim_w"], spec["prim_b"]
    per = w_all.shape[0] // stages
    out = {}

    def layers():
        w = w_all[rank * per:(rank + 1) * per].clone().requires_grad_(True)
        b = b_all[rank * per:(rank + 1) * per].clone().requires_grad_(True)
        return w, b

    for n_micro in (4, 8):
        w, b = layers()
        x = spec["prim_x"].clone().requires_grad_(True)

        def stage(a):
            for i in range(per):
                a = torch.tanh(a @ w[i] + b[i])
            return a

        y = unmicrobatch(pipelined_scan(stage, microbatch(x, n_micro), group))
        y.sum().backward()
        out[n_micro] = {"y": y.detach(), "dx": x.grad, "dw": w.grad,
                        "db": b.grad}

    w, b = layers()
    x = spec["prim_x_aux"].clone().requires_grad_(True)

    def stage_aux(a):
        # The aux reads each layer's input: a bubble step run on zeros or
        # stale data would change it.
        aux = torch.zeros(())
        for i in range(per):
            aux = aux + torch.sum(a * a)
            a = torch.tanh(a @ w[i] + b[i])
        return a, aux

    ys, aux = pipelined_scan(stage_aux, microbatch(x, 4), group,
                             with_aux=True)
    aux.backward()
    out["aux"] = {"y": unmicrobatch(ys).detach(), "aux": aux.detach(),
                  "dx": x.grad, "dw": w.grad, "db": b.grad}
    with torch.no_grad():
        ys = pipelined_scan(stage, microbatch(spec["prim_x"], 4), group)
    out["no_grad_y"] = unmicrobatch(ys)

    # Stage 1 of a 2-stage group whose stage 0 never sends: its receive
    # fails at the group's 2 s timeout instead of hanging the job.
    short = dist.new_group([0, 1], timeout=datetime.timedelta(seconds=2))
    if rank == 1:
        t0 = time.monotonic()
        try:
            pipelined_scan(stage, microbatch(spec["prim_x"], 4), short)
            out["dead_stage"] = ("no error", 0.0)
        except RuntimeError as e:
            out["dead_stage"] = (str(e), time.monotonic() - t0)
    return out


# -- the LM --------------------------------------------------------------------


def pipe2(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    mesh = MeshSpec(data=1, pipeline=2).build("cpu", timeout_s=60)
    tokens = spec["batches"][0]
    out = {"stage": mesh.get_local_rank(PIPELINE)}
    with torch.no_grad():
        out["logits"] = model(spec, mesh)(tokens)
    remat = model(spec, mesh, remat=True)
    logits = remat(tokens)
    out["remat_logits"] = logits.detach()
    logits.square().mean().backward()
    out["remat_grads"] = grads_tree(remat)
    plain = model(spec, mesh)
    plain(tokens).square().mean().backward()
    out["plain_grads"] = grads_tree(plain)

    state, out["adamw_losses"], out["adamw_norms"] = run_steps(
        trainer(spec, mesh, optim.adamw(1e-3)), spec["batches"][:3],
        lambda b: {"tokens": b})
    out["adamw_params"] = full_params(state.params)
    out["local_names"] = [n for n, _ in state.params.named_parameters()]
    state, out["adafactor_losses"], out["adafactor_norms"] = run_steps(
        trainer(spec, mesh, optim.adafactor(1e-3)), spec["batches"][:2],
        lambda b: {"tokens": b})
    out["adafactor_params"] = full_params(state.params)

    # Dropout needs 0 microbatches: the stages then run one after another
    # on the whole batch, with every layer's masks drawn in layer order.
    runs = []
    for m in (mesh, None):
        state, losses, norms = run_steps(
            trainer(spec, m, optim.sgd(0.1), dropout_rate=0.1,
                    pipeline_microbatches=0),
            spec["batches"][:2], lambda b: {"tokens": b})
        runs.append((losses, norms, full_params(state.params)))
    out["dropout"] = runs

    # A save without a mesh (every rank saves in step, rank 0 writes),
    # restored onto the stages and resumed by the pipelined trainer.
    ckdir = workdir / "ckpt_no_mesh"
    plain = trainer(spec, None, optim.adamw(1e-3), CheckpointManager(ckdir))
    state = plain.fit(iter([{"tokens": b} for b in spec["batches"]]), 2,
                      log_every=0)
    out["saved_params"] = full_params(state.params)
    tr = trainer(spec, mesh, optim.adamw(1e-3))
    state = CheckpointManager(ckdir).restore(tr.create_state(seed=5), step=1)
    out["restored_step"] = state.step
    out["restored_params"] = full_params(state.params)
    out["restored_tree_layers"] = param_tree(state.params)[
        "layers"]["attn"]["wq"].shape[0]
    _, m = tr.compile_step()(state, tr.shard_batch(
        {"tokens": spec["batches"][2]}))
    out["resumed_loss"] = float(m["loss"])

    out["moe"] = moe_pipelined(spec, mesh, tokens)
    out["refusals"] = {
        "layers": refused(lambda: Transformer(
            _cfg(spec, n_layers=3), device="cpu", mesh=mesh)),
        "batch": refused(lambda: model(spec, mesh)(tokens[:6])),
        "positions": refused(lambda: model(spec, mesh)(
            tokens, positions=torch.zeros_like(tokens))),
        "segments": refused(lambda: model(spec, mesh)(
            tokens, segment_ids=torch.ones_like(tokens))),
    }
    return out


def moe_pipelined(spec, mesh, tokens):
    """The MoE LM (4 experts, routing groups of a whole microbatch) at
    the stages' M 4, from one seed's weights: its loss and aux, and the
    mean over the microbatches of the loss and aux without a mesh on
    each (JAX's test_pipelined_moe_matches_microbatched_sequential)."""
    moe = dict(moe_experts=4, moe_group_size=tokens.numel() // 4)
    out = []
    for m, over in ((mesh, {}), (None, dict(pipeline_microbatches=0))):
        cfg = _cfg(spec, **moe, **over)
        _, loss_fn = lm_task(cfg, device="cpu", mesh=m)
        net = Transformer(cfg, device="cpu", mesh=m,
                          generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            parts = [loss_fn(net, {}, {"tokens": t}, None)
                     for t in ([tokens] if m is not None
                               else microbatch(tokens, 4))]
        out.append((sum(float(p[0]) for p in parts) / len(parts),
                    sum(float(p[1][0]["moe_aux"]) for p in parts)
                    / len(parts)))
    return out


def pipe8(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    mesh = MeshSpec(data=2, pipeline=2, tensor=2).build("cpu", timeout_s=60)
    rows = dp_rows(mesh)
    out = {}
    tr = trainer(spec, mesh, optim.adamw(1e-3))
    state, out["adamw_losses"], out["adamw_norms"] = run_steps(
        tr, spec["batches"], rows)
    out["adamw_params"] = full_params(state.params)
    out["shard_shapes"] = {n: tuple(_local(p).shape)
                           for n, p in state.params.named_parameters()}

    ckdir = workdir / "ckpt"
    tr = trainer(spec, mesh, optim.adamw(1e-3), CheckpointManager(ckdir))
    state = tr.fit(iter([rows(b) for b in spec["batches"]]), 2, log_every=0)
    out["ckpt_params"] = full_params(state.params)
    tr = trainer(spec, mesh, optim.adamw(1e-3), CheckpointManager(ckdir))
    tr.fit(iter([rows(b) for b in spec["batches"]]), 3, log_every=0)
    out["resumed_loss"] = tr.last_metrics["loss"]

    # adafactor over the stages' layers and the tensor slices.
    state, out["adafactor_losses"], out["adafactor_norms"] = run_steps(
        trainer(spec, mesh, optim.adafactor(1e-3)), spec["batches"], rows)
    out["adafactor_params"] = full_params(state.params)

    # Dropout (0 microbatches) under data x pipeline x tensor against no
    # mesh on the global batch: each rank keeps its rows of every mask.
    runs = []
    for m, feed in ((mesh, rows), (None, lambda b: {"tokens": b})):
        state, losses, norms = run_steps(
            trainer(spec, m, optim.sgd(0.1), dropout_rate=0.1,
                    pipeline_microbatches=0),
            spec["batches"][:2], feed)
        runs.append((losses, norms, full_params(state.params)))
    out["dropout"] = runs
    return out


def pipe4(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    out = {}
    # pipeline=2, sequence=2: the ring inside each stage, M 2.
    mesh = MeshSpec(pipeline=2, sequence=2).build("cpu", timeout_s=60)
    cfg = _cfg(spec, attention="ring", pipeline_microbatches=2)
    _, loss_fn = lm_task(cfg, device="cpu", mesh=mesh)
    ring = model(spec, mesh, attention="ring", pipeline_microbatches=2)
    tokens = spec["ring_tokens"]
    s = tokens.shape[1] // 2
    r = mesh.get_local_rank(SEQUENCE)
    loss, _ = loss_fn(ring, {}, {"tokens": tokens[:, r * s:(r + 1) * s]},
                      None)
    loss.backward()
    # Each sequence rank holds its share of the gradient: the whole one
    # is their sum, as the trainer's reduction forms it.
    for p in ring.parameters():
        dist.all_reduce(p.grad, group=mesh.get_group(SEQUENCE))
    out["ring_loss"] = float(loss)
    out["ring_grads"] = grads_tree(ring)

    # fsdp=2, pipeline=2: FSDP2 over each stage's two ranks.
    mesh = MeshSpec(fsdp=2, pipeline=2).build("cpu", timeout_s=60)
    calls = {"n": 0}
    for name in ("reduce_scatter_single", "reduce_scatter_tensor"):
        original = getattr(dist, name, None)
        if original is not None:
            def counted(*args, _original=original, **kw):
                calls["n"] += 1
                return _original(*args, **kw)
            setattr(dist, name, counted)
    tr = trainer(spec, mesh, optim.adamw(1e-3))
    state = tr.create_state(seed=0)
    step = tr.compile_step()
    rows = dp_rows(mesh)
    losses, norms, scatters = [], [], []
    for batch in spec["batches"][:3]:
        before = calls["n"]
        state, m = step(state, tr.shard_batch(rows(batch)))
        scatters.append(calls["n"] - before)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out.update(fsdp_losses=losses, fsdp_norms=norms,
               fsdp_params=full_params(state.params),
               reduce_scatters=scatters,
               fsdp_blocks=len(state.params.layers))
    return out


def train_lm(spec, workdir):
    from kubeflow_tpu_torch.tools import train_lm as tool

    trainer = tool.run(spec["train_lm_argv"])
    return {"history": trainer.metrics.history,
            "world": dist.get_world_size()}


def main(scenario, workdir):
    workdir = Path(workdir)
    spec = torch.load(workdir / "inputs.pt", weights_only=True)
    out = {"prim": prim, "pipe2": pipe2, "pipe8": pipe8, "pipe4": pipe4,
           "train_lm": train_lm}[scenario](spec, workdir)
    rank = dist.get_rank() if dist.is_initialized() else 0
    torch.save(out, workdir / f"{scenario}-rank{rank}.pt")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
