"""One rank of the mesh-training jobs of tests/test_torch_parallel_train.py.

JAX-free: the test writes the JAX model's converted weights and the
batches to ``WORKDIR/inputs.pt``, starts the ranks with
``kubeflow_tpu_torch.testing.ranks.run_ranks`` (the ``KFT_*`` variables
name each), and reads what each rank writes to ``WORKDIR/rank<r>.pt``:

    python tests/torch_mesh_train_worker.py mesh8 WORKDIR    # 8 ranks
    python tests/torch_mesh_train_worker.py world1 WORKDIR   # 1 rank
    python tests/torch_mesh_train_worker.py train_lm WORKDIR  # 2 ranks
    python tests/torch_mesh_train_worker.py tensor8 WORKDIR   # 8 ranks
    python tests/torch_mesh_train_worker.py tensor2 WORKDIR   # 2 ranks
    python tests/torch_mesh_train_worker.py dropout4 WORKDIR  # 4 ranks
    python tests/torch_mesh_train_worker.py train_lm_tensor WORKDIR  # 2

``mesh8`` trains the LM at data=2, fsdp=2, sequence=2 with ring attention
(adamw, sgd, remat, identical rows on every data shard, checkpoints and
their resume, adafactor steps); ``world1`` holds a one-rank mesh
trainer to the trainer without a mesh; ``train_lm`` is
``tools/train_lm.py`` through the bootstrap at fsdp=2.  ``tensor8``
trains at data=2, fsdp=2, tensor=2 with flash (adamw, a checkpoint,
adafactor steps, and adafactor at a width whose matrices factor against
no mesh, with a checkpoint); ``tensor2`` at tensor=2 alone with an untied
unembed, the chunked CE and dropout 0.1, against the trainer without a
mesh on the global batch (with and without remat), and restores that
trainer's checkpoint, then runs the fused gang of
tests/torch_fused_gang.py over its tensor slices, with member
checkpoints; ``dropout4`` at data=2, sequence=2 with the ring
and dropout 0.1 against the trainer without a mesh and the fused gang
over that mesh, then runs the
fused trainer (runtime/hfta.py) at data=2, fsdp=2: a width-4 gang over
3 adamw steps with m1 stopping at 2 (each step's metrics and the stacked
state), one step with dropout 0.1 and one MoE step whose routing groups
span two ranks, each beside the fused trainer without a mesh on the
global batch, and a supervised run with member checkpoints that a fused
run resumes.  Those two also write each rank's dropout mask for one
draw.  ``train_lm_tensor`` is ``tools/train_lm.py`` at ``--mesh
model=2``.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    load_params,
    whole_parameters,
)
from kubeflow_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    lm_task,
    rank_dropout_mask,
)
from kubeflow_tpu_torch.parallel.mesh import (  # noqa: E402
    DATA,
    FSDP,
    SEQUENCE,
    TENSOR,
    MeshSpec,
    axis_sizes,
)
from kubeflow_tpu_torch.runtime import bootstrap, optim  # noqa: E402
from kubeflow_tpu_torch.runtime.checkpoint import (  # noqa: E402
    CheckpointManager,
)
from kubeflow_tpu_torch.runtime.hfta import (  # noqa: E402
    FusedTrainer,
    MemberSpec,
)
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger  # noqa: E402
from kubeflow_tpu_torch.runtime.prom import REGISTRY  # noqa: E402
from kubeflow_tpu_torch.runtime.supervisor import (  # noqa: E402
    TrainSupervisor,
)
from kubeflow_tpu_torch.runtime.train import Trainer  # noqa: E402
from torch_fused_gang import gang, stacked, strict_map  # noqa: E402


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def trainer(spec, mesh, tx, checkpoints=None, **overrides):
    """The port's trainer at ``spec``'s config with ``overrides``, from
    the JAX initial weights (tied) or, untied, from the port's own draw
    of the create_state seed (the same whole weights on every rank)."""
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(spec["cfg"], **overrides))
    base_init, loss_fn = lm_task(cfg, device="cpu", mesh=mesh)

    def init_fn(gen):
        model, mutable = base_init(gen)
        if not cfg.tied_embeddings:
            return model, mutable
        return load_params(model, _clone(spec["params"])), mutable

    return Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=tx, device="cpu",
                   mesh=mesh, checkpoints=checkpoints, checkpoint_every=1,
                   metrics=MetricsLogger(stream=open(os.devnull, "w")))


def full_params(model):
    """Every parameter gathered whole (a collective on every rank)."""
    return {n: p.clone() for n, p in whole_parameters(model).items()}


def dp_rows(mesh):
    """A batch -> this rank's rows (its data x fsdp shard)."""
    sizes = axis_sizes(mesh)
    dp = mesh.get_local_rank(DATA) * sizes[FSDP] + mesh.get_local_rank(FSDP)
    count = sizes[DATA] * sizes[FSDP]

    def rows(batch):
        b = batch.shape[0] // count
        return {"tokens": batch[dp * b:(dp + 1) * b]}

    return rows


def coords(mesh):
    return {a: mesh.get_local_rank(a) for a in (DATA, FSDP, SEQUENCE, TENSOR)}


def one_mask(mesh, shape):
    """This rank's keep mask of one draw from a generator seeded 7, for
    local activations of ``shape``."""
    return rank_dropout_mask(shape, 0.1, torch.Generator().manual_seed(7),
                             "cpu", mesh)


def against_no_mesh(spec, mesh, batches, rows, overrides, variants,
                    tx=lambda: optim.adamw(1e-3)):
    """Losses, grad_norms and whole parameters after ``batches`` of the
    mesh trainer and of the trainer without a mesh on the global
    batches, for each of ``variants``: name -> (the mesh trainer's extra
    config, the other's)."""
    out = {}
    for name, extras in variants.items():
        runs = []
        for m, feed, extra in ((mesh, rows, extras[0]),
                               (None, lambda b: {"tokens": b}, extras[1])):
            state, losses, norms = run_steps(
                trainer(spec, m, tx(), **dict(overrides, **extra)),
                batches, feed)
            runs.append((losses, norms, full_params(state.params)))
        out[name] = runs
    return out


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

    # adafactor over FSDP2's shards (the embed dim of each weight).
    state, out["adafactor_losses"], out["adafactor_norms"] = run_steps(
        trainer(spec, mesh, optim.adafactor(1e-3)), spec["batches"], rows)
    out["adafactor_params"] = full_params(state.params)
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


def tensor8(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    mesh = MeshSpec(data=2, fsdp=2, tensor=2).build("cpu", timeout_s=60)
    rows = dp_rows(mesh)
    out = {"coords": coords(mesh)}
    tr = trainer(spec, mesh, optim.adamw(1e-3), attention="flash")
    state = tr.create_state(seed=0)
    out["shard_shapes"] = {n: tuple(_local(p).shape)
                           for n, p in state.params.named_parameters()}
    state, out["adamw_losses"], out["adamw_norms"] = run_steps(
        tr, spec["batches"], rows)
    out["adamw_params"] = full_params(state.params)

    ckdir = workdir / "ckpt_tensor"
    tr = trainer(spec, mesh, optim.adamw(1e-3), CheckpointManager(ckdir),
                 attention="flash")
    state = tr.fit(iter([rows(b) for b in spec["batches"]]), 2, log_every=0)
    out["ckpt_params"] = full_params(state.params)

    # adafactor over the tensor slices and FSDP2's shards.
    state, out["adafactor_losses"], out["adafactor_norms"] = run_steps(
        trainer(spec, mesh, optim.adafactor(1e-3), attention="flash"),
        spec["batches"], rows)
    out["adafactor_params"] = full_params(state.params)

    # A width whose matrices factor: against the trainer without a mesh
    # on the global batch, and a checkpoint of its statistics.
    batches = spec["batches"][:3]
    out.update(against_no_mesh(spec, mesh, batches, rows, WIDE,
                               {"wide": ({}, {})},
                               tx=lambda: optim.adafactor(1e-3)))
    tr = trainer(spec, mesh, optim.adafactor(1e-3),
                 CheckpointManager(workdir / "ckpt_adafactor"), **WIDE)
    state = tr.fit(iter([rows(b) for b in batches]), 2, log_every=0)
    out["wide_stat_shapes"] = {
        leaf: tuple(v.shape) for leaf, v in state.opt_state.v_row.items()}
    return out


# tensor8's adafactor width: every matrix of the embed dim and the vocab
# or mlp dim factors (two dims of at least 128).
WIDE = dict(attention="flash", vocab_size=256, d_model=128, d_ff=256,
            tied_embeddings=False)


TENSOR2 = dict(attention="flash", tied_embeddings=False, ce_chunk=8,
               dropout_rate=0.1)


def tensor2(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    mesh = MeshSpec(data=1, tensor=2).build("cpu", timeout_s=60)
    batches = [b[:4] for b in spec["batches"][:3]]
    out = against_no_mesh(spec, mesh, batches, lambda b: {"tokens": b},
                          TENSOR2, {"plain": ({}, {}),
                                    "remat": ({"remat": True},
                                              {"remat": True})})
    out["coords"] = coords(mesh)
    out["mask"] = one_mask(mesh, (4, 32, 32))

    # A save without a mesh (every rank saves in step, rank 0 writes),
    # resumed by the tensor-parallel trainer on its slices.
    ckdir = workdir / "ckpt_no_mesh"
    plain = trainer(spec, None, optim.adamw(1e-3), CheckpointManager(ckdir),
                    **TENSOR2)
    state = plain.fit(iter([{"tokens": b} for b in batches]), 2,
                      log_every=0)
    out["saved_params"] = full_params(state.params)
    tr = trainer(spec, mesh, optim.adamw(1e-3), **TENSOR2)
    state = CheckpointManager(ckdir).restore(tr.create_state(seed=5),
                                             step=1)
    out["restored_step"] = state.step
    out["restored_params"] = full_params(state.params)
    out["restored_local"] = {n: _local(p).detach().clone()
                             for n, p in state.params.named_parameters()}
    _, m = tr.compile_step()(state, tr.shard_batch({"tokens": batches[2]}))
    out["resumed_loss"] = float(m["loss"])
    # The fused gang over the tensor slices, with member checkpoints.
    out["gang"] = gang(TransformerConfig(dtype=torch.float32,
                                         **spec["gang_cfg"]["tensor2"]),
                       mesh, spec["batches"], workdir / "ckpt_gang_tensor")
    return out


def dropout4(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    mesh = MeshSpec(data=2, sequence=2).build("cpu", timeout_s=60)
    batches = [b[:4] for b in spec["batches"][:2]]
    # sgd: the parameters move by lr x the gradient, which the ring and
    # flash round alike to float32's last bits; adam's normalized step
    # would magnify a gradient entry near its eps.
    out = against_no_mesh(
        spec, mesh, batches, dp_rows(mesh), dict(dropout_rate=0.1),
        {"ring": (dict(attention="ring"), dict(attention="flash"))},
        tx=lambda: optim.sgd(spec["sgd_lr"]))
    out["coords"] = coords(mesh)
    out["mask"] = one_mask(mesh, (2, 16, 32))
    # The fused gang over the sequence shards (the ring).
    out["gang"] = gang(TransformerConfig(dtype=torch.float32,
                                         **spec["gang_cfg"]["dropout4"]),
                       mesh, spec["batches"])
    out["fused"] = fused(spec, workdir)
    return out


def fused_trainer(spec, mesh, members, ckpt=None, **overrides):
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(spec["fused_cfg"], **overrides))
    init_fn, loss_fn = lm_task(cfg, device="cpu", mesh=mesh)
    return FusedTrainer(init_fn=init_fn, loss_fn=loss_fn, members=members,
                        mesh=mesh, device="cpu", checkpoint_dir=ckpt,
                        checkpoint_every=1,
                        metrics=MetricsLogger(stream=open(os.devnull, "w")))


def fused_steps(ft, batches, stops):
    """The fused step over ``batches`` (every rank given the global
    batch) from the members' own initial states: each step's per-member
    loss and grad_norm, and the stacked state after each."""
    state = ft._stack_members([ft.create_member_state(m)
                               for m in ft.members])
    step, active = ft.compile_step(), torch.ones(len(ft.members),
                                                 dtype=torch.bool)
    stops = torch.tensor(stops)
    metrics, states = [], []
    for batch in batches:
        state, active, m = step(state, active, stops,
                                ft.shard_batch({"tokens": batch}))
        metrics.append({k: m[k].clone() for k in ("loss", "grad_norm")})
        states.append(stacked(state))
    return metrics, states


def fused(spec, workdir):
    """The fused trainer at data=2 x fsdp=2 (module docstring), with
    torch.func.vmap's fallback warning an error: no member loop may hide
    in the map, and no collective may run on a member's view."""
    strict_map()
    mesh = MeshSpec(data=2, fsdp=2).build("cpu", timeout_s=60)
    members = [MemberSpec(**m) for m in spec["fused_members"]]
    stops = [m.stop_step or spec["fused_steps"] for m in members]
    batches = spec["batches"][:spec["fused_steps"]]
    counter = REGISTRY.counter("kft_train_member_steps_total")
    before = counter.value(member="m0")
    out = {}
    out["metrics"], states = fused_steps(
        fused_trainer(spec, mesh, members), batches, stops)
    out["stack"] = states[-1]
    out["m1_at_stop"] = {k: v[1] for k, v in states[1].items()}
    out["m1_at_end"] = {k: v[1] for k, v in states[-1].items()}
    # Dropout and MoE (routing groups of 128 of the 256 global tokens:
    # each spans two ranks' 64), one step each, with the fused trainer
    # without a mesh on the global batch.
    for name, over in spec["fused_variants"].items():
        runs = []
        for m in (mesh, None):
            metrics, states = fused_steps(
                fused_trainer(spec, m, members[:2], **over), batches[:1],
                stops[:2])
            runs.append((metrics[0], states[0]))
        out[name] = runs
    # Member checkpoints under the mesh (TrainSupervisor wraps the meshed
    # trainer), then a fused run that resumes them to the end.
    ckpt = str(workdir / "ckpt_fused")
    ft = fused_trainer(spec, mesh, members, ckpt)
    sup = TrainSupervisor(ft, max_restarts=0)
    state = sup.run(lambda: iter({"tokens": b} for b in batches), 2,
                    log_every=1, examples_per_step=8)
    out["saved_m0"] = {k: v[0].detach().clone()
                       for k, v in state.params.items()}
    out["history"] = ft.metrics.history
    resumed = fused_trainer(spec, mesh, members, ckpt)
    state = resumed.fit(iter({"tokens": b} for b in batches),
                        spec["fused_steps"], log_every=1)
    out["resumed"] = stacked(state)
    out["resumed_active"] = resumed.last_active
    out["m0_counted"] = counter.value(member="m0") - before
    out["active_gauge"] = REGISTRY.gauge("kft_train_members_active").value()
    return out


def train_lm(spec, workdir, argv="train_lm_argv"):
    from kubeflow_tpu_torch.tools import train_lm as tool

    trainer = tool.run(spec[argv])
    return {"history": trainer.metrics.history,
            "last": trainer.last_metrics,
            "world": dist.get_world_size()}


def main(scenario, workdir):
    workdir = Path(workdir)
    spec = torch.load(workdir / "inputs.pt", weights_only=True)
    out = {"mesh8": mesh8, "world1": world1, "train_lm": train_lm,
           "tensor8": tensor8, "tensor2": tensor2, "dropout4": dropout4,
           "train_lm_tensor": lambda spec, workdir: train_lm(
               spec, workdir, "train_lm_tensor_argv")}[
        scenario](spec, workdir)
    rank = dist.get_rank() if dist.is_initialized() else 0
    torch.save(out, workdir / f"{scenario}-rank{rank}.pt")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
