"""The mixture-of-experts LM over a mesh (models/moe.py under
models/transformer.py's mesh placement, the expert axis) against the JAX
package's on the same meshes.

The JAX side runs here on the 8 fake CPU devices of tests/conftest.py,
its trainers in threads; the port's ranks are JAX-free subprocesses
(tests/torch_moe_mesh_worker.py) over gloo, started together with it and
joined with a timeout.  The model is tests/test_moe.py's ``CFG`` (2
layers, vocab 64, d_model 32, 4 heads, d_ff 64, 4 experts, top-2) in
float32; the port attends through ``attention="flash"`` (its plain
version on the CPU), JAX through its dot attention.  Most jobs set
``moe_group_size`` to tile each rank's share; the spanning cases route in
groups that span ranks, as JAX fits them to the global tokens:

  - ``moe8`` (8 ranks): test_moe.py's ``test_train_on_expert_parallel_
    mesh`` layout, data=2, expert=2, tensor=2, groups of 32 (a rank holds
    4 rows of 16): loss, grad_norm and ``moe_aux`` over 5 adamw steps
    within 1e-4 (relative) of the JAX ``Trainer``, the parameters after
    them within atol=rtol=1e-4; ``wi`` and ``wo`` hold JAX's shard shapes
    (half the experts, half the mlp dim) and the router stays whole; a
    gathered checkpoint that JAX's ``verify_step`` accepts and that a
    trainer without a mesh restores exactly; 5 adafactor steps over the
    expert x tensor slices against the JAX ``Trainer`` with
    ``optax.adafactor`` (loss, grad_norm, ``moe_aux`` within 1e-4
    relative, the parameters within atol=rtol=1e-4);
  - ``moe_batch4`` (4 ranks): data=2, sequence=2 with the ring, groups
    of 16 (one rank's slice of a row), against the trainer without a
    mesh on the global batch (loss, grad_norm and ``moe_aux`` over 3
    adamw steps within 1e-5, the parameters within atol=rtol=1e-5) and
    against the JAX ``Trainer`` on that mesh (within 1e-4 relative, the
    parameters within atol=rtol=1e-4); the mean of the ranks' auxes over
    their own tokens differs from the global aux, which the mesh gives;
    groups of 32, each a row of two ranks' slices, hold one loss, its
    ``moe_aux`` and every gradient to JAX's on the global batch within
    atol=rtol=1e-4 (JAX on one device, its groups the same rows), at the
    default capacity and at a capacity factor of 0.5, where the second
    rank of each group drops choices; then fsdp=2,
    expert=2 with the gather dispatch (FSDP2 shards each rank's experts)
    over 2 adamw steps, against no mesh within 1e-5 and against the JAX
    ``Trainer`` on that mesh within 1e-4; the fused gang
    (tests/torch_fused_gang.py) over that mesh, each rank's E/N experts
    stacked, against the JAX ``FusedTrainer`` on fsdp=2 x expert=2
    (per-member loss and grad_norm every step and each member's
    parameters within 1e-4, the ranks' losses equal, m1 bit-equal from
    its stop);
  - ``moe_pipe8`` (8 ranks): test_transformer.py's ``test_pipelined_moe_
    matches_microbatched_sequential`` layout, data=2, pipeline=2,
    expert=2, M 4 on 8 x 16 tokens: at JAX's own groups of (B/M)·S = 32
    tokens, a whole microbatch, which spans the two data ranks, one loss,
    ``moe_aux`` and every gradient against JAX's pipelined ``lm_task``
    within atol=rtol=1e-4; then in groups of 16, a data rank's share of
    the microbatch, against JAX's pipelined ``lm_task`` at the same
    groups, each rank fed its contiguous rows of the global
    batch (the loss exchanges them into JAX's microbatches, global rows
    [m B/M, (m+1) B/M)): loss and every gradient within atol 2e-4, rtol
    1e-3 (JAX's own bounds there); the port's ``Trainer`` on that mesh,
    fed the same way, over 3 adamw steps against the JAX ``Trainer`` on
    the same global batches, within those bounds; the rows each rank
    holds after the exchange, and the aux it gives, against the aux of
    the ranks' own contiguous microbatches (another number); then
    test_transformer.py's
    ``test_pp_ring_moe_all_compose`` layout, pipeline=2, sequence=2,
    expert=2 with the ring (2 experts, M 2, in float32 where JAX's test
    runs bf16): one step's loss and ``moe_aux`` within 1e-4 of JAX's;
  - ``train_lm`` (2 ranks): ``tools/train_lm.py --mesh expert=2
    --moe-experts 4``: both ranks end at the loss of the entry point
    without a mesh within 2e-4 (bf16), every step within 1e-3.

A single-process sibling holds the algebra the expert and tensor axes
rest on: the partial combines of ``MoEMLP`` restricted to each half of
the experts (or of the mlp dim) sum to the whole layer's output and
gradients within 1e-6, the input's gradient through the bfloat16 einsum
dispatch within that dispatch's rounding.
"""

import concurrent.futures
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import lm_task as jax_lm_task
from kubeflow_tpu.parallel import DEFAULT_RULES as JAX_RULES
from kubeflow_tpu.parallel import MeshSpec as JaxMeshSpec
from kubeflow_tpu.runtime.checkpoint import verify_step
from kubeflow_tpu.runtime.metrics import MetricsLogger as JaxMetricsLogger
from kubeflow_tpu.runtime.train import Trainer as JaxTrainer
from kubeflow_tpu_torch.models import moe
from kubeflow_tpu_torch.models.convert import params_from_jax, params_to_jax
from kubeflow_tpu_torch.models.transformer import TransformerConfig, lm_task
from kubeflow_tpu_torch.parallel import tensor as tp
from kubeflow_tpu_torch.runtime import optim
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks
from kubeflow_tpu_torch.tools import train_lm
from test_torch_adafactor import sharded_against_optax
from torch_fused_gang import GANG, GANG_STEPS
from torch_fused_jax import check_members, check_step, jax_gang

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_moe_mesh_worker.py")
# tests/test_moe.py's TestMoETransformer.CFG.
MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
           d_ff=64, head_dim=8, max_seq_len=32, moe_experts=4)
BATCH, SEQ, STEPS = 8, 16, 5
# moe8: a rank's 4 rows of 16 in two groups.  moe_batch4: one rank's 16
# positions of a row.  moe_pipe8: a data rank's row of a microbatch.
MOE8_GROUP, RING_GROUP, RING_SEQ, RING_STEPS = 32, 16, 32, 3
# moe_batch4's groups that span ranks (2 x RING_GROUP: a whole row) at
# the default capacity and at one where choices drop.
SPANNING = {"default": {}, "drop": dict(moe_capacity_factor=0.5)}
PIPE = dict(pipeline_microbatches=4, moe_group_size=SEQ)
PIPE_STEPS = 3
PIPE_TOL = dict(atol=2e-4, rtol=1e-3)
# test_pp_ring_moe_all_compose's model and batch, in float32.
PPS = dict(MOE, moe_experts=2, attention="ring", pipeline_microbatches=2)
# The fused gang over fsdp=2 x expert=2 (moe_batch4's second mesh;
# tests/torch_fused_gang.py), at the routing group the global batch fits.
GANG_CFG, GANG_MESH = dict(MOE, attention="flash"), dict(fsdp=2, expert=2)
JOBS = {"moe8": 8, "moe_batch4": 4, "moe_pipe8": 8, "train_lm": 2}
JOB_TIMEOUT_S = 150
TOL = dict(atol=1e-4, rtol=1e-4)
NO_MESH_TOL = dict(atol=1e-5, rtol=1e-5)
TRAIN_LM_ARGV = [
    "--device", "cpu", "--d-model", "32", "--n-layers", "2", "--n-heads",
    "4", "--n-kv-heads", "2", "--d-ff", "64", "--head-dim", "8",
    "--vocab-size", "64", "--seq-len", "16", "--batch-size-per-device",
    "2", "--moe-experts", "4", "--steps", "3", "--log-every", "1",
    "--max-restarts", "0"]


def _batches(seq=SEQ, steps=STEPS):
    rng = np.random.RandomState(11)
    return [rng.randint(0, MOE["vocab_size"], size=(BATCH, seq))
            .astype(np.int32) for _ in range(steps)]


def _pipe_tokens():
    return np.random.RandomState(3).randint(
        0, MOE["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def _pps_tokens():
    return (np.arange(4 * 32, dtype=np.int32).reshape(4, 32)
            % MOE["vocab_size"])


# -- the JAX side -------------------------------------------------------------


def _jax_mesh(**spec):
    n = int(np.prod(list(spec.values())))
    return JaxMeshSpec(**spec).build(jax.devices()[:n])


def _jax_cfg(**over):
    return JaxConfig(dtype=jnp.float32, **dict(MOE, **over))


def _quiet():
    return JaxMetricsLogger(stream=open("/dev/null", "w"))


def _jax_moe8_trainer(tx=None):
    """test_moe.py's expert-parallel trainer (its model built without a
    mesh, as there) at the job's routing groups, with adamw or ``tx``."""
    init_fn, loss_fn = jax_lm_task(_jax_cfg(moe_group_size=MOE8_GROUP))
    return JaxTrainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=tx or optax.adamw(1e-3), metrics=_quiet(),
                      mesh=_jax_mesh(data=2, expert=2, tensor=2))


def _jax_pps_trainer():
    mesh = _jax_mesh(pipeline=2, sequence=2, expert=2)
    init_fn, loss_fn = jax_lm_task(_jax_cfg(**PPS), mesh=mesh)
    return JaxTrainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optax.adam(1e-3), mesh=mesh, metrics=_quiet())


def _jax_moe8(tr, state):
    moe_params = state.params["layers"]["moe"]
    shapes = {k: tuple(v.sharding.shard_shape(v.shape))[1:]
              for k, v in moe_params.items()}
    step = tr.compile_step()
    metrics = {"loss": [], "grad_norm": [], "moe_aux": []}
    for b in _batches():
        state, m = step(state, tr.shard_batch({"tokens": b}))
        for key, values in metrics.items():
            values.append(float(m[key]))
    return metrics, jax.tree.map(np.asarray, state.params), shapes


def _jax_pipe8(tree, over=PIPE):
    """JAX's pipelined loss, moe_aux and gradients at data=2, pipeline=2,
    expert=2 on the job's tokens at ``over``."""
    return _jax_loss_grads(tree, _pipe_tokens(), over, data=2, pipeline=2,
                           expert=2)


def _jax_loss_grads(tree, tokens, over, **mesh_spec):
    """JAX's loss, moe_aux and gradients of ``lm_task`` at ``over`` on
    ``tokens``, under the mesh ``mesh_spec`` (one device without one)."""
    mesh = _jax_mesh(**mesh_spec) if mesh_spec else None
    _, loss_fn = jax_lm_task(_jax_cfg(**over), mesh=mesh)
    toks = jnp.asarray(tokens)

    def loss(p):
        value, (metrics, _) = loss_fn(p, {}, {"tokens": toks},
                                      jax.random.key(0))
        return value, metrics["moe_aux"]

    grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    if mesh is None:
        (value, aux), grads = grad(tree)
    else:
        with mesh, nn.logical_axis_rules(list(JAX_RULES)):
            (value, aux), grads = grad(tree)
    return float(value), float(aux), jax.tree.map(np.asarray, grads)


def _jax_steps(tree, batches, over, **mesh_spec):
    """Adamw steps of the JAX ``Trainer`` on ``mesh_spec`` at ``over``
    from the weights ``tree``: the loss, grad_norm and moe_aux of each
    step and the parameters after them."""
    mesh = _jax_mesh(**mesh_spec)
    init_fn, loss_fn = jax_lm_task(_jax_cfg(**over), mesh=mesh)
    tr = JaxTrainer(init_fn=init_fn, loss_fn=loss_fn, tx=optax.adamw(1e-3),
                    mesh=mesh, metrics=_quiet())
    state = tr.create_state(seed=0)
    state = state.replace(params=jax.device_put(
        tree, jax.tree.map(lambda x: x.sharding, state.params)))
    step = tr.compile_step()
    metrics = {"loss": [], "grad_norm": [], "moe_aux": []}
    for b in batches:
        state, m = step(state, tr.shard_batch({"tokens": b}))
        for key, values in metrics.items():
            values.append(float(m[key]))
    return metrics, jax.tree.map(np.asarray, state.params)


def _jax_pps(tr, state):
    state, m = tr.compile_step()(state, tr.shard_batch(
        {"tokens": _pps_tokens()}))
    return float(m["loss"]), float(m["moe_aux"])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The port's jobs run while the JAX side computes here."""
    work = tmp_path_factory.mktemp("moe_mesh")
    moe8_tr, pps_tr = _jax_moe8_trainer(), _jax_pps_trainer()
    ada_tr = _jax_moe8_trainer(optax.adafactor(1e-3))
    moe8_state, pps_state = (moe8_tr.create_state(seed=0),
                             pps_tr.create_state(seed=0))
    tree = jax.tree.map(np.asarray, moe8_state.params)
    pps_tree = jax.tree.map(np.asarray, pps_state.params)
    torch.save({"cfg": dict(MOE, attention="flash",
                            moe_group_size=MOE8_GROUP),
                "params": params_from_jax(tree),
                "batches": [torch.from_numpy(b) for b in _batches()],
                "long_batches": [torch.from_numpy(b) for b in
                                 _batches(RING_SEQ, RING_STEPS)],
                "ring_group": RING_GROUP,
                "spanning": SPANNING,
                "pipe": PIPE,
                "pipe_steps": PIPE_STEPS,
                "pipe_tokens": torch.from_numpy(_pipe_tokens()),
                "pps_cfg": PPS,
                "pps_params": params_from_jax(pps_tree),
                "pps_tokens": torch.from_numpy(_pps_tokens()),
                "gang_cfg": GANG_CFG,
                "train_lm_argv": TRAIN_LM_ARGV + ["--mesh", "expert=2"]},
               work / "inputs.pt")
    with concurrent.futures.ThreadPoolExecutor(len(JOBS) + 9) as pool:
        futures = {name: pool.submit(run_ranks, [WORKER, name, str(work)], n,
                                     timeout_s=JOB_TIMEOUT_S, cwd=str(REPO),
                                     threads=1)
                   for name, n in JOBS.items()}
        jax_futures = {
            "moe8": pool.submit(_jax_moe8, moe8_tr, moe8_state),
            "moe8_adafactor": pool.submit(_jax_moe8, ada_tr,
                                          ada_tr.create_state(seed=0)),
            "pipe8": pool.submit(_jax_pipe8, tree),
            "pipe8_spanning": pool.submit(
                _jax_pipe8, tree,
                dict(PIPE, moe_group_size=2 * PIPE["moe_group_size"])),
            **{f"batch4_spanning_{name}": pool.submit(
                _jax_loss_grads, tree, _batches(RING_SEQ, RING_STEPS)[0],
                dict(over, moe_group_size=2 * RING_GROUP))
               for name, over in SPANNING.items()},
            "pps": pool.submit(_jax_pps, pps_tr, pps_state),
            "batch4": pool.submit(
                _jax_steps, tree, _batches(RING_SEQ, RING_STEPS),
                dict(attention="ring", moe_group_size=RING_GROUP),
                data=2, sequence=2),
            "fsdp": pool.submit(
                _jax_steps, tree, _batches()[:2],
                dict(moe_impl="gather", moe_group_size=MOE8_GROUP),
                fsdp=2, expert=2),
            "pipe_trainer": pool.submit(
                _jax_steps, tree, _batches()[:PIPE_STEPS], PIPE,
                data=2, pipeline=2, expert=2),
            "gang": pool.submit(jax_gang, MOE, GANG,
                                _batches()[:GANG_STEPS], **GANG_MESH),
        }
        jax_out = {name: f.result() for name, f in jax_futures.items()}
        jax_out["init"] = tree
        for future in futures.values():
            check_ranks(future.result())
    jobs = {name: [torch.load(work / f"{name}-rank{r}.pt",
                              weights_only=True) for r in range(n)]
            for name, n in JOBS.items()}
    jobs["dir"] = work
    return jax_out, jobs


@pytest.fixture(scope="module")
def jax_side(both):
    return both[0]


@pytest.fixture(scope="module")
def jobs(both):
    return both[1]


def _port_cfg(**over):
    return TransformerConfig(dtype=torch.float32, **dict(MOE, **over))


def _tree_of(params):
    """A port name -> tensor dict of the whole model as the JAX tree."""
    init_fn, _ = lm_task(_port_cfg(), device="cpu")
    model, _ = init_fn(torch.Generator().manual_seed(0))
    model.load_state_dict(params)
    return params_to_jax(model)


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_allclose(np.asarray(leaf), flat_want[path],
                                   err_msg=jax.tree_util.keystr(path), **tol)


# -- one process: the partial combines -----------------------------------------


def _halves(layer, split):
    """Two copies of ``layer`` that each hold half of its experts
    (``split="expert"``) or of its mlp dim (``"mlp"``) and share its
    router, as the ranks of an expert or tensor group do."""
    parts = []
    for half in range(2):
        part = moe.MoEMLP(layer.wi.shape[2], layer.wi.shape[3],
                          layer.num_experts, top_k=layer.top_k,
                          capacity_factor=layer.capacity_factor,
                          group_size=layer.group_size, dtype=layer.dtype,
                          impl=layer.impl, device="cpu")
        part.router = layer.router
        if split == "expert":
            e = layer.num_experts // 2
            wi, wo = layer.wi[half * e:(half + 1) * e], \
                layer.wo[half * e:(half + 1) * e]
            part.first_expert = half * e
        else:
            f = layer.wi.shape[3] // 2
            wi, wo = layer.wi[..., half * f:(half + 1) * f], \
                layer.wo[:, half * f:(half + 1) * f]
        part.wi = torch.nn.Parameter(wi.detach().clone())
        part.wo = torch.nn.Parameter(wo.detach().clone())
        parts.append(part)
    return parts


@pytest.mark.parametrize("split", ["expert", "mlp"])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_partial_combines_sum_to_the_whole_layer(impl, split):
    """What the ranks of an expert or tensor group compute, in one
    process: each half's partial output (the combine of its own experts'
    slots, or of its slice of the mlp dim) sums to the whole layer's, and
    the summed gradients of the input, the shared router and the halves'
    weights are the whole layer's, within 1e-6 (the input's through the
    bfloat16 einsum dispatch within its rounding), at a capacity that
    drops choices."""
    torch.manual_seed(0)
    layer = moe.MoEMLP(16, 32, 4, top_k=2, capacity_factor=0.75,
                       group_size=16, dtype=torch.float32, impl=impl,
                       device="cpu", generator=torch.Generator()
                       .manual_seed(0))
    x = torch.randn(2, 24, 16)
    target = torch.randn(2, 24, 16)

    def loss(out, aux):
        return ((out - target) ** 2).sum() + 0.01 * aux

    xw = x.clone().requires_grad_(True)
    out, aux = layer(xw)
    loss(out, aux).backward()
    parts = _halves(layer, split)
    layer.router.grad = None
    xp = x.clone().requires_grad_(True)
    results = [part(xp) for part in parts]
    summed = results[0][0] + results[1][0]
    # The aux is whole in each half (every rank routes all its tokens):
    # it enters the loss once.
    loss(summed, results[0][1]).backward()
    tol = dict(atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(summed, out, **tol)
    torch.testing.assert_close(results[1][1], aux, atol=0, rtol=0)
    if impl == "einsum":
        # The einsum dispatch runs in bfloat16: one device rounds each
        # token's gradient through it once, the halves once each before
        # this process sums them in float32 (the ranks sum them in
        # bfloat16, which rounds once, as the jobs below hold exactly).
        x_tol = dict(atol=2 ** -8 * float(xw.grad.abs().max()), rtol=0)
    else:
        x_tol = tol
    torch.testing.assert_close(xp.grad, xw.grad, **x_tol)
    torch.testing.assert_close(parts[0].router.grad, layer.router.grad,
                               **tol)
    dim_wi, dim_wo = (0, 0) if split == "expert" else (3, 1)
    for name, dim in (("wi", dim_wi), ("wo", dim_wo)):
        joined = torch.cat([getattr(p, name).grad for p in parts], dim=dim)
        torch.testing.assert_close(joined, getattr(layer, name).grad, **tol)


def test_adafactor_over_expert_slices_matches_optax(monkeypatch):
    """adafactor's block RMS spans a leaf's experts, and its factored
    statistics the mlp dim of ``wo`` [E, mlp, embed]: each rank of
    expert=2 holding 2 of the 4 experts of a factored MoE layer ends 3
    updates at its experts' share of optax's parameters and statistics
    on the whole leaves (the ranks as threads,
    tests/test_torch_adafactor.py)."""
    def split(coords, leaf):
        if leaf == "layers.moe.router":
            return None, None
        index, group = coords["expert"]
        return tp.TensorShard(0, index, 2, group, "expert"), None

    results = sharded_against_optax(
        monkeypatch, {"layers.moe.wi": (2, 4, 2, 130, 256),
                      "layers.moe.wo": (2, 4, 256, 130),
                      "layers.moe.router": (2, 130, 4)},
        {"expert": 2}, split)
    for local, _, state in results.values():
        assert tuple(local["layers.0.moe.wi"].shape) == (2, 2, 130, 256)
        assert tp.shard_of(state.v_row["layers.moe.wi"]).axis == "expert"


def test_tensor_shard_chains_expert_and_mlp_splits():
    """An MoE ``wi`` under expert x tensor: the expert slice, then the
    mlp slice; its whole shape and the axes it is split over."""
    whole = torch.arange(4 * 2 * 3 * 8, dtype=torch.float32).reshape(
        4, 2, 3, 8)
    shard = tp.TensorShard(3, 1, 2, None, "tensor",
                           then=tp.TensorShard(0, 1, 2, None, "expert"))
    part = shard.take(whole)
    torch.testing.assert_close(part, whole[2:, :, :, 4:])
    assert shard.whole_shape(part.shape) == (4, 2, 3, 8)
    assert shard.axes() == ("tensor", "expert")


# -- data x expert x tensor ----------------------------------------------------


@pytest.mark.parametrize("step", range(STEPS))
def test_moe8_steps_match_jax(jobs, jax_side, step):
    want = jax_side["moe8"][0]
    for r in jobs["moe8"]:
        for key in ("loss", "grad_norm", "moe_aux"):
            np.testing.assert_allclose(r["adamw"][key][step],
                                       want[key][step], rtol=1e-4,
                                       err_msg=key)


def test_moe8_params_match_jax(jobs, jax_side):
    _assert_trees_close(_tree_of(jobs["moe8"][0]["adamw_params"]),
                        jax_side["moe8"][1], **TOL)


def test_moe8_shard_shapes(jobs, jax_side):
    """``wi`` and ``wo`` hold JAX's shards (half of the 4 experts, half
    of the mlp dim); the router is whole on every rank, where JAX splits
    its expert columns and gathers them for the softmax."""
    want = jax_side["moe8"][2]
    assert want["wi"] == (2, 2, 32, 32) and want["wo"] == (2, 32, 32)
    for r in jobs["moe8"]:
        shapes = r["shard_shapes"]
        for layer in range(MOE["n_layers"]):
            assert shapes[f"layers.{layer}.moe.wi"] == want["wi"]
            assert shapes[f"layers.{layer}.moe.wo"] == want["wo"]
            assert shapes[f"layers.{layer}.moe.router"] == (32, 4)


def test_moe8_checkpoint_verifies_in_jax(jobs):
    for step in (0, 1):
        assert verify_step(jobs["dir"] / "ckpt_moe8", step) == (True, ""), \
            step


def test_no_mesh_trainer_restores_moe8_checkpoint(jobs):
    """The gathered save holds every expert whole, in the JAX layout: a
    trainer without a mesh restores step 1 as the mesh trainer's
    parameters after 2 steps, bit for bit."""
    init_fn, loss_fn = lm_task(_port_cfg(moe_group_size=MOE8_GROUP),
                               device="cpu")
    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=optim.adamw(1e-3),
                 device="cpu",
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = CheckpointManager(jobs["dir"] / "ckpt_moe8").restore(
        tr.create_state(seed=3), step=1)
    assert state.step == 2 and state.opt_state.count == 2
    for name, p in state.params.named_parameters():
        torch.testing.assert_close(p.detach(),
                                   jobs["moe8"][0]["ckpt_params"][name],
                                   atol=0, rtol=0)
    assert state.params.layers[0].moe.wi.shape == (4, 2, 32, 64)


def test_moe8_adafactor_params_match_jax(jobs, jax_side):
    """adafactor over the expert x tensor slices of ``wi`` and ``wo``
    (refused before it was ported): the parameters after 5 steps are the
    JAX ``Trainer``'s with ``optax.adafactor``."""
    _assert_trees_close(_tree_of(jobs["moe8"][0]["adafactor_params"]),
                        jax_side["moe8_adafactor"][1], **TOL)


@pytest.mark.parametrize("step", range(STEPS))
def test_moe8_adafactor_steps_match_jax(jobs, jax_side, step):
    want = jax_side["moe8_adafactor"][0]
    for r in jobs["moe8"]:
        for key in ("loss", "grad_norm", "moe_aux"):
            np.testing.assert_allclose(r["adafactor"][key][step],
                                       want[key][step], rtol=1e-4,
                                       err_msg=key)


# -- data x sequence: the global aux -------------------------------------------


@pytest.mark.parametrize("key", ["loss", "grad_norm", "moe_aux"])
def test_moe_batch4_matches_no_mesh(jobs, key):
    for r in jobs["moe_batch4"]:
        np.testing.assert_allclose(r["mesh"][key], r["plain"][key],
                                   **NO_MESH_TOL)


def test_moe_batch4_params_match_no_mesh(jobs):
    r = jobs["moe_batch4"][0]
    for name, t in r["mesh_params"].items():
        torch.testing.assert_close(t, r["plain_params"][name], **NO_MESH_TOL)


def test_moe_batch4_aux_is_global(jobs):
    """The mesh's aux is the one over every token of the global batch
    (the no-mesh trainer's); the mean of the four ranks' auxes over
    their own tokens, what a per-rank aux would give, is another number."""
    ranks = jobs["moe_batch4"]
    want = ranks[0]["plain"]["moe_aux"][0]
    for r in ranks:
        np.testing.assert_allclose(r["global_aux"], want, **NO_MESH_TOL)
    local = np.mean([r["local_aux"] for r in ranks])
    assert abs(local - want) > 100 * NO_MESH_TOL["rtol"] * want, (local,
                                                                  want)


@pytest.mark.parametrize("key", ["loss", "grad_norm", "moe_aux"])
def test_moe_batch4_matches_jax(jobs, jax_side, key):
    """The same steps against the JAX ``Trainer`` at data=2 x sequence=2
    with its ring."""
    want = jax_side["batch4"][0][key]
    for r in jobs["moe_batch4"]:
        np.testing.assert_allclose(r["mesh"][key], want, rtol=1e-4)


def test_moe_batch4_params_match_jax(jobs, jax_side):
    _assert_trees_close(_tree_of(jobs["moe_batch4"][0]["mesh_params"]),
                        jax_side["batch4"][1], **TOL)


@pytest.mark.parametrize("key", ["loss", "grad_norm", "moe_aux"])
def test_fsdp_expert_gather_matches_jax(jobs, jax_side, key):
    """fsdp=2 x expert=2 with the gather dispatch against the JAX
    ``Trainer`` on that mesh."""
    want = jax_side["fsdp"][0][key]
    for r in jobs["moe_batch4"]:
        np.testing.assert_allclose(r["fsdp"][key], want, rtol=1e-4)


def test_fsdp_expert_gather_params_match_jax(jobs, jax_side):
    _assert_trees_close(_tree_of(jobs["moe_batch4"][0]["fsdp_params"]),
                        jax_side["fsdp"][1], **TOL)


@pytest.mark.parametrize("key", ["loss", "grad_norm", "moe_aux"])
def test_fsdp_expert_gather_matches_no_mesh(jobs, key):
    for r in jobs["moe_batch4"]:
        np.testing.assert_allclose(r["fsdp"][key], r["fsdp_plain"][key],
                                   **NO_MESH_TOL)


def test_fsdp_expert_gather_params_match_no_mesh(jobs):
    r = jobs["moe_batch4"][0]
    for name, t in r["fsdp_params"].items():
        torch.testing.assert_close(t, r["fsdp_plain_params"][name],
                                   **NO_MESH_TOL)


@pytest.mark.parametrize("case", sorted(SPANNING))
def test_moe_batch4_groups_that_span_ranks_match_jax(jobs, jax_side, case):
    """Groups of 32 at data=2 x sequence=2 with the ring: a group is a
    row, its first 16 tokens on the first rank of a sequence pair and its
    last 16 on the second, whose slot positions start after the first's
    counts.  The loss, ``moe_aux`` and every gradient are JAX's on the
    global batch; at capacity factor 0.5 the second rank of each pair
    drops choices (so a position counted from its own tokens alone would
    keep other ones)."""
    loss, aux, grads = jax_side[f"batch4_spanning_{case}"]
    for r in jobs["moe_batch4"]:
        got = r[f"spanning_{case}"]
        np.testing.assert_allclose(got["loss"], loss, **TOL)
        np.testing.assert_allclose(got["aux"], aux, **TOL)
        _assert_trees_close(got["grads"], grads, **TOL)
        if case == "drop" and r["sequence_index"] == 1:
            assert got["dropped"] > 0


# -- data x pipeline x expert, pipeline x sequence x expert ---------------------


def test_moe_pipe8_loss_matches_jax(jobs, jax_side):
    loss, aux, _ = jax_side["pipe8"]
    for r in jobs["moe_pipe8"]:
        np.testing.assert_allclose(r["pipe_loss"], loss, atol=2e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(r["pipe_aux"], aux, atol=2e-4, rtol=1e-3)


def test_moe_pipe8_gradients_match_jax(jobs, jax_side):
    _, _, grads = jax_side["pipe8"]
    for r in jobs["moe_pipe8"]:
        _assert_trees_close(r["pipe_grads"], grads, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("key", ["loss", "grad_norm", "moe_aux"])
def test_moe_pipe8_trainer_matches_jax(jobs, jax_side, key):
    """The port's ``Trainer`` at data=2 x pipeline=2 x expert=2, each rank
    fed its contiguous rows, against the JAX ``Trainer`` on the same
    global batches: the loss exchanges the rows so that the ranks' local
    microbatch m is JAX's microbatch m, global rows [m B/M, (m+1) B/M)
    (the aux, a product of each microbatch's means, follows the
    grouping), over PIPE_STEPS adamw steps within JAX's pipelined
    bounds."""
    want = jax_side["pipe_trainer"][0][key]
    for r in jobs["moe_pipe8"]:
        np.testing.assert_allclose(r["pipe_trainer"][key], want, **PIPE_TOL)


def test_moe_pipe8_trainer_params_match_jax(jobs, jax_side):
    _assert_trees_close(
        _tree_of(jobs["moe_pipe8"][0]["pipe_trainer_params"]),
        jax_side["pipe_trainer"][1], **PIPE_TOL)


def test_moe_pipe8_ranks_hold_jax_microbatches(jobs):
    """After the exchange data rank d's local microbatch m is global row
    2 m + d (B 8, M 4, one row of each microbatch a rank), the same on
    every stage and expert rank; the aux of the ranks' own contiguous
    microbatches (what the port gave before the exchange) is another
    number than JAX's, which the exchanged rows give."""
    for r in jobs["moe_pipe8"]:
        d = r["data_index"]
        assert r["held_rows"] == [2 * m + d for m in range(4)]
    first = jobs["moe_pipe8"][0]
    assert abs(first["own_rows_aux"] - first["pipe_aux"]) > 1e-3 * abs(
        first["pipe_aux"]), (first["own_rows_aux"], first["pipe_aux"])


def test_moe_pipe8_groups_that_span_ranks_match_jax(jobs, jax_side):
    """JAX's own (B/M)·S = 32 groups: a whole microbatch, half of it on
    each data rank.  One loss, ``moe_aux`` and every gradient against
    JAX's pipelined ``lm_task`` on the same global batch."""
    loss, aux, grads = jax_side["pipe8_spanning"]
    for r in jobs["moe_pipe8"]:
        got = r["spanning"]
        np.testing.assert_allclose(got["loss"], loss, **TOL)
        np.testing.assert_allclose(got["aux"], aux, **TOL)
        _assert_trees_close(got["grads"], grads, **TOL)


@pytest.mark.parametrize("key", ["loss", "moe_aux"])
def test_pp_ring_moe_step_matches_jax(jobs, jax_side, key):
    want = dict(zip(("loss", "moe_aux"), jax_side["pps"]))[key]
    for r in jobs["moe_pipe8"]:
        np.testing.assert_allclose(r["pps"][key][0], want, atol=1e-4,
                                   rtol=1e-4)


# -- the entry point -----------------------------------------------------------


def test_train_lm_expert_matches_no_mesh(jobs):
    """tools/train_lm.py at --mesh expert=2 --moe-experts 4 over gloo:
    both ranks report one loss history and end at the loss of the entry
    point without a mesh on the same flags within 2e-4, every step within
    1e-3 (bf16: each rank's experts' partial outputs are rounded to bf16
    and summed in bf16, where one device rounds the whole combine once;
    adam carries the difference into the next steps)."""
    ranks = jobs["train_lm"]
    assert [r["world"] for r in ranks] == [2, 2]
    losses = [[h["loss"] for h in r["history"]] for r in ranks]
    assert losses[0] == losses[1]
    plain = train_lm.run(TRAIN_LM_ARGV)
    want = [h["loss"] for h in plain.metrics.history]
    assert len(want) == 3
    np.testing.assert_allclose(losses[0][-1], want[-1], rtol=2e-4)
    np.testing.assert_allclose(losses[0], want, rtol=1e-3)


# -- the fused trainer over the expert axis (moe_batch4's second mesh) --------


@pytest.mark.parametrize("step", range(GANG_STEPS))
def test_fused_gang_over_experts_steps_match_jax(jobs, jax_side, step):
    """Every rank's per-member loss and grad_norm of each fused step at
    fsdp=2 x expert=2 (each rank's E/N experts stacked, the expert
    group's reduce and the aux statistics on the members' stack) against
    JAX's ``FusedTrainer`` on the same mesh shape; the ranks' losses
    equal."""
    check_step([r["gang"] for r in jobs["moe_batch4"]], jax_side["gang"][0],
               step, **TOL)


def test_fused_gang_over_experts_members_match_jax(jobs, jax_side):
    """Each member's whole parameters (every expert gathered) after the
    steps against JAX's, and m1 bit-equal on every rank from its stop to
    the end."""
    check_members([r["gang"] for r in jobs["moe_batch4"]],
                  jax_side["gang"][1], GANG_CFG,
                  [GANG_STEPS, GANG[1]["stop_step"]], **TOL)
