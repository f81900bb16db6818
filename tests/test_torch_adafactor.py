"""The port's adafactor against optax.adafactor.

``optim.adafactor`` takes the port's per-layer parameters by name and
works on the JAX model's stacked ``[L, ...]`` leaves, so it is held to
``optax.adafactor`` on the stacked tree: factored leaves (two dims of at
least 128, ties among equal dims resolved by numpy's argsort), unfactored
ones, leaves whose update is clipped by its block RMS and one that is
not, and an all-zero leaf whose parameter scale falls to min_scale.
Tolerance: atol=1e-6, rtol=1e-5 on the parameters and the factored
statistics after each of 5 updates (float32, another order of the same
arithmetic).  The Trainer with adafactor is held to the JAX Trainer with
optax.adafactor over 5 steps at atol=rtol=1e-4 (loss, grad_norm), on a
config whose attention and MLP leaves are factored.

Under a split (an FSDP2 shard, a tensor or expert slice, a pipeline
stage's layers) each rank's update is held to its share of optax's on
the whole leaf, in one process: ``sharded_against_optax`` runs the ranks
as threads whose all-reduces (parallel/p2p.py ``all_reduce``) meet in a
``ThreadGroup``, and compares each rank's parameters and statistics after
3 updates with the slices its marks name of optax's (OPT_TOL): uneven
FSDP2 shards (one rank's empty), a chained expert x tensor slice and a
factored layer dim over pipeline stages beside uneven FSDP2 shards.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models.transformer import (
    TransformerConfig as JaxTransformerConfig,
)
from kubeflow_tpu.models.transformer import lm_task as jax_lm_task
from kubeflow_tpu.parallel import MeshSpec
from kubeflow_tpu.runtime.metrics import MetricsLogger as JaxMetricsLogger
from kubeflow_tpu.runtime.train import Trainer as JaxTrainer
from kubeflow_tpu_torch.models.convert import (
    load_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.transformer import TransformerConfig, lm_task
from kubeflow_tpu_torch.parallel import tensor as tp
from kubeflow_tpu_torch.parallel.pipeline import Stage
from kubeflow_tpu_torch.runtime import optim
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer

OPT_TOL = dict(atol=1e-6, rtol=1e-5)
LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
L = 3
# Stacked JAX leaves: factored [L, 128, 160], tied dims [L, 128, 128]
# (argsort picks axes 1 and 2), [L, 2, 130, 4] with one dim >= 128
# (unfactored), per-layer vectors, an all-zero leaf, and a matrix and a
# vector outside the layers.
SHAPES = {"embed": (200, 144), "final_scale": (144,),
          "layers.w": (L, 128, 160), "layers.sq": (L, 128, 128),
          "layers.narrow": (L, 2, 130, 4), "layers.scale": (L, 144),
          "layers.zero": (L, 16, 8)}


def _jax_tree(flat):
    tree = {"layers": {}}
    for name, value in flat.items():
        if name.startswith("layers."):
            tree["layers"][name.split(".", 1)[1]] = value
        else:
            tree[name] = value
    return tree


def _port(flat):
    """The port's per-layer named tensors of the stacked leaves."""
    out = {}
    for name, value in flat.items():
        if name.startswith("layers."):
            for i in range(L):
                out[f"layers.{i}.{name.split('.', 1)[1]}"] = \
                    torch.from_numpy(value[i].copy())
        else:
            out[name] = torch.from_numpy(value.copy())
    return out


def _stacked(port, leaf):
    if not leaf.startswith("layers."):
        return port[leaf].numpy()
    rest = leaf.split(".", 1)[1]
    return np.stack([port[f"layers.{i}.{rest}"].numpy() for i in range(L)])


@pytest.mark.parametrize("schedule", [False, True])
def test_adafactor_matches_optax_on_stacked_leaves(schedule):
    rng = np.random.default_rng(3)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    params["layers.zero"][:] = 0.0
    # Gradients of mixed scales: some leaves' updates exceed block RMS 1
    # (clipped), others do not.
    grads = [{k: (rng.standard_normal(s) * rng.choice([1e-3, 1.0, 30.0],
                                                      size=s))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(5)]
    lr = (optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5, 1e-3)
          if schedule else 1e-2)
    jlr = (optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5, 1e-3)
           if schedule else 1e-2)
    tx = optax.adafactor(jlr)
    jparams = jax.tree.map(jnp.asarray, _jax_tree(params))
    jstate = tx.init(jparams)
    port = optim.adafactor(lr)
    tparams = _port(params)
    state = port.init(tparams)
    factored = {leaf for leaf in SHAPES
                if optim._factored_dims(list(SHAPES[leaf])) is not None}
    assert factored == {"embed", "layers.w", "layers.sq"}
    clipped = set()
    for t, g in enumerate(grads):
        jg = jax.tree.map(jnp.asarray, _jax_tree(g))
        # Which leaves clip_by_block_rms cuts at this update.
        raw, _ = optax.scale_by_factored_rms().update(jg, jstate[0], jparams)
        clipped |= {k for k, v in _flat(raw).items()
                    if float(jnp.sqrt(jnp.mean(v * v))) > 1.0}
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port.update(_port(g), state, tparams)
        assert state.count == t + 1
        for leaf, want in _flat(jax.tree.map(np.asarray, jparams)).items():
            np.testing.assert_allclose(_stacked(tparams, leaf), want,
                                       err_msg=f"update {t} {leaf}",
                                       **OPT_TOL)
        for key, ours in (("v_row", state.v_row), ("v_col", state.v_col),
                          ("v", state.v)):
            for leaf, want in _flat(getattr(jstate[0], key)).items():
                np.testing.assert_allclose(ours[leaf].numpy(),
                                           np.asarray(want), **OPT_TOL,
                                           err_msg=f"{key} {leaf}")
    assert clipped and clipped != set(SHAPES)
    # The zero leaf moved by min_scale * lr * update, not by zero.
    assert np.abs(_stacked(tparams, "layers.zero")).max() > 0


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def test_factored_dims_resolve_ties_as_numpy():
    for shape in ((128, 128), (3, 128, 128), (2, 256, 2, 256),
                  (256, 2, 256), (128,), (127, 4096), (4, 128, 129)):
        want = optax._src.factorized._factored_dims(shape, True, 128)
        assert optim._factored_dims(list(shape)) == want, shape


def test_leaf_groups_stack_layers_in_order():
    names = ["embed", "layers.1.attn.wq", "layers.0.attn.wq",
             "layers.10.attn.wq", "layers.2.attn.wq"] + [
                 f"layers.{i}.attn.wq" for i in range(3, 10)]
    groups = optim.leaf_groups(names)
    assert list(groups) == ["embed", "layers.attn.wq"]
    assert groups["layers.attn.wq"] == [f"layers.{i}.attn.wq"
                                        for i in range(11)]
    with pytest.raises(ValueError, match="not layers"):
        optim.leaf_groups(["layers.0.w", "layers.2.w"])
    with pytest.raises(TypeError, match="by name"):
        optim.adafactor(1e-3).init([torch.zeros(3)])


def test_trainer_with_adafactor_matches_jax_trainer():
    overrides = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                     n_kv_heads=1, d_ff=256, head_dim=128, max_seq_len=32,
                     attention="flash", remat=True)
    jcfg = JaxTransformerConfig(dtype=jnp.float32, **overrides)
    jinit, jloss = jax_lm_task(jcfg)
    jtrainer = JaxTrainer(
        init_fn=jinit, loss_fn=jloss, tx=optax.adafactor(1e-2),
        mesh=MeshSpec(data=1).build(jax.devices()[:1]),
        metrics=JaxMetricsLogger(stream=open("/dev/null", "w")))
    jstate = jtrainer.create_state(seed=0)
    tree = jax.tree.map(np.asarray, jstate.params)
    factored = [k for k, v in _flat(tree).items()
                if optim._factored_dims(list(v.shape)) is not None]
    assert len(factored) >= 5, factored  # embed, wq, wkv, wo, wi, mlp.wo

    cfg = TransformerConfig(dtype=torch.float32, **overrides)
    init_fn, loss_fn = lm_task(cfg, device="cpu")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adafactor(1e-2), device="cpu",
                      metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = trainer.create_state(seed=0)
    load_params(state.params, params_from_jax(tree))
    rng = np.random.RandomState(7)
    jstep, step = jtrainer.compile_step(), trainer.compile_step()
    for i in range(5):
        batch = {"tokens": rng.randint(0, 256, size=(2, 32)).astype(
            np.int32)}
        jstate, jm = jstep(jstate, jtrainer.shard_batch(batch))
        state, m = step(state, trainer.shard_batch(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       err_msg=f"step {i} {key}", **LOSS_TOL)
    got = _flat(params_to_jax(state.params))
    for path, want in _flat(jax.tree.map(np.asarray, jstate.params)).items():
        np.testing.assert_allclose(got[path], want, atol=1e-4, rtol=1e-3,
                                   err_msg=path)


# -- under splits: the ranks as threads -----------------------------------------

_ME = threading.local()


class ThreadGroup:
    """The ranks (threads) of one process group: ``all_reduce`` sums
    their tensors in rank order once every member has brought its own."""

    def __init__(self, ranks):
        self.ranks = list(ranks)
        self.barrier = threading.Barrier(len(self.ranks), timeout=60)
        self.slots = {}

    def all_reduce(self, t):
        self.slots[self.ranks.index(_ME.rank)] = t.detach().clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for i in range(1, len(self.ranks)):
            total += self.slots[i]
        self.barrier.wait()
        return total


def axis_groups(sizes):
    """Rank -> {axis: (index, its ThreadGroup)} over the grid ``sizes``
    (axis -> size, outermost first; rank = row-major index)."""
    axes = list(sizes)
    grid = np.arange(int(np.prod(list(sizes.values())))).reshape(
        list(sizes.values()))
    out = {int(r): {} for r in grid.flat}
    for d, axis in enumerate(axes):
        rows = np.moveaxis(grid, d, -1).reshape(-1, sizes[axis])
        for row in rows:
            group = ThreadGroup(row.tolist())
            for index, r in enumerate(row.tolist()):
                out[r][axis] = (index, group)
    return out


def sharded_against_optax(monkeypatch, shapes, sizes, split, updates=3):
    """Every rank of the grid ``sizes`` (a thread each) takes its share
    of random whole leaves ``shapes`` (JAX leaf -> shape; ``layers.*``
    stacked [L, ...]) as ``split(coords, leaf)`` names it: (the
    ``TensorShard`` chain of one parameter or None, the pipeline
    ``Stage`` of a layer or None), and takes ``updates`` adafactor
    updates on its shares of random gradients.  Each rank's parameters
    and statistics must then be their shares of optax.adafactor's on the
    whole leaves."""
    rng = np.random.default_rng(9)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * rng.choice([1e-3, 1.0, 30.0],
                                                      size=s))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(updates)]
    tx = optax.adafactor(1e-2)
    jparams = jax.tree.map(jnp.asarray, _jax_tree(params))
    jstate = tx.init(jparams)
    for g in grads:
        step, jstate = tx.update(jax.tree.map(jnp.asarray, _jax_tree(g)),
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, step)
    want = _flat(jax.tree.map(np.asarray, jparams))
    stats = {key: _flat(jax.tree.map(np.asarray, getattr(jstate[0], key)))
             for key in ("v_row", "v_col", "v")}
    groups = axis_groups(sizes)
    monkeypatch.setattr(optim.p2p, "all_reduce",
                        lambda t, group: group.all_reduce(t))

    def shares(coords, flat):
        """This rank's named local tensors of the whole leaves ``flat``
        and, per leaf, its held layers."""
        out, held = {}, {}
        for leaf, whole in flat.items():
            shard, stage = split(coords, leaf)
            if not leaf.startswith("layers."):
                out[leaf] = tp.mark(_share(shard, whole), shard)
                continue
            rest = leaf.split(".", 1)[1]
            layers = range(whole.shape[0]) if stage is None else range(
                stage.offset, stage.offset + stage.layers)
            held[leaf] = layers
            for j, layer in enumerate(layers):
                out[f"layers.{j}.{rest}"] = tp.mark_stage(tp.mark(
                    _share(shard, whole[layer]), shard), stage)
        return out, held

    results, errors = {}, []

    def rank(r):
        _ME.rank = r
        try:
            coords = groups[r]
            local, held = shares(coords, params)
            port = optim.adafactor(1e-2)
            state = port.init(local)
            for g in grads:
                port.update(shares(coords, g)[0], state, local)
            results[r] = (local, held, state)
        except BaseException as e:  # surfaced below, with the rank
            errors.append((r, e))
            for row in groups[r].values():
                row[1].barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in groups]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0][1]
    assert len(results) == len(groups)
    for r, (local, held, state) in results.items():
        for leaf, whole in want.items():
            shard, stage = split(groups[r], leaf)
            if leaf.startswith("layers."):
                rest = leaf.split(".", 1)[1]
                got = np.stack([local[f"layers.{j}.{rest}"].numpy()
                                for j in range(len(held[leaf]))])
                expect = np.stack([_share(shard, torch.from_numpy(
                    np.array(whole[i]))).numpy() for i in held[leaf]])
            else:
                got = local[leaf].numpy()
                expect = _share(shard, torch.from_numpy(
                    np.array(whole))).numpy()
            np.testing.assert_allclose(got, expect, **OPT_TOL,
                                       err_msg=f"rank {r} {leaf}")
        for key, ours in (("v_row", state.v_row), ("v_col", state.v_col),
                          ("v", state.v)):
            for leaf, whole in stats[key].items():
                mark = tp.shard_of(ours[leaf])
                expect = torch.from_numpy(np.array(whole))
                expect = expect if mark is None else mark.take(expect)
                np.testing.assert_allclose(
                    ours[leaf].numpy(), expect.numpy(), **OPT_TOL,
                    err_msg=f"rank {r} {key} {leaf}")
    return results


def _share(shard, whole):
    whole = torch.as_tensor(whole)
    return (whole if shard is None else shard.take(whole)).clone()


def _fsdp(coords, dim, size):
    index, group = coords["fsdp"]
    return tp.TensorShard(dim, index, len(group.ranks), group, "fsdp",
                          size=size)


def _slice(coords, axis, dim, then=None):
    index, group = coords[axis]
    return tp.TensorShard(dim, index, len(group.ranks), group, axis,
                          then=then)


def _uneven_fsdp(coords, leaf):
    """FSDP2's uneven shards over 3 ranks (on dim 0, the one FSDP2 splits
    unevenly): a factored leaf split on its second-largest dim (130: 44,
    44, 42), a stacked one on a layer's (the same), a vector of 5 (2, 2,
    1) and one of 2 (1, 1, 0)."""
    size = {"embed": 130, "layers.w": 130, "layers.scale": 5,
            "final": 2}[leaf]
    return _fsdp(coords, 0, size), None


def _expert_tensor(coords, leaf):
    """An MoE layer at expert=2 x tensor=2: ``wi`` [E, 2, embed, mlp]
    and ``wo`` [E, mlp, embed] slice their experts and their mlp dim
    (the model's chain: tensor, then expert), the router whole, the
    embedding's vocab over tensor."""
    if leaf == "layers.moe.router":
        return None, None
    if leaf == "embed":
        return _slice(coords, "tensor", 0), None
    mlp = {"layers.moe.wi": 3, "layers.moe.wo": 1}[leaf]
    return _slice(coords, "tensor", mlp,
                  then=_slice(coords, "expert", 0)), None


def _stages_fsdp(coords, leaf):
    """pipeline=2 x fsdp=2: 128 layers a stage of a [256, 200] leaf
    whose factored dims are its layer dim and its width (the width split
    over fsdp, 100 each), a [256, 3] one (3 over fsdp: 2, 1), and an
    embedding outside the stack split on its width (130: 65, 65)."""
    if leaf == "embed":
        return _fsdp(coords, 1, 130), None
    index, group = coords["pipeline"]
    stage = Stage(index, 2, 128, group)
    size = {"layers.w": 200, "layers.b": 3}[leaf]
    return _fsdp(coords, 0, size), stage


SPLITS = {
    "fsdp_uneven": ({"embed": (130, 200), "layers.w": (2, 130, 160),
                     "layers.scale": (2, 5), "final": (2,)},
                    {"fsdp": 3}, _uneven_fsdp),
    "expert_tensor": ({"layers.moe.wi": (2, 4, 2, 130, 256),
                       "layers.moe.wo": (2, 4, 256, 130),
                       "layers.moe.router": (2, 130, 4),
                       "embed": (256, 130)},
                      {"expert": 2, "tensor": 2}, _expert_tensor),
    "stages_fsdp": ({"layers.w": (256, 200), "layers.b": (256, 3),
                     "embed": (200, 130)},
                    {"pipeline": 2, "fsdp": 2}, _stages_fsdp),
}


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_sharded_statistics_match_optax(monkeypatch, case):
    """Each rank's parameters and statistics after 3 updates are its
    shares of optax's on the whole leaves (module docstring); the
    factored dims are the whole leaf's."""
    shapes, sizes, split = SPLITS[case]
    factored = {k for k, s in shapes.items()
                if optim._factored_dims(list(s)) is not None}
    assert factored, case
    results = sharded_against_optax(monkeypatch, shapes, sizes, split)
    if case == "fsdp_uneven":
        # The rank whose share of the 2-vector is empty updated nothing
        # of it, and every rank's statistic of the factored leaf that
        # keeps the split dim holds its 44, 44 or 42 columns.
        assert [tuple(results[r][0]["final"].shape) for r in range(3)] == [
            (1,), (1,), (0,)]
        assert [tuple(results[r][2].v_row["embed"].shape)
                for r in range(3)] == [(44,), (44,), (42,)]
