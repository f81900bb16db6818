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
"""

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
