"""Dropout in the port's Transformer (models/transformer.py) and
``lm_task``.

The JAX package applies flax ``nn.Dropout`` to each block's attention
output and MLP output, with one rng per scanned layer.  flax's rng bits
and torch's differ, so the masks themselves are carried across:

  - rate 0: the JAX loss within 1e-4 (float32), and the port's training
    forward bit-equal to its serving forward, drawing nothing;
  - rate 0.1 against JAX (float32, loss and every gradient within 1e-4):
    flax's Bernoulli is wrapped to record each mask it draws (once per
    scanned layer, attention then MLP) and the port is handed the same
    masks in the same order, so where the masks apply and how kept
    values are scaled are held to the reference; a mask of all ones
    checks the placement and the 1 / (1 - rate) scale alone;
  - rate 0.1: the same seed gives the same losses and another seed other
    ones; the kept share lies within 3 sigma of 0.9 and kept entries are
    scaled by 1 / 0.9; each layer gets its own masks;
  - the masks are drawn before the checkpointed regions, so remat on and
    off give the same gradients within 1e-6 (float32), and a resumed run
    equals an uninterrupted one (the step generator rides the
    checkpoint);
  - every serving path (the forward, ``generate()``, the engine, the
    ``lm`` loader) is deterministic: an export at rate 0.1 answers what
    the same weights at rate 0 answer.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.linen import stochastic

from kubeflow_tpu.models.transformer import (
    TransformerConfig as JaxTransformerConfig,
)
from kubeflow_tpu.models.transformer import lm_task as jax_lm_task
from kubeflow_tpu.serving.export import export as jax_export
from kubeflow_tpu_torch.models import transformer
from kubeflow_tpu_torch.models.convert import (
    load_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
from kubeflow_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    lm_task,
)
from kubeflow_tpu_torch.runtime import optim
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.serving import export as port_export
from kubeflow_tpu_torch.serving.engine import DecodeEngine

SMALL = dict(vocab_size=128, d_model=32, n_layers=3, n_heads=4,
             n_kv_heads=2, d_ff=64, head_dim=8, max_seq_len=64,
             attention="flash")
RATE = 0.1


def _tokens(seed=1, shape=(2, 32)):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], shape).astype(np.int64))


def _model(rate=RATE, **kw):
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(SMALL, dropout_rate=rate, **kw))
    return Transformer(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))


def _loss(model, seed, tokens=None):
    _, loss_fn = lm_task(model.cfg, device="cpu")
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    loss, _ = loss_fn(model, {}, {"tokens": _tokens() if tokens is None
                                  else tokens}, gen)
    return loss


def test_rate_zero_matches_jax():
    jcfg = JaxTransformerConfig(dtype=jnp.float32,
                                **dict(SMALL, dropout_rate=0.0))
    init_fn, jloss_fn = jax_lm_task(jcfg)
    tree = jax.tree.map(np.asarray, nn.unbox(init_fn(jax.random.key(0))[0]))
    tokens = _tokens()
    jloss, _ = jloss_fn(tree, {}, {"tokens": jnp.asarray(tokens.numpy(),
                                                         jnp.int32)},
                        jax.random.key(3))
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(SMALL, dropout_rate=0.0))
    model = load_params(Transformer(cfg, device="meta"),
                        params_from_jax(tree))
    got = _loss(model, 3, tokens)
    np.testing.assert_allclose(got.item(), float(jloss), atol=1e-4,
                               rtol=1e-4)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


class _RecordingRandom:
    """Stands in for ``jax.random`` inside flax's dropout: ``bernoulli``
    draws flax's mask (or, with ``ones``, a keep probability of 1, so
    everything is kept) and records it on the host as the program runs,
    in program order."""

    def __init__(self, ones):
        self.ones, self.masks = ones, []

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def bernoulli(self, key, p, shape):
        mask = jax.random.bernoulli(key, p=1.0 if self.ones else p,
                                    shape=shape)
        jax.debug.callback(lambda m: self.masks.append(np.array(m)), mask,
                           ordered=True)
        return mask


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("masks", ["ones", "flax"])
def test_rate_point_one_matches_jax_on_its_masks(masks, remat,
                                                 monkeypatch):
    jcfg = JaxTransformerConfig(dtype=jnp.float32,
                                **dict(SMALL, dropout_rate=RATE))
    init_fn, jloss_fn = jax_lm_task(jcfg)
    tree = jax.tree.map(np.asarray, nn.unbox(init_fn(jax.random.key(0))[0]))
    tokens = _tokens()
    recorder = _RecordingRandom(ones=masks == "ones")
    monkeypatch.setattr(stochastic, "random", recorder)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, {}, {"tokens": jnp.asarray(tokens.numpy(),
                                                         jnp.int32)},
                           jax.random.key(3)), has_aux=True)(tree)
    jax.effects_barrier()
    assert len(recorder.masks) == 2 * SMALL["n_layers"]
    shape = tokens.shape + (SMALL["d_model"],)
    assert all(m.shape == shape and m.dtype == np.bool_
               for m in recorder.masks)
    if masks == "ones":
        assert all(m.all() for m in recorder.masks)
    else:
        kept = np.mean(recorder.masks)
        assert 0.8 < kept < 0.98
        assert not np.array_equal(recorder.masks[0], recorder.masks[1])

    handed = iter(recorder.masks)

    def replay(shape_, rate, generator, device):
        assert rate == RATE and generator is not None
        mask = torch.from_numpy(next(handed)).to(device)
        assert tuple(mask.shape) == tuple(shape_)
        return mask

    monkeypatch.setattr(transformer, "dropout_mask", replay)
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(SMALL, dropout_rate=RATE, remat=remat))
    model = load_params(Transformer(cfg, device="meta"),
                        params_from_jax(tree))
    loss = _loss(model, 3, tokens)
    loss.backward()
    assert next(handed, None) is None
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-4,
                               rtol=1e-4)
    got = _flat(params_to_jax(model, grads=True))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-4,
                                   rtol=1e-4, err_msg=str(path))


def test_rate_zero_draws_nothing_and_equals_the_serving_forward():
    """At rate 0 the training forward is the serving forward bit for bit
    and leaves the step generator untouched."""
    model = _model(rate=0.0)
    tokens = _tokens()
    gen = torch.Generator().manual_seed(11)
    before = gen.get_state()
    train = model(tokens, deterministic=False, generator=gen)
    assert torch.equal(gen.get_state(), before)
    assert torch.equal(train, model(tokens))
    _, loss_fn = lm_task(model.cfg, device="cpu")
    loss, _ = loss_fn(model, {}, {"tokens": tokens}, None)
    want = torch.nn.functional.cross_entropy(
        model(tokens)[:, :-1].flatten(0, 1), tokens[:, 1:].flatten())
    assert torch.equal(loss, want)


def test_same_seed_same_losses_other_seed_other_losses():
    model = _model()
    a, b, c = _loss(model, 5), _loss(model, 5), _loss(model, 6)
    assert torch.equal(a, b)
    assert a.item() != c.item()
    assert a.item() != _loss(_model(rate=0.0), None).item()


def test_training_forward_needs_a_generator():
    model = _model()
    with pytest.raises(ValueError, match="needs a generator"):
        model(_tokens(), deterministic=False)


def test_kept_share_and_scale():
    """flax's Bernoulli keep mask: the kept share within 3 sigma of
    1 - rate, kept entries scaled by 1 / (1 - rate), the rest zero."""
    shape = (4, 64, 128)
    n = math.prod(shape)
    keep = transformer.dropout_mask(shape, RATE,
                                    torch.Generator().manual_seed(2), "cpu")
    share = keep.float().mean().item()
    sigma = math.sqrt(RATE * (1 - RATE) / n)
    assert abs(share - (1 - RATE)) < 3 * sigma
    y = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    out = transformer._dropped(y, keep, RATE)
    torch.testing.assert_close(out[keep], y[keep] / (1 - RATE), atol=0,
                               rtol=0)
    assert torch.all(out[~keep] == 0)


def test_layers_get_their_own_masks(monkeypatch):
    drawn = []
    plain = transformer.dropout_mask

    def spy(*args, **kwargs):
        drawn.append(plain(*args, **kwargs))
        return drawn[-1]

    monkeypatch.setattr(transformer, "dropout_mask", spy)
    _loss(_model(), 5)
    assert len(drawn) == 2 * SMALL["n_layers"]
    for i in range(len(drawn)):
        for j in range(i):
            assert not torch.equal(drawn[i], drawn[j]), (i, j)


@pytest.mark.parametrize("policy", ["nobatch", "minimal"])
@pytest.mark.parametrize("attention", ["flash", "dot"])
def test_remat_gives_the_same_grads(attention, policy):
    """Masks drawn outside the checkpointed regions: the recompute
    applies the same ones, so remat on and off agree (float32)."""
    grads = []
    for remat in (False, True):
        model = _model(remat=remat, remat_policy=policy,
                       attention=attention)
        loss = _loss(model, 9)
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone()
                                    for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    assert l0 == pytest.approx(l1, abs=1e-6)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-6,
                                   rtol=1e-6)


def _trainer(ckpt=None):
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(SMALL, dropout_rate=RATE, remat=True))
    init_fn, loss_fn = lm_task(cfg, device="cpu")
    return Trainer(init_fn=init_fn, loss_fn=loss_fn,
                   tx=optim.adamw(1e-2), device="cpu",
                   checkpoints=CheckpointManager(ckpt) if ckpt else None,
                   checkpoint_every=2,
                   metrics=MetricsLogger(stream=open("/dev/null", "w")))


def _data():
    rng = np.random.RandomState(4)
    while True:
        yield {"tokens": rng.randint(0, SMALL["vocab_size"],
                                     size=(2, 32)).astype(np.int32)}


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    whole = _trainer()
    whole.fit(_data(), 4, log_every=1)
    losses = [r["loss"] for r in whole.metrics.history]
    assert len(set(losses)) == 4

    first = _trainer(tmp_path / "ckpt")
    first.fit(_data(), 2, log_every=1)
    resumed = _trainer(tmp_path / "ckpt")
    resumed.fit(_data(), 4, log_every=1)
    got = [r["loss"] for r in first.metrics.history] + \
        [r["loss"] for r in resumed.metrics.history]
    assert [r["step"] for r in resumed.metrics.history] == [2, 3]
    assert got == losses


def test_the_step_generator_moves_between_steps():
    trainer = _trainer()
    state = trainer.create_state(seed=0)
    step = trainer.compile_step()
    batch = trainer.shard_batch(next(_data()))
    snapshot = {n: p.detach().clone()
                for n, p in state.params.named_parameters()}
    before = state.rng.get_state()
    state, first = step(state, batch)
    assert not torch.equal(state.rng.get_state(), before)
    for n, p in state.params.named_parameters():
        p.data.copy_(snapshot[n])
    state, second = step(state, batch)
    assert first["loss"].item() != second["loss"].item()


def test_serving_paths_are_deterministic(tmp_path):
    """A model configured with dropout serves exactly what the same
    weights at rate 0 serve: its forward, ``generate()``, the engine and
    an ``lm`` export draw no mask."""
    model, plain = _model(), _model(rate=0.0)
    tokens = _tokens()
    assert torch.equal(model(tokens), plain(tokens))
    decode = DecodeConfig(max_new_tokens=4)
    prompt = tokens[:, :8]
    assert torch.equal(generate(model, prompt, decode)[0],
                       generate(plain, prompt, decode)[0])
    outs = []
    for m in (model, plain):
        engine = DecodeEngine(m, decode, slots=2, prefill_len=16,
                              kv_block_tokens=4, prefill_chunk_tokens=8,
                              name="dropout-test")
        try:
            outs.append(engine.submit({"tokens": prompt[0].numpy().astype(
                np.int32)})["tokens"])
        finally:
            engine.close()
    np.testing.assert_array_equal(np.asarray(outs[0]), np.asarray(outs[1]))

    jcfg = JaxTransformerConfig(dtype=jnp.float32, **SMALL)
    init_fn, _ = jax_lm_task(jcfg)
    tree = jax.tree.map(np.asarray, nn.unbox(init_fn(jax.random.key(0))[0]))
    answers = []
    for rate in (RATE, 0.0):
        base = tmp_path / f"lm{rate}"
        config = dict(SMALL, dtype="float32", dropout_rate=rate)
        jax_export(base, 1, {"params": tree},
                   loader="kubeflow_tpu.serving.loaders:lm", config=config,
                   signature={"inputs": ["tokens"], "outputs": ["logits"]})
        predict, _ = port_export.load_version(base, 1, device="cpu")
        first = predict({"tokens": tokens.numpy().astype(np.int32)})
        again = predict({"tokens": tokens.numpy().astype(np.int32)})
        np.testing.assert_array_equal(first["logits"], again["logits"])
        answers.append(first["logits"])
    np.testing.assert_array_equal(answers[0], answers[1])


def test_config_is_frozen_and_pipeline_refuses_dropout():
    cfg = TransformerConfig(dropout_rate=RATE)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.dropout_rate = 0.0
    with pytest.raises(ValueError, match="dropout_rate=0"):
        TransformerConfig(dropout_rate=RATE, pipeline_microbatches=2)
