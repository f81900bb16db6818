"""The port's generate() against the JAX package's.

Greedy tokens must be identical; prefill logits at real positions within
atol=rtol=1e-4 (float32).  The port's flash prefill runs the kernel's
plain version on CPU, whose fully masked pad-query rows give o = 0 where
the JAX dot path gives a uniform softmax; those rows are masked as keys
downstream, so only real positions are compared.  Sampling is held to
its own seeded determinism (JAX's threefry bits are not matched)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models.generate import DecodeConfig as JaxDecodeConfig
from kubeflow_tpu.models.generate import _forward_with_cache as jax_forward
from kubeflow_tpu.models.generate import generate as jax_generate
from kubeflow_tpu.models.generate import init_cache as jax_init_cache
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.models.transformer import (
    TransformerConfig as JaxTransformerConfig,
)
from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
from kubeflow_tpu_torch.models.generate import (
    DecodeConfig,
    _forward_with_cache,
    generate,
    init_cache,
)
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig

VOCAB, T, NEW = 256, 12, 8
SMALL = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, head_dim=8, max_seq_len=64)


@pytest.fixture(scope="module", params=["flash", "dot"])
def models(request):
    overrides = dict(SMALL, attention=request.param)
    jcfg = JaxTransformerConfig(dtype=jnp.float32, **overrides)
    variables = JaxTransformer(jcfg).init(
        jax.random.key(7), np.zeros((1, T), np.int32))
    tree = jax.tree.map(np.asarray, nn.unbox(variables)["params"])
    model = load_params(
        Transformer(TransformerConfig(dtype=torch.float32, **overrides),
                    device="meta"),
        params_from_jax(tree))
    return jcfg, tree, model


def _prompts(lengths):
    """Left-padded [b, T] prompts (pad 0) and their real lengths."""
    rng = np.random.default_rng(3)
    out = np.zeros((len(lengths), T), np.int32)
    for i, n in enumerate(lengths):
        out[i, T - n:] = rng.integers(1, VOCAB, n)
    return out, np.asarray(lengths, np.int32)


def _both(models, prompt, prompt_len=None, **decode):
    jcfg, tree, model = models
    jt, _ = jax_generate(
        jcfg, tree, jnp.asarray(prompt), JaxDecodeConfig(**decode),
        prompt_len=None if prompt_len is None else jnp.asarray(prompt_len))
    pt, _ = generate(
        model, torch.from_numpy(prompt), DecodeConfig(**decode),
        prompt_len=None if prompt_len is None
        else torch.from_numpy(prompt_len))
    return np.asarray(jt), pt.numpy()


def test_greedy_unpadded_identical(models):
    prompt, _ = _prompts([T, T])
    want, got = _both(models, prompt, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)


def test_greedy_left_padded_identical(models):
    prompt, plen = _prompts([T, 7, 3])
    want, got = _both(models, prompt, plen, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)


def test_greedy_eos_early_exit_identical(models):
    prompt, plen = _prompts([T, 5])
    free, _ = _both(models, prompt, plen, max_new_tokens=NEW)
    eos = int(free[0, T + 2])  # row 0 stops at its third new token
    want, got = _both(models, prompt, plen, max_new_tokens=NEW,
                      eos_token=eos)
    np.testing.assert_array_equal(got, want)
    stop = T + list(got[0, T:]).index(eos)
    assert np.all(got[0, stop + 1:] == 0)


def test_prefill_logits_at_real_positions(models):
    jcfg, tree, model = models
    prompt, plen = _prompts([T, 9, 4])
    pad = T - plen
    jlog, _ = jax_forward(jcfg, tree, jnp.asarray(prompt),
                          jax_init_cache(jcfg, 3, T + NEW), 0,
                          pad_amount=jnp.asarray(pad))
    with torch.inference_mode():
        plog = _forward_with_cache(
            model, torch.from_numpy(prompt).long(),
            init_cache(model.cfg, 3, T + NEW, device="cpu"), 0,
            pad_amount=torch.from_numpy(pad).long())
    for row in range(3):
        np.testing.assert_allclose(
            plog[row, pad[row]:].numpy(), np.asarray(jlog)[row, pad[row]:],
            atol=1e-4, rtol=1e-4)


def test_sampling_same_seed_same_tokens(models):
    _, _, model = models
    prompt, plen = _prompts([T, 6])
    decode = DecodeConfig(max_new_tokens=NEW, temperature=1.0, top_k=40,
                          top_p=0.9)

    def run(seed):
        out, _ = generate(model, torch.from_numpy(prompt), decode,
                          generator=torch.Generator().manual_seed(seed),
                          prompt_len=torch.from_numpy(plen))
        return out.numpy()

    first = run(5)
    np.testing.assert_array_equal(run(5), first)
    assert not np.array_equal(run(6), first)
    assert np.all((first >= 0) & (first < VOCAB))
