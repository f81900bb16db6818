"""The port's Transformer and weight bridge against the JAX package's.

Logits of the port's Transformer on bridged weights are held to
``Transformer.apply`` at atol=rtol=1e-4 (float32; the port's flash
attention runs its plain version on CPU, the JAX one its dot path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.models.transformer import (
    TransformerConfig as JaxTransformerConfig,
)
from kubeflow_tpu_torch.models.convert import (
    load_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.ops.quantize import CONTRACTIONS, narrow_params

SMALL = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, head_dim=8, max_seq_len=64)


def _jax_params(overrides, seed=0, tokens_shape=(2, 12)):
    cfg = JaxTransformerConfig(dtype=jnp.float32, **overrides)
    variables = JaxTransformer(cfg).init(
        jax.random.key(seed), np.zeros(tokens_shape, np.int32))
    return cfg, jax.tree.map(np.asarray, nn.unbox(variables)["params"])


def _port_model(overrides, tree):
    cfg = TransformerConfig(dtype=torch.float32, **overrides)
    return load_params(Transformer(cfg, device="meta"), params_from_jax(tree))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("tied", [True, False])
def test_bridge_round_trip(tied):
    overrides = dict(SMALL, tied_embeddings=tied)
    _, tree = _jax_params(overrides)
    back = params_to_jax(_port_model(overrides, tree))
    want, got = _flat(tree), _flat(back)
    assert set(want) == set(got)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))
        assert got[path].dtype == arr.dtype


@pytest.mark.parametrize("attention", ["dot", "flash"])
@pytest.mark.parametrize("tied", [True, False])
def test_logits_match_jax(tied, attention):
    overrides = dict(SMALL, tied_embeddings=tied, attention=attention)
    cfg, tree = _jax_params(overrides)
    tokens = np.random.default_rng(1).integers(1, 256, (2, 12)).astype(
        np.int32)
    want = np.asarray(JaxTransformer(cfg).apply({"params": tree}, tokens))
    with torch.no_grad():
        got = _port_model(overrides, tree)(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_init_scales_match_jax():
    """Seeded port init draws each leaf with the JAX init's scale (std
    within 10%; lecun-normal kernels, normal(0.02) embed, unit norms)."""
    overrides = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=128, head_dim=16,
                     tied_embeddings=False)
    _, tree = _jax_params(overrides)
    model = Transformer(TransformerConfig(dtype=torch.float32, **overrides),
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    ours = _flat(params_to_jax(model))
    for path, arr in _flat(tree).items():
        if path[-1] == "scale":
            np.testing.assert_array_equal(ours[path], arr)
            continue
        np.testing.assert_allclose(ours[path].std(), arr.std(), rtol=0.1,
                                   err_msg=str(path))


def test_narrow_params_narrows_exactly_the_contractions():
    _, tree = _jax_params(dict(SMALL, tied_embeddings=False))
    narrowed = _flat(narrow_params(params_from_jax(tree), torch.bfloat16))
    table = {suffix for suffix in CONTRACTIONS}
    for path, leaf in narrowed.items():
        on_table = any(path[-len(s):] == s for s in table)
        assert leaf.dtype == (torch.bfloat16 if on_table
                              else torch.float32), path
    assert sum(leaf.dtype == torch.bfloat16 for leaf in narrowed.values()) \
        == len(CONTRACTIONS)


@pytest.mark.parametrize("option", [
    dict(moe_experts=2), dict(pipeline_microbatches=2),
    dict(attention="ring"), dict(attention="flash", flash_block_diag=8),
    dict(dropout_rate=0.1),
])
def test_unsupported_options_raise(option):
    cfg = TransformerConfig(dtype=torch.float32, **dict(SMALL, **option))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transformer(cfg, device="meta")
