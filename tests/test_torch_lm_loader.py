"""The port's ``lm`` loader against the JAX package's, on one JAX export.

A version the JAX package exports under ``kubeflow_tpu.serving.loaders:lm``
loads in the port unchanged (``serving/export.py`` maps the loader name),
and its float32 logits equal JAX's within atol=rtol=1e-4 for both
attention backends.  With ``attention="flash"`` the port's forward goes
through ``flash_fwd`` (on the CPU its plain version, one call a layer);
the JAX loader's flash call takes its dot path on the CPU, as the JAX
package's own tests run it."""

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving.export import export as jax_export
from kubeflow_tpu.serving.export import load_version as jax_load_version
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.serving import export as port_export

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

JAX_LOADER = "kubeflow_tpu.serving.loaders:lm"
SMALL = {"vocab_size": 96, "d_model": 32, "n_layers": 3, "n_heads": 4,
         "n_kv_heads": 2, "d_ff": 64, "head_dim": 8, "max_seq_len": 64}


def _export(base, overrides, seed=0):
    cfg = jax_model_config(overrides)
    variables = JaxTransformer(cfg).init(jax.random.key(seed),
                                         np.zeros((1, 8), np.int32))
    jax_export(base, 1, jax.tree.map(np.asarray, nn.unbox(variables)),
               loader=JAX_LOADER, config=overrides,
               signature={"inputs": ["tokens"], "outputs": ["logits"]})


def _tokens(seed, shape=(2, 24)):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("attention", ["dot", "flash"])
def test_lm_loader_matches_jax(tmp_path, attention, tied):
    overrides = dict(SMALL, attention=attention, tied_embeddings=tied,
                     dtype="float32")
    _export(tmp_path / "lm", overrides, seed=1)
    jax_predict, _ = jax_load_version(tmp_path / "lm", 1)
    port_predict, meta = port_export.load_version(tmp_path / "lm", 1,
                                                  device="cpu")
    assert meta["loader"] == JAX_LOADER
    tokens = _tokens(2)
    want = np.asarray(jax_predict({"tokens": tokens})["logits"])
    calls = []
    plain = flash.flash_fwd_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    flash.flash_fwd_reference = counted
    try:
        got = port_predict({"tokens": tokens})["logits"]
    finally:
        flash.flash_fwd_reference = plain
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (2, 24, SMALL["vocab_size"])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # The flash forward (its plain version here) runs once a layer.
    assert len(calls) == (SMALL["n_layers"] if attention == "flash" else 0)


def test_lm_loader_bf16_stages_narrowed_weights(tmp_path):
    """A bfloat16 export stages its matmul weights narrowed on the device
    once, answers float32 logits, and stays within 5e-2 of the float32
    run of the same weights (the bf16 contraction's rounding)."""
    base = dict(SMALL, attention="flash")
    _export(tmp_path / "bf16", dict(base, dtype="bfloat16"), seed=3)
    _export(tmp_path / "f32", dict(base, dtype="float32"), seed=3)
    bf16, _ = port_export.load_version(tmp_path / "bf16", 1, device="cpu")
    f32, _ = port_export.load_version(tmp_path / "f32", 1, device="cpu")
    assert bf16.model.layers[0].attn.wq.dtype == torch.bfloat16
    assert bf16.model.final_norm.scale.dtype == torch.float32
    tokens = _tokens(4, (1, 16))
    got = bf16({"tokens": tokens})["logits"]
    want = f32({"tokens": tokens})["logits"]
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).mean() < 5e-2


def test_lm_loader_forward_is_the_predict_without_the_copy(tmp_path):
    _export(tmp_path / "lm", dict(SMALL, dtype="float32"), seed=5)
    predict, _ = port_export.load_version(tmp_path / "lm", 1, device="cpu")
    tokens = _tokens(6, (1, 10))
    on_device = predict.forward(torch.from_numpy(tokens).long())
    assert on_device.dtype == torch.float32
    np.testing.assert_array_equal(on_device.numpy(),
                                  predict({"tokens": tokens})["logits"])


@pytest.mark.parametrize("bad", [-1, SMALL["vocab_size"]])
def test_lm_loader_refuses_out_of_range_ids_on_the_host(tmp_path, bad):
    """An id outside [0, vocab_size) is a ValueError raised before the
    forward runs, and the loader answers the next good batch."""
    _export(tmp_path / "lm", dict(SMALL, dtype="float32"), seed=7)
    predict, _ = port_export.load_version(tmp_path / "lm", 1, device="cpu")
    tokens = _tokens(8, (1, 6))
    good = predict({"tokens": tokens})["logits"]
    bad_tokens = tokens.copy()
    bad_tokens[0, 3] = bad
    with pytest.raises(ValueError, match="token ids must lie in"):
        predict({"tokens": bad_tokens})
    np.testing.assert_array_equal(predict({"tokens": tokens})["logits"],
                                  good)
