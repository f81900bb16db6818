"""The port's flash forward against the JAX Pallas kernel.

``flash_fwd_reference`` (the plain version the port runs on CPU tensors)
is held to ``kubeflow_tpu.ops.flash._flash_fwd_bhsd`` in Pallas interpret
mode on the same float32 inputs, for both kernel variants (unmasked and
per-row key-start masked).  Tolerance: o and lse within atol=rtol=1e-5
(float32, different summation order).  The CUDA kernel itself is held to
the same plain version by tests/test_torch_flash_cuda.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.flash import _flash_fwd_bhsd
from kubeflow_tpu.ops.flash import flash_attention as jax_flash_attention
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.ops.attention import NEG_INF

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, bh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, sq, d), np.float32),
            rng.standard_normal((bh, sk, d), np.float32),
            rng.standard_normal((bh, sk, d), np.float32))


# (causal, sq, sk, kv_start per row or None).  Lengths are not multiples
# of 128; starts cover a pad past the first 32-key block, one that fully
# masks the early causal rows, and one past the end (a fully masked row).
CASES = {
    "causal": (True, 96, 96, None),
    "noncausal_sq_ne_sk": (False, 64, 96, None),
    "causal_masked": (True, 96, 96, [0, 40, 95, 96]),
    "noncausal_masked": (False, 64, 96, [0, 33, 90, 200]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_kernel(case):
    causal, sq, sk, starts = CASES[case]
    q, k, v = _qkv(3, 4, sq, sk, 16)
    start = None if starts is None else np.asarray(starts, np.int32)
    jo, jlse = _flash_fwd_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=32, block_k=32, interpret=True,
        kv_start=None if start is None else jnp.asarray(start)[:, None])
    po, plse = flash.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        kv_start=None if start is None else torch.from_numpy(start))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse), **TOL)


def test_fully_masked_rows_give_zero_and_neg_inf():
    q, k, v = _qkv(4, 2, 64, 64, 16)
    start = torch.tensor([40, 64], dtype=torch.int32)
    o, lse = flash.flash_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, kv_start=start)
    # Row 0: queries before key 40 see no valid key; row 1: none do.
    assert torch.all(o[0, :40] == 0) and torch.all(lse[0, :40] == NEG_INF)
    assert torch.all(o[1] == 0) and torch.all(lse[1] == NEG_INF)
    assert torch.isfinite(o).all()
    assert torch.all(lse[0, 40:] > NEG_INF / 2)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_gqa_matches_jax(masked):
    rng = np.random.default_rng(5)
    b, s, h, hkv, d = 2, 64, 4, 2, 16
    q = rng.standard_normal((b, s, h, d), np.float32)
    k = rng.standard_normal((b, s, hkv, d), np.float32)
    v = rng.standard_normal((b, s, hkv, d), np.float32)
    start = np.asarray([0, 21], np.int32) if masked else None
    jo = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=32, block_k=32, interpret=True,
        kv_valid_start=None if start is None else jnp.asarray(start))
    po = flash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True,
        kv_valid_start=None if start is None else torch.from_numpy(start))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)


def test_flash_fwd_with_lse_layout():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, 2, 8),
                                                   np.float32))
               for _ in range(3))
    o, lse = flash.flash_fwd_with_lse(q, k, v, causal=True)
    ro, rlse = flash.flash_fwd_reference(
        flash._to_bhsd(q), flash._to_bhsd(k), flash._to_bhsd(v), causal=True)
    assert o.shape == (2, 32, 2, 8) and lse.shape == (2, 2, 32)
    torch.testing.assert_close(o, flash._from_bhsd(ro, 2, 2))
    torch.testing.assert_close(lse, rlse.reshape(2, 2, 32))


def test_kv_valid_start_under_autograd_raises():
    q, k, v = (torch.randn(1, 16, 2, 8, requires_grad=True)
               for _ in range(3))
    with pytest.raises(ValueError, match="forward-only"):
        flash.flash_attention(q, k, v, kv_valid_start=torch.tensor([3]))


def test_block_diag_selects_the_two_pass_forward():
    """flash_attention with block_diag on causal self-attention longer
    than block_k runs the two passes (tests/test_torch_flash_two_pass.py
    holds them to the JAX package); the result is the single pass's."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 4, 64, 64, 8))
    q, k, v = (x.reshape(1, 4, 64, 8).transpose(1, 2) for x in (q, k, v))
    two = flash.flash_attention(q, k, v, block_q=16, block_k=32,
                                block_diag=8)
    want = flash.flash_attention(q, k, v)
    torch.testing.assert_close(two, want, **TOL)
    o, _ = flash.flash_fwd_two_pass(flash._to_bhsd(q), flash._to_bhsd(k),
                                    flash._to_bhsd(v), block_q=16,
                                    block_k=32, block_diag=8)
    torch.testing.assert_close(two, flash._from_bhsd(o, 1, 4), atol=0,
                               rtol=0)
