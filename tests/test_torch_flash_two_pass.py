"""The port's two-pass causal forward against the JAX package's.

``flash_fwd_two_pass`` (on CPU tensors: the plain versions of pass A and
pass B, merged by ``merge_partials``) is held to
``kubeflow_tpu.ops.flash._flash_fwd_two_pass`` in Pallas interpret mode
on the same float32 inputs, at the shapes of the JAX package's own
two-pass tests, the pure-band case among them.  Tolerances (float32,
another summation order): o and lse within atol=rtol=1e-5; gradients
through ``flash_attention(block_diag=...)`` against ``jax.grad`` within
atol 5e-5, as the JAX package holds its own.  The CUDA kernels are held
to the same plain versions by tests/test_torch_flash_two_pass_cuda.py,
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash as jax_flash
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.ops.attention import NEG_INF

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_ATOL = 5e-5

# (s, block_q, block_k, block_diag): tests/test_ops.py's two-pass shapes
# (several full blocks + band, bq == bk, a length that is not a power of
# two, wide key blocks) and the pure band (s <= block_k: no pass A).
SHAPES = [(128, 32, 64, 16), (128, 32, 32, 8), (96, 32, 32, 16),
          (256, 64, 128, 32), (64, 64, 64, 16)]


def _qkv(seed, bh, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, d), np.float32) for _ in range(3)]


@pytest.mark.parametrize("s,bq,bk,bd", SHAPES)
def test_two_pass_matches_pallas(s, bq, bk, bd):
    q, k, v = _qkv(11, 2, s, 32)
    jo, jlse = jax_flash._flash_fwd_two_pass(
        *(jnp.asarray(x) for x in (q, k, v)), block_q=bq, block_k=bk,
        block_diag=bd, interpret=True)
    o, lse = flash.flash_fwd_two_pass(
        *(torch.from_numpy(x) for x in (q, k, v)), block_q=bq, block_k=bk,
        block_diag=bd)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("s,bq,bk,bd", SHAPES)
def test_passes_split_the_causal_keys(s, bq, bk, bd):
    """Pass A and pass B partials merge to the single causal pass, and a
    row with no full block gets the empty partial (o = 0, NEG_INF)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(12, 2, s, 16))
    o_a, lse_a = flash.flash_fwd_full_reference(q, k, v, block_q=bq,
                                                block_k=bk)
    o_b, lse_b = flash.flash_fwd_diag_reference(q, k, v, block_q=bq,
                                                block_k=bk)
    bnd = flash._boundaries(s, flash._fit_block(bq, s),
                            flash._fit_block(bk, s), "cpu")
    empty = bnd == 0
    assert torch.all(o_a[:, empty] == 0)
    assert torch.all(lse_a[:, empty] == NEG_INF)
    assert torch.all(lse_a[:, ~empty] > NEG_INF / 2)
    o, lse = flash.merge_partials(o_a, lse_a, o_b, lse_b)
    ro, rlse = flash.flash_fwd_reference(q, k, v, causal=True)
    torch.testing.assert_close(o, ro, **TOL)
    torch.testing.assert_close(lse, rlse, **TOL)


def test_merge_partials_matches_jax_with_empty_partials():
    rng = np.random.default_rng(13)
    o_a, o_b = (rng.standard_normal((3, 8, 16), np.float32)
                for _ in range(2))
    lse_a, lse_b = (rng.standard_normal((3, 8), np.float32)
                    for _ in range(2))
    # Empty partials: one side, the other side, and both.
    for lse, o, rows in ((lse_a, o_a, [0, 3]), (lse_b, o_b, [1, 3])):
        lse[:, rows] = NEG_INF
        o[:, rows] = 0.0
    jo, jlse = jax_flash.merge_partials(*(jnp.asarray(x) for x in
                                          (o_a, lse_a, o_b, lse_b)))
    o, lse = flash.merge_partials(*(torch.from_numpy(x) for x in
                                    (o_a, lse_a, o_b, lse_b)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    assert torch.all(o[:, 3] == 0) and torch.all(lse[:, 3] == NEG_INF)


@pytest.mark.parametrize("case", ["sq_ne_sk", "sq_le_block_k", "noncausal",
                                  "no_block_diag"])
def test_dispatch_falls_back_to_the_single_pass(case, monkeypatch):
    s, block_k, causal, block_diag = 64, 32, True, 16
    sk = s
    if case == "sq_ne_sk":
        sk = 96
    elif case == "sq_le_block_k":
        block_k = 64
    elif case == "noncausal":
        causal = False
    else:
        block_diag = 0
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.standard_normal((2, s, 16), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, sk, 16), np.float32))
            for _ in range(2))
    taken = []
    two_pass = flash.flash_fwd_two_pass
    monkeypatch.setattr(flash, "flash_fwd_two_pass",
                        lambda *a, **kw: taken.append(1) or two_pass(*a,
                                                                     **kw))
    o, lse = flash._fwd_dispatch(q, k, v, causal, 32, block_k, block_diag)
    ro, rlse = flash.flash_fwd_reference(q, k, v, causal=causal)
    assert taken == []
    torch.testing.assert_close(o, ro, atol=0, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=0, rtol=0)
    # A shape that passes every rule takes the two passes.
    q2, k2, v2 = (torch.from_numpy(x) for x in _qkv(15, 2, 128, 16))
    flash._fwd_dispatch(q2, k2, v2, True, 32, 64, 16)
    assert taken == [1]


def test_flash_attention_two_pass_forward_matches_jax():
    rng = np.random.default_rng(16)
    b, s, h, hkv, d = 1, 128, 4, 2, 16
    q = rng.standard_normal((b, s, h, d), np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d), np.float32)
            for _ in range(2))
    jo = jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=32, block_k=64, block_diag=16, interpret=True)
    with torch.no_grad():
        o = flash.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=True, block_q=32, block_k=64, block_diag=16)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("hkv", [2, 1])
def test_two_pass_gradients_match_jax_grad(hkv):
    """tests/test_ops.py's two-pass gradient case (s 128, bq 32, bk 64,
    block_diag 16, a squared-output loss), with GQA."""
    rng = np.random.default_rng(17)
    b, s, h, d = 1, 128, 2, 16
    arrays = [rng.standard_normal(shape, np.float32) for shape in
              ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]

    def jloss(q, k, v):
        return (jax_flash.flash_attention(
            q, k, v, causal=True, block_q=32, block_k=64, block_diag=16,
            interpret=True) ** 2).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    calls = dict(flash.launch_counts)
    (flash.flash_attention(q, k, v, causal=True, block_q=32, block_k=64,
                           block_diag=16) ** 2).sum().backward()
    assert flash.launch_counts == calls  # CPU: plain versions, no launch
    for got, want in zip((q.grad, k.grad, v.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL, rtol=0)


def test_fit_block_matches_jax():
    for block in (1, 16, 32, 100, 128, 384, 512, 1024, 4096):
        for s in (1, 7, 96, 128, 333, 1000, 1536, 2048):
            assert flash._fit_block(block, s) == jax_flash._fit_block(
                block, s), (block, s)


def test_two_pass_refuses_cross_attention_and_no_band():
    q = torch.zeros(1, 64, 16)
    with pytest.raises(ValueError, match="self-attention"):
        flash.flash_fwd_two_pass(q, torch.zeros(1, 32, 16),
                                 torch.zeros(1, 32, 16), block_q=32,
                                 block_k=32, block_diag=16)
    with pytest.raises(ValueError, match="block_diag"):
        flash.flash_fwd_two_pass(q, q, q, block_q=32, block_k=32,
                                 block_diag=0)
