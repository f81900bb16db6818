"""The port's flash backward against the JAX Pallas backward kernels.

``flash_bwd_reference`` (the plain version the port runs on CPU tensors)
is held to ``kubeflow_tpu.ops.flash._flash_bwd_bhsd`` (``_flash_dq_kernel``
and ``_flash_dkv_kernel``) in Pallas interpret mode on the same float32
inputs.  Tolerance: dq, dk, dv within atol=rtol=1e-5 (float32, different
summation order).  Then autograd through the port's ``flash_attention``
(``_FlashFunction``, GQA included) is held to ``jax.grad`` of the JAX
``flash_attention`` in interpret mode (the custom_vjp with both Pallas
backward kernels) at atol=rtol=1e-4: float32, and the JAX backward's
inputs come from its own forward kernel.  The CUDA kernels are held to
the same plain version by tests/test_torch_flash_bwd_cuda.py, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.flash import _flash_bwd_bhsd, _flash_fwd_bhsd
from kubeflow_tpu.ops.flash import flash_attention as jax_flash_attention
from kubeflow_tpu.ops.flash import flash_bwd_block as jax_flash_bwd_block
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.ops.attention import NEG_INF

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

# (causal, sq, sk, NEG_INF lse rows).  The Pallas blocks are 32 here, so
# 96 and 64 are whole blocks and 80 / 48 are not multiples of the port's
# 64-row CUDA tile; sq != sk uses the kernels' causal frame (query i sees
# keys <= i).
CASES = {
    "causal": (True, 96, 96, False),
    "causal_unaligned": (True, 80, 80, False),
    "noncausal_sq_ne_sk": (False, 64, 96, False),
    "causal_sq_ne_sk": (True, 64, 96, False),
    "neg_inf_rows": (True, 48, 48, True),
}


def _inputs(seed, bh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, n, d), np.float32)
            for n in (sq, sk, sk, sq)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_kernels(case):
    causal, sq, sk, neg_inf_rows = CASES[case]
    q, k, v, g = _inputs(3, 4, sq, sk, 16)
    _, lse = _flash_fwd_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, block_q=16, block_k=16,
                             interpret=True)
    lse = np.array(lse)
    if neg_inf_rows:
        lse[1, ::5] = NEG_INF  # rows with no valid key: p = 0
        lse[2] = NEG_INF
    delta = np.random.default_rng(4).standard_normal((4, sq)).astype(
        np.float32)
    want = _flash_bwd_bhsd(
        *(jnp.asarray(a) for a in (q, k, v, g, lse, delta)),
        causal=causal, block_q=16, block_k=16, interpret=True)
    got = flash.flash_bwd(*(torch.from_numpy(a) for a in (q, k, v, g)),
                          torch.from_numpy(lse), torch.from_numpy(delta),
                          causal=causal)
    for name, p, j in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)
    if neg_inf_rows:
        assert torch.all(got[0][2] == 0) and torch.all(got[1][2] == 0)


def test_flash_bwd_block_layout_matches_jax():
    rng = np.random.default_rng(8)
    b, s, h, d = 2, 48, 2, 16
    q, k, v, g = (rng.standard_normal((b, s, h, d), np.float32)
                  for _ in range(4))
    lse, delta = (rng.standard_normal((b, h, s)).astype(np.float32) + 3
                  for _ in range(2))
    want = jax_flash_bwd_block(
        *(jnp.asarray(a) for a in (q, k, v, g, lse, delta)), causal=True,
        block_q=16, block_k=16, interpret=True)
    got = flash.flash_bwd_block(
        *(torch.from_numpy(a) for a in (q, k, v, g, lse, delta)),
        causal=True)
    for p, j in zip(got, want):
        assert p.shape == (b, s, h, d)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(hkv, causal):
    """As tests/test_ops.py does for the JAX kernels: gradients of a
    weighted sum of the output, here through both packages."""
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 48, 4, 16
    q = rng.standard_normal((b, s, h, d), np.float32)
    k = rng.standard_normal((b, s, hkv, d), np.float32)
    v = rng.standard_normal((b, s, hkv, d), np.float32)
    w = rng.standard_normal((b, s, h, d), np.float32)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, block_q=16,
                                block_k=16, interpret=True)
        return jnp.sum(o * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    calls = []
    fwd = flash.flash_fwd

    def counting_fwd(*args, **kwargs):
        calls.append(1)
        return fwd(*args, **kwargs)

    flash.flash_fwd = counting_fwd
    try:
        out = flash.flash_attention(tq, tk, tv, causal=causal)
        (out * torch.from_numpy(w)).sum().backward()
    finally:
        flash.flash_fwd = fwd
    assert len(calls) == 1  # the backward reuses the saved (o, lse)
    for name, p, j in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        assert p.grad.shape == j.shape
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j),
                                   err_msg=name, **GRAD_TOL)


def test_backward_takes_delta_from_the_returned_o():
    """delta = rowsum(g * o) from the o the forward returned, in float32,
    and a strided g is made contiguous before the kernel."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 16), np.float32))
               .requires_grad_() for _ in range(3))
    seen = {}
    bwd = flash.flash_bwd

    def spy(q_, k_, v_, g_, lse_, delta_, *, causal):
        seen.update(g=g_, delta=delta_, lse=lse_)
        return bwd(q_, k_, v_, g_, lse_, delta_, causal=causal)

    flash.flash_bwd = spy
    try:
        o, _ = flash._FlashFunction.apply(q, k, v, True)
        g = torch.from_numpy(rng.standard_normal((40, 2, 16), np.float32))
        o.backward(g.transpose(0, 1))  # a strided cotangent
    finally:
        flash.flash_bwd = bwd
    assert seen["g"].is_contiguous()
    torch.testing.assert_close(
        seen["delta"], (g.transpose(0, 1) * o.detach()).sum(-1))
    assert seen["delta"].dtype == torch.float32
