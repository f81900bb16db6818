"""The CUDA flash backward kernels against their plain version, on an
NVIDIA GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_flash_bwd_cuda.py

Elsewhere every test skips.  Tolerance (bf16 inputs, plain version in
float32 on the same inputs, so it rounds neither ds nor p to bf16): each
of dq, dk, dv within 2e-2 in relative Frobenius norm, which holds the
many small entries of long rows, and elementwise within atol 5e-2 +
rtol 5e-2: the kernels round ds and p to bf16 before their products
(relative error 2^-9 per term) and write bf16 (2^-9 again), and an entry
sums up to s terms whose rounding errors do not cancel.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import flash

# (causal, sq, sk, NEG_INF lse rows): lengths that are not tile
# multiples, sq != sk in the causal frame of the JAX kernels, and rows
# whose lse is the sentinel (a row with no valid key: p = 0).
CASES = {
    "causal": (True, 200, 200, False),
    "causal_sq_ne_sk": (True, 130, 333, False),
    "noncausal_sq_ne_sk": (False, 100, 333, False),
    "noncausal_neg_inf_rows": (False, 150, 90, True),
}
REL_TOL = 2e-2
ELEM_TOL = dict(atol=5e-2, rtol=5e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, bh, sq, sk, d, neg_inf_rows, seed=11):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, n, d), np.float32))
               .to(device, torch.bfloat16) for n in (sq, sk, sk))
    g = torch.from_numpy(rng.standard_normal((bh, sq, d), np.float32)).to(
        device, torch.bfloat16)
    return q, k, v, g


def _assert_close(got, want, name):
    assert torch.isfinite(got).all(), name
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= REL_TOL, (name, rel)
    torch.testing.assert_close(got.float(), want.float(), **ELEM_TOL,
                               msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [64, 128])
def test_kernels_match_reference(cuda_device, case, d):
    causal, sq, sk, neg_inf_rows = CASES[case]
    q, k, v, g = _inputs(cuda_device, 4, sq, sk, d, neg_inf_rows)
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    if neg_inf_rows:
        lse[1, ::3] = flash.NEG_INF
        lse[3] = flash.NEG_INF
    delta = (g.float() * o.float()).sum(-1)
    before = dict(flash.launch_counts)
    dq, dk, dv = flash.flash_bwd(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert flash.launch_counts["flash_dq"] == before["flash_dq"] + 1
    assert flash.launch_counts["flash_dkv"] == before["flash_dkv"] + 1
    ref = flash.flash_bwd_reference(q.float(), k.float(), v.float(),
                                    g.float(), lse, delta, causal=causal)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        _assert_close(got, want, name)
    if neg_inf_rows:
        assert torch.all(dq[3] == 0) and torch.all(dk[3] == 0)


@pytest.mark.cuda
def test_kernels_are_deterministic(cuda_device):
    q, k, v, g = _inputs(cuda_device, 8, 300, 300, 128, False)
    o, lse = flash.flash_fwd(q, k, v, causal=True)
    delta = (g.float() * o.float()).sum(-1)
    first = flash.flash_bwd(q, k, v, g, lse, delta, causal=True)
    second = flash.flash_bwd(q, k, v, g, lse, delta, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hkv", [4, 2])
def test_autograd_matches_plain_path(cuda_device, hkv):
    """flash_attention(...).backward on the card (forward, dq and dkv
    kernels) against the same call with the plain versions swapped in,
    GQA included."""
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 160, 4, 64
    arrays = [rng.standard_normal(shape, np.float32) for shape in
              ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))]

    def grads():
        q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   .requires_grad_() for a in arrays[:3])
        out = flash.flash_attention(q, k, v, causal=True)
        out.backward(torch.from_numpy(arrays[3]).to(cuda_device,
                                                    torch.bfloat16))
        return q.grad, k.grad, v.grad

    before = dict(flash.launch_counts)
    through_kernels = grads()
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert flash.launch_counts[name] == before[name] + 1, name
    kernels = flash._flash_fwd_cuda, flash._flash_bwd_cuda
    flash._flash_fwd_cuda = lambda q, k, v, *, causal, kv_start=None: (
        flash.flash_fwd_reference(q, k, v, causal=causal, kv_start=kv_start))
    flash._flash_bwd_cuda = flash.flash_bwd_reference
    try:
        through_plain = grads()
    finally:
        flash._flash_fwd_cuda, flash._flash_bwd_cuda = kernels
    for name, got, want in zip(("dq", "dk", "dv"), through_kernels,
                               through_plain):
        _assert_close(got, want, name)
