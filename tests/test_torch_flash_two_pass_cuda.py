"""The CUDA kernels of the two-pass causal forward (pass A: keys before
each row's coarse boundary; pass B: the diagonal band) against their
plain versions, on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_flash_two_pass_cuda.py

Elsewhere every test skips.  Tolerance (bf16 inputs, plain versions in
float32 on the same inputs), as for the single pass: o within
atol=rtol=2e-2 elementwise and 1e-2 in relative Frobenius norm, lse
within atol=2e-3.  The merged result rounds o to bf16 once more than the
single pass and is held to the same bounds.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import flash

O_TOL = dict(atol=2e-2, rtol=2e-2)
O_REL_TOL = 1e-2
LSE_ATOL = 2e-3

# name: (bh, s, block_q, block_k) at chip_smoke.py's shapes: the training
# shape's split (every 128-row tile one aligned boundary: pass A without
# mask code), fitted blocks that are not multiples of 64 (per-row
# bounds), a length that is not a multiple of the tiles, and the pure
# band (s <= block_k: pass A is not launched).  Then fitted blocks that
# are multiples of 64 but not of the kernel's 128-row or 128-key tile,
# which keep the per-row-bounds instances on a tile-cutting split.
CASES = {
    "train_split": (4, 2048, 512, 1024),
    "bq32_bk64": (4, 128, 32, 64),
    "bq_bk32_s96": (4, 96, 32, 32),
    "bq_bk400_s1200": (2, 1200, 400, 400),
    "pure_band": (2, 1024, 512, 1024),
    "bq_bk192_s768": (2, 768, 192, 192),
    "bq64_bk128_s512": (2, 512, 64, 128),
    "bq256_bk320_s1280": (2, 1280, 256, 320),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, bh, s, d, seed=21):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, s, d), np.float32))
            .to(device, torch.bfloat16) for _ in range(3)]


def _assert_close(o, lse, ro, rlse, what):
    assert torch.isfinite(o).all(), what
    torch.testing.assert_close(o.float(), ro, **O_TOL, msg=what)
    assert (o.float() - ro).norm() <= O_REL_TOL * ro.norm(), what
    torch.testing.assert_close(lse, rlse, atol=LSE_ATOL, rtol=0, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [64, 128])
def test_passes_match_their_plain_versions(cuda_device, case, d):
    bh, s, bq, bk = CASES[case]
    q, k, v = _inputs(cuda_device, bh, s, d)
    ref = [x.float() for x in (q, k, v)]
    for name, kernel, plain in (
            ("flash_fwd_full", flash.flash_fwd_full,
             flash.flash_fwd_full_reference),
            ("flash_fwd_diag", flash.flash_fwd_diag,
             flash.flash_fwd_diag_reference)):
        before = flash.launch_counts[name]
        o, lse = kernel(q, k, v, block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        assert flash.launch_counts[name] == before + 1
        _assert_close(o, lse, *plain(*ref, block_q=bq, block_k=bk),
                      f"{name} {case} d={d}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_two_pass_matches_the_single_pass(cuda_device, case):
    bh, s, bq, bk = CASES[case]
    q, k, v = _inputs(cuda_device, bh, s, 128, seed=22)
    before = dict(flash.launch_counts)
    o, lse = flash.flash_fwd_two_pass(q, k, v, block_q=bq, block_k=bk,
                                      block_diag=256)
    torch.cuda.synchronize()
    full = 0 if case == "pure_band" else 1
    assert flash.launch_counts["flash_fwd_full"] == \
        before["flash_fwd_full"] + full
    assert flash.launch_counts["flash_fwd_diag"] == \
        before["flash_fwd_diag"] + 1
    assert flash.launch_counts["flash_fwd"] == before["flash_fwd"]
    ro, rlse = flash.flash_fwd_reference(*(x.float() for x in (q, k, v)),
                                         causal=True)
    _assert_close(o, lse, ro, rlse, case)


@pytest.mark.cuda
def test_dispatch_outside_the_rules_launches_neither_pass(cuda_device):
    q, k, v = _inputs(cuda_device, 2, 512, 64)
    before = dict(flash.launch_counts)
    # sq <= block_k, then sq != sk: the single pass.
    flash._fwd_dispatch(q, k, v, True, 256, 512, 128)
    flash._fwd_dispatch(q[:, :300].contiguous(), k, v, True, 128, 128, 64)
    torch.cuda.synchronize()
    for name in ("flash_fwd_full", "flash_fwd_diag"):
        assert flash.launch_counts[name] == before[name], name
    assert flash.launch_counts["flash_fwd"] == before["flash_fwd"] + 2


@pytest.mark.cuda
def test_passes_are_deterministic(cuda_device):
    q, k, v = _inputs(cuda_device, 8, 1200, 128, seed=23)
    for kernel in (flash.flash_fwd_full, flash.flash_fwd_diag):
        first = kernel(q, k, v, block_q=400, block_k=400)
        second = kernel(q, k, v, block_q=400, block_k=400)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernels_do_not_take(cuda_device):
    q, k, v = _inputs(cuda_device, 2, 128, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        flash.flash_fwd_full(q.float(), k.float(), v.float(), block_q=32,
                             block_k=64)
    with pytest.raises(ValueError, match="self-attention"):
        flash.flash_fwd_diag(q, k[:, :64].contiguous(),
                             v[:, :64].contiguous(), block_q=32, block_k=64)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_fwd_diag(q[..., :32].contiguous(),
                             k[..., :32].contiguous(),
                             v[..., :32].contiguous(), block_q=32,
                             block_k=64)
