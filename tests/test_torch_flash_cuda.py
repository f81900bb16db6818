"""The CUDA flash kernel against its plain version, on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_flash_cuda.py

Elsewhere every test skips.  Tolerance (bf16 inputs, plain version in
float32 on the same inputs): o within atol=rtol=2e-2 elementwise (bf16
rounding of p and of the output) and within 1e-2 in relative Frobenius
norm, which holds the many small outputs of long rows; lse within
atol=2e-3.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import flash

# (causal, sq, sk, kv_start per row or None): lengths that are not tile
# multiples, sq != sk, a start past the first 64-key tile, one that
# fully masks the early causal rows, and one past the end.  Then the
# kernel's 128-row / 128-key tiles: lengths below one tile and one past
# a tile, phase 2's 1000 and 777, and key starts inside a 128-key tile.
CASES = {
    "causal": (True, 200, 200, None),
    "noncausal_sq_ne_sk": (False, 100, 333, None),
    "causal_masked": (True, 200, 200, [0, 70, 150, 200]),
    "noncausal_masked": (False, 100, 333, [0, 64, 300, 400]),
    "causal_below_one_tile": (True, 100, 100, None),
    "causal_one_past_a_tile": (True, 129, 129, None),
    "noncausal_one_past_tiles": (False, 129, 257, None),
    "causal_1000": (True, 1000, 1000, None),
    "causal_masked_777": (True, 777, 777, [0, 63, 200, 777]),
    "causal_kv_start_inside_a_tile": (True, 300, 300, [129, 200, 255, 1]),
    "noncausal_kv_start_inside_a_tile": (False, 129, 300, [130, 191, 0, 257]),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_matches_reference(cuda_device, case, d):
    causal, sq, sk, starts = CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, n, d), np.float32))
               .to(cuda_device, torch.bfloat16) for n in (sq, sk, sk))
    start = None if starts is None else torch.tensor(
        starts, dtype=torch.int32, device=cuda_device)
    before = dict(flash.launch_counts)
    o, lse = flash.flash_fwd(q, k, v, causal=causal, kv_start=start)
    torch.cuda.synchronize()
    key = "flash_fwd" if start is None else "flash_fwd_masked"
    assert flash.launch_counts[key] == before[key] + 1
    ro, rlse = flash.flash_fwd_reference(q.float(), k.float(), v.float(),
                                         causal=causal, kv_start=start)
    torch.testing.assert_close(o.float(), ro, atol=2e-2, rtol=2e-2)
    assert (o.float() - ro).norm() <= 1e-2 * ro.norm()
    torch.testing.assert_close(lse, rlse, atol=2e-3, rtol=0)


def _inputs(device, shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(device, torch.bfloat16) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_tiles_past_a_heads_end_read_no_other_head(cuda_device, causal):
    # Every head of its own magnitude and a length that ends inside a tile:
    # a tile that read the next head's rows (instead of the zeros the
    # kernel's per-head loads fill in) would show in o and lse.
    bh, s, d = 6, 200, 128
    q, k, v = _inputs(cuda_device, (bh, s, d), seed=9)
    mag = torch.arange(1, bh + 1, device=cuda_device,
                       dtype=torch.float32)[:, None, None]
    k = (k.float() * (1 + mag / 4)).bfloat16()
    v = (v.float() * (1 + mag / 2)).bfloat16()
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ro, rlse = flash.flash_fwd_reference(q.float(), k.float(), v.float(),
                                         causal=causal)
    for h in range(bh):
        torch.testing.assert_close(o[h].float(), ro[h], atol=2e-2, rtol=2e-2,
                                   msg=f"head {h}")
        assert (o[h].float() - ro[h]).norm() <= 1e-2 * ro[h].norm(), h
        torch.testing.assert_close(lse[h], rlse[h], atol=2e-3, rtol=0,
                                   msg=f"head {h}")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_single_pass_is_deterministic(cuda_device, causal):
    q, k, v = _inputs(cuda_device, (8, 1000, 128), seed=23)
    start = torch.tensor([0, 5, 130, 999] * 2, dtype=torch.int32,
                         device=cuda_device)
    for kv_start in (None, start):
        first = flash.flash_fwd(q, k, v, causal=causal, kv_start=kv_start)
        second = flash.flash_fwd(q, k, v, causal=causal, kv_start=kv_start)
        for a, b in zip(first, second):
            assert torch.equal(a, b)
