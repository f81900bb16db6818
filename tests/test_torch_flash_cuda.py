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
# fully masks the early causal rows, and one past the end.
CASES = {
    "causal": (True, 200, 200, None),
    "noncausal_sq_ne_sk": (False, 100, 333, None),
    "causal_masked": (True, 200, 200, [0, 70, 150, 200]),
    "noncausal_masked": (False, 100, 333, [0, 64, 300, 400]),
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
