"""The port's dot_product_attention against the JAX package's, under
every mask kind it takes (float32, atol=rtol=1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention,
)
from kubeflow_tpu_torch.ops.attention import dot_product_attention

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)

# name -> (q_len, k_len, kv heads, kwargs from an rng)
CASES = {
    "causal": (12, 12, 4, lambda rng: dict(causal=True)),
    "noncausal": (12, 12, 4, lambda rng: dict(causal=False)),
    "gqa_causal": (12, 12, 2, lambda rng: dict(causal=True)),
    "decode_offset": (1, 10, 2, lambda rng: dict(causal=True, kv_offset=9)),
    "chunk_offset": (3, 10, 4, lambda rng: dict(causal=True, kv_offset=5)),
    "per_row_offset": (3, 10, 2, lambda rng: dict(
        causal=True, kv_offset=np.asarray([2, 7], np.int32))),
    "per_row_offset_valid_start": (1, 10, 2, lambda rng: dict(
        causal=True, kv_offset=np.asarray([4, 9], np.int32),
        kv_valid_start=np.asarray([1, 3], np.int32))),
    "kv_valid_start": (12, 12, 4, lambda rng: dict(
        causal=True, kv_valid_start=np.asarray([0, 5], np.int32))),
    "decode_offset_valid_start": (1, 10, 2, lambda rng: dict(
        causal=True, kv_offset=9,
        kv_valid_start=np.asarray([2, 7], np.int32))),
    "segments": (12, 12, 4, lambda rng: dict(
        causal=True,
        segment_ids=np.sort(rng.integers(0, 3, (2, 12)), axis=1))),
    "segments_noncausal_valid_start": (12, 12, 2, lambda rng: dict(
        causal=False, kv_valid_start=np.asarray([1, 4], np.int32),
        segment_ids=np.sort(rng.integers(0, 2, (2, 12)), axis=1))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case):
    q_len, k_len, hkv, build = CASES[case]
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, q_len, 4, 8), np.float32)
    k = rng.standard_normal((2, k_len, hkv, 8), np.float32)
    v = rng.standard_normal((2, k_len, hkv, 8), np.float32)
    kwargs = build(rng)
    jax_kwargs = {key: jnp.asarray(val) if isinstance(val, np.ndarray)
                  else val for key, val in kwargs.items()}
    torch_kwargs = {key: torch.from_numpy(val)
                    if isinstance(val, np.ndarray) else val
                    for key, val in kwargs.items()}
    want = jax_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jax_kwargs)
    got = dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **torch_kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_per_row_offset_not_ported_raises():
    """The per-row [b] offset, once refused here, is now ported: each
    row attends as it would alone at its own scalar offset."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 2, 8, generator=gen)
    k = torch.randn(2, 6, 2, 8, generator=gen)
    got = dot_product_attention(q, k, k, kv_offset=torch.tensor([3, 4]))
    for row, off in enumerate((3, 4)):
        want = dot_product_attention(q[row:row + 1], k[row:row + 1],
                                     k[row:row + 1], kv_offset=off)
        torch.testing.assert_close(got[row:row + 1], want, **TOL)
