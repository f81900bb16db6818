"""Ring attention across processes (kubeflow_tpu_torch/parallel/ring.py)
against the JAX package's ``make_ring_attention`` on fake CPU devices and
against attention on the whole sequence in one process.

The port's ranks are JAX-free subprocesses, one per ring rank, joined
over gloo (``testing/ring_check.py``, started by ``testing/ranks.py``
with a timeout); the JAX side runs here on the devices tests/conftest.py
sets up.  One job per ring size runs every case, and each check below
reads its results.  Cases, float32 at b 1, s 32, head_dim 16: causal
and non-causal with 4 query heads on 4 kv heads, and causal GQA with 4
query heads on 2 kv heads.  o, dq, dk and dv within atol=rtol=1e-5 of
JAX and of ``flash_attention`` on the whole sequence; the plain
versions' calls summed over the ranks are the live hops, R (R + 1) / 2
of each of the forward and the backward per causal ring (R of them on
the diagonal, the rest full), R * R unmasked per non-causal one.

The twin of JAX's ``test_mixed_mesh_dp_sp_tp``: ``make_ring_attention``
over a mesh of data=2, sequence=2, tensor=2 (8 ranks), batch, sequence
and heads all split at once, at b 4, s 16, 4 query heads of 8 on 4 kv
heads and on 2 (GQA: one kv head a tensor rank), causal: o, dq, dk and
dv within 2e-5 of the JAX ring on the same mesh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel import MeshSpec as JaxMeshSpec
from kubeflow_tpu.parallel.ring import make_ring_attention as jax_ring
from kubeflow_tpu_torch.ops.flash import flash_attention
from kubeflow_tpu_torch.parallel.ring import ring_attention
from kubeflow_tpu_torch.testing import ring_check

TOL = dict(atol=1e-5, rtol=1e-5)
B, S, D = 1, 32, 16
CASES = {"causal": (4, 4, True), "full": (4, 4, False),
         "gqa": (4, 2, True)}
RINGS = (2, 4)
JOB_TIMEOUT_S = 120


def _inputs(h, hkv, seed):
    rng = np.random.RandomState(seed)
    return {"q": rng.randn(B, S, h, D).astype(np.float32),
            "k": rng.randn(B, S, hkv, D).astype(np.float32),
            "v": rng.randn(B, S, hkv, D).astype(np.float32),
            "g": rng.randn(B, S, h, D).astype(np.float32)}


def _numpy_cases():
    return {name: dict(_inputs(h, hkv, i), causal=causal)
            for i, (name, (h, hkv, causal)) in enumerate(CASES.items())}


MIXED_MESH = dict(data=2, sequence=2, tensor=2)
MIXED = {"mha": (4, 4), "gqa": (4, 2)}


def _mixed_cases():
    out = {}
    for i, (name, (h, hkv)) in enumerate(MIXED.items()):
        rng = np.random.RandomState(10 + i)
        out[name] = {"q": rng.randn(4, 16, h, 8).astype(np.float32),
                     "k": rng.randn(4, 16, hkv, 8).astype(np.float32),
                     "v": rng.randn(4, 16, hkv, 8).astype(np.float32),
                     "g": rng.randn(4, 16, h, 8).astype(np.float32),
                     "causal": True}
    return out


@pytest.fixture(scope="module")
def mixed_job(tmp_path_factory):
    cases = {name: {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                        else v) for k, v in case.items()}
             for name, case in _mixed_cases().items()}
    return ring_check.run_job(tmp_path_factory.mktemp("ring_mixed"), cases,
                              8, "cpu", timeout_s=JOB_TIMEOUT_S, threads=1,
                              mesh=MIXED_MESH)


@pytest.mark.parametrize("case", list(MIXED))
def test_mixed_mesh_dp_sp_tp(mixed_job, case):
    """Batch, sequence and heads split at once: each rank's ring runs its
    heads around its sequence group (the ranks of its data and tensor
    index), and the joined shards are the JAX ring's."""
    c = _mixed_cases()[case]
    mesh = JaxMeshSpec(**MIXED_MESH).build(jax.devices())
    o, vjp = jax.vjp(jax.jit(jax_ring(mesh, causal=True)),
                     *(jnp.asarray(c[x]) for x in "qkv"))
    want = [np.asarray(t) for t in (o, *vjp(jnp.asarray(c["g"])))]
    for key, ref in zip(("o", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(_gathered(mixed_job, case, key), ref,
                                   err_msg=key, atol=2e-5)
    for r in mixed_job:
        assert r[case]["o"].shape == (2, 8, MIXED[case][0] // 2, 8)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each ring size run once over every case: n -> its ranks' results."""
    cases = {name: {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                        else v) for k, v in case.items()}
             for name, case in _numpy_cases().items()}
    return {n: ring_check.run_job(tmp_path_factory.mktemp(f"ring{n}"),
                                  cases, n, "cpu",
                                  timeout_s=JOB_TIMEOUT_S, threads=1)
            for n in RINGS}


def _gathered(results, case, key):
    return ring_check.gathered(results, case, key).numpy()


def _jax_reference(n, case):
    c = _numpy_cases()[case]
    mesh = JaxMeshSpec(data=1, sequence=n).build(jax.devices()[:n])
    fn = jax_ring(mesh, causal=c["causal"])
    o, vjp = jax.vjp(fn, *(jnp.asarray(c[x]) for x in "qkv"))
    return [np.asarray(t) for t in (o, *vjp(jnp.asarray(c["g"])))]


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_jax_ring(jobs, n, case):
    want = _jax_reference(n, case)
    for key, ref in zip(("o", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(_gathered(jobs[n], case, key), ref,
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_whole_sequence(jobs, n, case):
    c = _numpy_cases()[case]
    want = ring_check.whole_sequence(
        *(torch.from_numpy(c[x]) for x in "qkvg"), c["causal"])
    for key, ref in zip(("o", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(_gathered(jobs[n], case, key),
                                   ref.numpy(), err_msg=key, **TOL)


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("case", list(CASES))
def test_live_hops_per_class(jobs, n, case):
    calls = ring_check.totals(jobs[n], case, "plain_calls")
    if CASES[case][2]:
        diag, full = n, n * (n - 1) // 2
    else:
        diag, full = 0, n * n
    assert calls == {"fwd_causal": diag, "fwd_full": full,
                     "bwd_causal": diag, "bwd_full": full}
    # No kernel ran: the ranks held CPU tensors.
    assert not any(sum(r[case]["launches"].values()) for r in jobs[n])


def test_reference_f32_matches_whole_sequence():
    """The chunked float32 reference the card holds the ring to, against
    the plain attention on the whole sequence (chunks of 8 rows)."""
    c = _numpy_cases()["gqa"]
    args = [torch.from_numpy(c[x]) for x in "qkvg"]
    want = ring_check.whole_sequence(*args, True)
    got = ring_check.reference_f32(*args, True, chunk=8)
    for key, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=key, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_world_one_ring_is_flash_attention(case):
    """Without a process group the ring has one rank: its one hop is the
    diagonal (or, non-causal, the full block), which is flash_attention."""
    c = _numpy_cases()[case]
    outs = []
    for fn in (functools.partial(ring_attention, causal=c["causal"]),
               functools.partial(flash_attention, causal=c["causal"])):
        q, k, v = (torch.from_numpy(c[x]).requires_grad_() for x in "qkv")
        o = fn(q, k, v)
        o.backward(torch.from_numpy(c["g"]))
        outs.append([o.detach(), q.grad, k.grad, v.grad])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
