"""The flash wrapper under ``torch.func.vmap``: ``_FlashFunction``'s vmap
rule, which folds the mapped (member) axis into bh so that one forward
and one backward call serve every member (ops/flash.py).

On the CPU the folded call runs the plain versions, so these tests hold
the rule that the card's kernels run under.  References, float32:

  - a per-member loop of ``flash_fwd_reference`` (``flash_fwd_two_pass``
    for the two-pass route) and ``flash_bwd_reference``, the GQA head
    groups summed by hand: o and every gradient within atol=rtol=1e-6
    (the same plain arithmetic on folded rows);
  - ``jax.vmap`` of the JAX package's ``flash_attention`` in Pallas
    interpret mode (a batched ``pallas_call``): o and gradients within
    atol=rtol=1e-4, the tolerance of tests/test_torch_flash_bwd.py's
    autograd case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from kubeflow_tpu.ops.flash import flash_attention as jax_flash_attention
from kubeflow_tpu_torch.ops import flash

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
M, B, S, D = 3, 2, 48, 16

# (causal, heads, kv heads, k/v mapped, block_diag): GQA, k and v shared
# by every member (unmapped, as a member-independent input would be), and
# the two-pass forward (block_diag > 0 with s > block_k).
CASES = {
    "causal": (True, 4, 4, True, 0),
    "noncausal": (False, 4, 4, True, 0),
    "gqa": (True, 4, 2, True, 0),
    "kv_unmapped": (True, 4, 4, False, 0),
    "gqa_kv_unmapped": (True, 4, 1, False, 0),
    "two_pass": (True, 4, 2, True, 8),
}
BLOCK_Q, BLOCK_K = 16, 16


def _inputs(seed, h, hkv, kv_mapped):
    rng = np.random.default_rng(seed)
    kv_shape = ((M,) if kv_mapped else ()) + (B, S, hkv, D)
    q = rng.standard_normal((M, B, S, h, D), np.float32)
    k, v = (rng.standard_normal(kv_shape, np.float32) for _ in range(2))
    g = rng.standard_normal((M, B, S, h, D), np.float32)
    return q, k, v, g


def _mapped(q, k, v, g, causal, block_diag, kv_mapped):
    """o [M, b, s, h, d] and the gradients of sum(o * g) by vmap."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))

    def member(q_, k_, v_):
        return flash.flash_attention(q_, k_, v_, causal=causal,
                                     block_q=BLOCK_Q, block_k=BLOCK_K,
                                     block_diag=block_diag)

    kv_dim = 0 if kv_mapped else None
    o = vmap(member, in_dims=(0, kv_dim, kv_dim))(tq, tk, tv)
    (o * torch.from_numpy(g)).sum().backward()
    return o.detach(), tq.grad, tk.grad, tv.grad


def _reference(q, k, v, g, causal, block_diag, kv_mapped):
    """The same by a loop over the members of the plain versions."""
    h, hkv = q.shape[3], k.shape[-2]
    rep = h // hkv
    to_bhsd = flash._to_bhsd
    os, dqs, dks, dvs = [], [], [], []
    for i in range(M):
        km = torch.from_numpy(k[i] if kv_mapped else k)
        vm = torch.from_numpy(v[i] if kv_mapped else v)
        ke, ve = flash.repeat_kv(km, vm, h)
        qb, kb, vb = to_bhsd(torch.from_numpy(q[i])), to_bhsd(ke), \
            to_bhsd(ve)
        if block_diag:
            o, lse = flash.flash_fwd_two_pass(
                qb, kb, vb, block_q=BLOCK_Q, block_k=BLOCK_K,
                block_diag=block_diag)
        else:
            o, lse = flash.flash_fwd_reference(qb, kb, vb, causal=causal)
        gb = to_bhsd(torch.from_numpy(g[i]))
        delta = (gb * o).sum(-1)
        dq, dk, dv = flash.flash_bwd_reference(qb, kb, vb, gb, lse, delta,
                                               causal=causal)

        def heads(x):
            return flash._from_bhsd(x, B, h)

        # repeat_kv's head groups, summed back to the kv heads.
        fold = [heads(t).reshape(B, S, hkv, rep, D).sum(3) for t in (dk, dv)]
        os.append(heads(o))
        dqs.append(heads(dq))
        dks.append(fold[0])
        dvs.append(fold[1])
    stack = torch.stack
    dk, dv = stack(dks), stack(dvs)
    if not kv_mapped:
        dk, dv = dk.sum(0), dv.sum(0)
    return stack(os), stack(dqs), dk, dv


@pytest.mark.parametrize("case", sorted(CASES))
def test_vmap_rule_matches_a_loop_of_the_plain_versions(case):
    causal, h, hkv, kv_mapped, block_diag = CASES[case]
    q, k, v, g = _inputs(5, h, hkv, kv_mapped)
    got = _mapped(q, k, v, g, causal, block_diag, kv_mapped)
    want = _reference(q, k, v, g, causal, block_diag, kv_mapped)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, **TOL, msg=name)


@pytest.mark.parametrize("case", ["causal", "gqa_kv_unmapped"])
def test_vmap_rule_matches_jax_vmap_of_the_pallas_kernels(case):
    causal, h, hkv, kv_mapped, block_diag = CASES[case]
    q, k, v, g = _inputs(7, h, hkv, kv_mapped)
    kv_axis = 0 if kv_mapped else None

    def jax_loss(q_, k_, v_):
        o = jax.vmap(lambda a, b, c: jax_flash_attention(
            a, b, c, causal=causal, block_q=BLOCK_Q, block_k=BLOCK_K,
            interpret=True), in_axes=(0, kv_axis, kv_axis))(q_, k_, v_)
        return jnp.sum(o * g), o

    (_, o_want), grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _mapped(q, k, v, g, causal, block_diag, kv_mapped)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, (o_want, *grads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **JAX_TOL)


@pytest.mark.parametrize("block_diag", [0, 8])
def test_members_fold_into_one_forward_and_one_backward_call(
        block_diag, monkeypatch):
    """One call of each plain version (the kernels' stand-ins) for all
    members, on bh = members x b x h rows: the launch count the card's
    fused step shows per layer."""
    q, k, v, g = _inputs(9, 4, 2, True)
    calls = []
    names = ("flash_fwd", "flash_fwd_full", "flash_fwd_diag", "flash_bwd")
    for name in names:
        real = getattr(flash, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls.append((_name, args[0].shape[0]))
            return _real(*args, **kwargs)

        monkeypatch.setattr(flash, name, spy)
    _mapped(q, k, v, g, True, block_diag, True)
    bh = M * B * 4
    if block_diag:
        want = [("flash_fwd_diag", bh), ("flash_fwd_full", bh),
                ("flash_bwd", bh)]
    else:
        want = [("flash_fwd", bh), ("flash_bwd", bh)]
    assert calls == want


def test_forward_only_branches_raise_under_vmap():
    q, k, v, _ = _inputs(11, 4, 4, True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with torch.no_grad(), pytest.raises(ValueError, match="vmap"):
        vmap(lambda a, b, c: flash.flash_attention(a, b, c))(tq, tk, tv)
    start = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="forward-only"):
        vmap(lambda a, b, c: flash.flash_attention(
            a, b, c, kv_valid_start=start))(tq, tk, tv)
