"""The fused trainer (runtime/hfta.py) on an NVIDIA GPU: the flash kernels
folded over the member axis, and a fused member against its solo run.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_hfta_cuda.py

Elsewhere every test skips.  Tolerances:

  - the folded kernels (one launch for every member, bf16 inputs)
    against a per-member loop of the plain versions in float32 on the
    same inputs: o within atol=rtol=2e-2 and 1e-2 in relative Frobenius
    norm, lse within 2e-3, dq, dk and dv within 2e-2 in relative
    Frobenius norm and elementwise within atol=rtol=5e-2: the bounds of
    tests/test_torch_flash_cuda.py and tests/test_torch_flash_bwd_cuda.py
    (bf16 rounding of p, ds and the outputs);
  - a fused bf16 step against a solo Trainer step on the same weights and
    batch: loss within 1e-3 and grad_norm within 1e-3 relative.  Read on
    an NVIDIA H100 80GB HBM3 at 700 W: losses within 1e-6, grad_norm
    equal to 7 digits (the batched products round as the solo ones do);
    the bounds leave room for a GEMM algorithm that rounds the bf16
    activations otherwise, where a member mixed up with another moves
    them by O(1).  chip_smoke.py phase 7e holds the full-size gradients.
"""

import numpy as np
import pytest
import torch
from torch.func import vmap

from kubeflow_tpu_torch.models.transformer import TransformerConfig, lm_task
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.runtime import optim
from kubeflow_tpu_torch.runtime.hfta import FusedTrainer, MemberSpec
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer

O_TOL = dict(atol=2e-2, rtol=2e-2)
O_REL_TOL, LSE_ATOL = 1e-2, 2e-3
BWD_REL_TOL = 2e-2
BWD_ELEM_TOL = dict(atol=5e-2, rtol=5e-2)
LOSS_ATOL, GRAD_NORM_REL_TOL = 1e-3, 1e-3
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
CFG = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
           d_ff=256, head_dim=64, max_seq_len=256, dtype=torch.bfloat16,
           attention="flash", remat=True)
BATCH, SEQ = 2, 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _members(n=3):
    return [MemberSpec(name=f"m{i}", seed=i, lr=1e-3 * (i + 1))
            for i in range(n)]


def _data():
    rng = np.random.default_rng(0)
    while True:
        yield {"tokens": rng.integers(0, CFG["vocab_size"], (BATCH, SEQ),
                                      dtype=np.int32)}


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.cuda
def test_fused_step_launches_each_kernel_once_per_layer(cuda_device):
    init_fn, loss_fn = lm_task(TransformerConfig(**CFG), device="cuda")
    ft = FusedTrainer(init_fn=init_fn, loss_fn=loss_fn, members=_members(),
                      device="cuda",
                      metrics=MetricsLogger(stream=open("/dev/null", "w")))
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    ft.fit(_data(), 2, log_every=1)
    torch.cuda.synchronize()
    want = CFG["n_layers"] * 2
    assert {k: flash.launch_counts[k] for k in KERNELS} == \
        {k: want for k in KERNELS}
    assert all(np.isfinite(v) for v in ft.last_metrics.values())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kv_mapped", [True, False])
def test_folded_kernels_match_the_plain_versions(cuda_device, d, kv_mapped):
    """vmap over 3 members of 8 rows each at s = 300 (no tile multiple),
    k and v per member or shared: one launch of each kernel on bh = 24
    rows, each member's o, lse and gradients held to the plain
    versions."""
    m, b, s, h = 3, 2, 300, 4
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape):
        return torch.randn(shape, device="cuda", generator=gen).bfloat16()

    q = rand(m, b * h, s, d).requires_grad_()
    kv_shape = ((m,) if kv_mapped else ()) + (b * h, s, d)
    k, v = rand(*kv_shape).requires_grad_(), rand(*kv_shape).requires_grad_()
    g = rand(m, b * h, s, d)
    before = dict(flash.launch_counts)
    kv_dim = 0 if kv_mapped else None
    o, lse = vmap(lambda a, c, e: flash._FlashFunction.apply(
        a, c, e, True, 512, 512, 0), in_dims=(0, kv_dim, kv_dim))(q, k, v)
    o.backward(g)
    torch.cuda.synchronize()
    assert {n: flash.launch_counts[n] - before[n] for n in KERNELS} == \
        {n: 1 for n in KERNELS}
    refs = []
    for i in range(m):
        ki, vi = (t[i] if kv_mapped else t for t in (k, v))
        qi, ki, vi = q[i].detach(), ki.detach(), vi.detach()
        ro, rlse = flash.flash_fwd_reference(qi.float(), ki.float(),
                                             vi.float(), causal=True)
        torch.testing.assert_close(o[i].detach().float(), ro, **O_TOL)
        assert _rel(o[i].detach(), ro) <= O_REL_TOL
        torch.testing.assert_close(lse[i], rlse, atol=LSE_ATOL, rtol=0)
        # The backward kernels' plain version on the kernel's own o, lse.
        delta = (g[i].float() * o[i].detach().float()).sum(-1)
        refs.append(flash.flash_bwd_reference(qi, ki, vi, g[i],
                                              lse[i].detach(), delta,
                                              causal=True))
    dq, dk, dv = (torch.stack([r[j].float() for r in refs])
                  for j in range(3))
    if not kv_mapped:
        # Shared k and v: their gradients are the members' summed.
        dk, dv = dk.sum(0), dv.sum(0)
    for name, got, want in (("dq", q.grad, dq), ("dk", k.grad, dk),
                            ("dv", v.grad, dv)):
        assert _rel(got, want) <= BWD_REL_TOL, name
        torch.testing.assert_close(got.float(), want, **BWD_ELEM_TOL,
                                   msg=name)


@pytest.mark.cuda
def test_fused_member_matches_its_solo_trainer(cuda_device):
    init_fn, loss_fn = lm_task(TransformerConfig(**CFG), device="cuda")
    members = _members()
    ft = FusedTrainer(init_fn=init_fn, loss_fn=loss_fn, members=members,
                      device="cuda",
                      metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = ft._stack_members([ft.create_member_state(m) for m in members])
    batch = ft.shard_batch(next(_data()))
    _, _, fused = ft.compile_step()(
        state, torch.ones(3, dtype=torch.bool, device="cuda"),
        torch.full((3,), 10, device="cuda"), batch)
    for i, m in enumerate(members):
        solo = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                       tx=optim.default_tx_factory(m.lr), device="cuda",
                       metrics=MetricsLogger(stream=open("/dev/null", "w")))
        _, metrics = solo.compile_step()(solo.create_state(m.seed), batch)
        loss, gn = fused["loss"][i].item(), fused["grad_norm"][i].item()
        print(f"m{i}: fused loss {loss:.6f} solo {metrics['loss'].item():.6f}"
              f"; grad_norm {gn:.6f} solo {metrics['grad_norm'].item():.6f}")
        assert abs(loss - metrics["loss"].item()) <= LOSS_ATOL
        assert abs(gn - metrics["grad_norm"].item()) <= \
            GRAD_NORM_REL_TOL * metrics["grad_norm"].item()
