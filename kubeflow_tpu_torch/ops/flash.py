"""Flash attention forward: the port of kubeflow_tpu/ops/flash.py.

One single-pass online-softmax forward over ``[bh, s, d]`` inputs that
returns ``(o, lse)`` with ``lse = m + log(l)``.  On a CUDA tensor it runs
the hand-written Hopper kernel in ``csrc/flash_fwd.cu`` (built at first use
by ``ops/_build.py``) or raises; nothing falls back to a plain path there.
On a CPU tensor it runs ``flash_fwd_reference``, the plain PyTorch version
of the kernel's contract, which the tests hold against the JAX kernel and
``chip_smoke.py`` holds the CUDA kernel against.

The kernel contract (shared with the JAX package's Pallas forward):
  - scores are float32, from dots of the input dtype;
  - masked scores take ``NEG_INF = finfo(float32).min``, and p is zeroed
    wherever a score sits at that sentinel, so a row whose keys are all
    masked so far never gives weight exp(0) = 1 to a pad;
  - a row with no valid key at all gets ``o = 0`` and ``lse = NEG_INF``.

Forward only: the backward kernels and the two-pass (``block_diag``)
forward belong to the training slice of the port (ROADMAP queue 1,
item 4; queue 2, items 3-6).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import NEG_INF, dot_product_attention

# Launches of the CUDA kernel by variant, counted where the wrapper
# launches it and nowhere else.  chip_smoke.py zeroes and reads them to
# show that the serving path went through the kernel.
launch_counts: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_masked": 0}
_count_lock = threading.Lock()

KERNEL_HEAD_DIMS = (64, 128)


def repeat_kv(k: torch.Tensor, v: torch.Tensor, h: int):
    """Broadcast kv heads ([b, s, hkv, d]) up to ``h`` query heads (GQA)."""
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    return k, v


def _to_bhsd(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_bhsd(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def flash_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool, kv_start: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: q [bh, sq, d], k/v [bh, sk, d]
    -> (o [bh, sq, d] in q's dtype, lse [bh, sq] float32).

    kv_start ([bh] int32, optional): first valid key of each row.  The
    [bh, sq, sk] scores are materialized, so this is for tests, CPU runs
    and the on-card comparison, not for speed.
    """
    bh, sq, d = q.shape
    sk = k.shape[1]
    # Products of bf16 values are exact in float32: upcasting first is
    # the kernel's bf16 dot with float32 accumulation.
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    k_pos = torch.arange(sk, device=q.device)
    keep = None
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= k_pos[None, :])[None]
    if kv_start is not None:
        valid = (k_pos[None, :]
                 >= kv_start.to(q.device, torch.int64)[:, None])[:, None, :]
        keep = valid if keep is None else keep & valid
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s > NEG_INF / 2, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float()) / safe
    lse = torch.where(l == 0.0, torch.full_like(l, NEG_INF),
                      m + torch.log(safe))
    return o.to(q.dtype), lse[..., 0]


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    fn = lib.kft_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.kft_cuda_error_string.argtypes = [ctypes.c_int]
        lib.kft_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool, kv_start: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel; raise on anything it does not take."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_fwd kernel takes bfloat16, {name} is "
                            f"{t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [bh, s, d] "
                             f"tensor, got shape {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel has no instance for head_dim "
                         f"{d} (built for {KERNEL_HEAD_DIMS})")
    if bh > 65535:
        raise ValueError(f"batch*heads {bh} exceeds the kernel grid's 65535")
    if kv_start is not None:
        if (kv_start.dtype != torch.int32 or kv_start.shape != (bh,)
                or kv_start.device != q.device
                or not kv_start.is_contiguous()):
            raise ValueError("kv_start must be a contiguous int32 [bh] "
                             "tensor on q's device")
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh == 0 or sq == 0:
        return o, lse
    lib = _lib()
    # The launch goes to the calling thread's current device.
    with torch.cuda.device(q.device):
        err = lib.kft_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_start is None else kv_start.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, sq, sk, d, int(causal),
            d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_fwd kernel launch failed: "
                           + lib.kft_cuda_error_string(err).decode())
    with _count_lock:
        launch_counts["flash_fwd" if kv_start is None
                      else "flash_fwd_masked"] += 1
    return o, lse


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool, kv_start: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[bh, s, d] forward -> (o, lse): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal=causal, kv_start=kv_start)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, kv_start=kv_start)
    raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")


def flash_fwd_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool, block_q: int = 512, block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-differentiable forward returning (o [b,s,h,d], lse [b,h,s]).

    block_q/block_k are accepted for signature parity and unused: the
    CUDA kernel picks its own tiles.
    """
    del block_q, block_k
    b, sq, h, d = q.shape
    k, v = repeat_kv(k, v, h)
    o, lse = flash_fwd(_to_bhsd(q), _to_bhsd(k), _to_bhsd(v), causal=causal)
    return _from_bhsd(o, b, h), lse.reshape(b, h, sq)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    block_q: int = 512,
    block_k: int = 512,
    block_diag: int = 0,
    kv_valid_start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention with the ops/attention.py [b, s, h, d] signature.

    GQA repeats kv heads before the kernel.  Segment masking is not in
    the kernel: segmented calls take ``dot_product_attention``, as in the
    JAX package.  ``kv_valid_start`` ([b] int, optional) is each row's
    first valid key (left-padded prompts); it is forward-only and raises
    under autograd.  block_q/block_k are kept for parity with the JAX
    config and unused: the CUDA kernel picks its own tiles.
    """
    del block_q, block_k
    if block_diag > 0:
        raise NotPortedError(
            "block_diag > 0 (the two-pass causal forward, kernels "
            "_flash_fwd_full_kernel/_flash_fwd_diag_kernel) is not ported "
            "yet: ROADMAP queue 2, items 3-4")
    if segment_ids is not None:
        return dot_product_attention(
            q, k, v, causal=causal, segment_ids=segment_ids,
            kv_valid_start=kv_valid_start)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if needs_grad:
        if kv_valid_start is not None:
            raise ValueError(
                "flash_attention with kv_valid_start is forward-only "
                "(inference prefill); it cannot be differentiated")
        if q.device.type == "cuda":
            raise NotPortedError(
                "the flash backward kernels (_flash_dq_kernel, "
                "_flash_dkv_kernel) are not ported yet: ROADMAP queue 2, "
                "items 5-6")
    b, sq, h, d = q.shape
    k, v = repeat_kv(k, v, h)
    start = None
    if kv_valid_start is not None:
        start = kv_valid_start.to(q.device, torch.int32).repeat_interleave(h)
    out, _ = flash_fwd(_to_bhsd(q), _to_bhsd(k), _to_bhsd(v),
                       causal=causal, kv_start=start)
    return _from_bhsd(out, b, h)
