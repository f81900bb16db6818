"""Flash attention: the port of kubeflow_tpu/ops/flash.py.

A single-pass online-softmax forward over ``[bh, s, d]`` inputs that
returns ``(o, lse)`` with ``lse = m + log(l)``; the two-pass causal
forward (``block_diag > 0``: keys before each row's coarse boundary, then
the diagonal band, merged in log space); and the blockwise backward that
recomputes p from lse and returns ``(dq, dk, dv)``.  On a CUDA tensor
each runs hand-written Hopper kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, built at first use by ``ops/_build.py``) or
raises; nothing falls back to a plain path there.  On a CPU tensor each
runs its plain PyTorch version (``flash_fwd_reference``,
``flash_fwd_full_reference``, ``flash_fwd_diag_reference``,
``flash_bwd_reference``), which the tests hold against the JAX kernels
and ``chip_smoke.py`` holds the CUDA kernels against.  ``_FlashFunction``
joins them as the autograd counterpart of the JAX package's
``custom_vjp``.

The kernel contract (shared with the JAX package's Pallas forward):
  - scores are float32, from dots of the input dtype;
  - masked scores take ``NEG_INF = finfo(float32).min``, and p is zeroed
    wherever a score sits at that sentinel, so a row whose keys are all
    masked so far never gives weight exp(0) = 1 to a pad;
  - a row with no valid key at all gets ``o = 0`` and ``lse = NEG_INF``.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import NEG_INF, dot_product_attention

# Launches of each CUDA kernel (the forward by variant), counted where
# the wrapper launches it and nowhere else.  chip_smoke.py zeroes and
# reads them to show that the serving and training paths went through
# the kernels.
launch_counts: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_masked": 0,
                                 "flash_fwd_full": 0, "flash_fwd_diag": 0,
                                 "flash_dq": 0, "flash_dkv": 0}
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
    sq, sk = q.shape[1], k.shape[1]
    k_pos = torch.arange(sk, device=q.device)
    keep = None
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= k_pos[None, :])[None]
    if kv_start is not None:
        valid = (k_pos[None, :]
                 >= kv_start.to(q.device, torch.int64)[:, None])[:, None, :]
        keep = valid if keep is None else keep & valid
    return _attend_reference(q, k, v, keep)


def _attend_reference(q, k, v, keep: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of q against the keys ``keep`` ([bh or 1, sq, sk] bool,
    None = all) allows, with the kernels' NEG_INF contract."""
    d = q.shape[2]
    # Products of bf16 values are exact in float32: upcasting first is
    # the kernel's bf16 dot with float32 accumulation.
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
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


def _check_kernel_inputs(kernel: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, g: Optional[torch.Tensor] = None,
                         **rows: torch.Tensor) -> None:
    """Raise on anything the kernels do not take: contiguous, 16-byte
    aligned bf16 q (and g) [bh, sq, d] and k, v [bh, sk, d] on one device,
    a built head_dim, a grid the card can launch, and contiguous float32
    [bh, sq] row statistics (``rows``: lse, delta)."""
    bh, sq, d = q.shape if q.dim() == 3 else (0, 0, 0)
    named = [("q", q), ("k", k), ("v", v)] + ([] if g is None else [("g", g)])
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} kernel takes bfloat16, {name} is "
                            f"{t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [bh, s, d] "
                             f"tensor, got shape {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d or (
            g is not None and g.shape != q.shape):
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}"
            + ("" if g is None else f", g {tuple(g.shape)}") + " do not match")
    for name, t in rows.items():
        if (t.dtype != torch.float32 or t.shape != (bh, sq)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [bh, sq] "
                             f"= [{bh}, {sq}] tensor on q's device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel has no instance for head_dim "
                         f"{d} (built for {KERNEL_HEAD_DIMS})")
    if bh > 65535:
        raise ValueError(f"batch*heads {bh} exceeds the kernel grid's 65535")


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    fn = lib.kft_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.kft_flash_fwd_pass_bf16.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        lib.kft_flash_fwd_pass_bf16.restype = ctypes.c_int
        lib.kft_cuda_error_string.argtypes = [ctypes.c_int]
        lib.kft_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool, kv_start: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel; raise on anything it does not take."""
    _check_kernel_inputs("flash_fwd", q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
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
    _count("flash_fwd" if kv_start is None else "flash_fwd_masked")
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


# ---------------------------------------------------------------------------
# Two-pass causal forward (block_diag > 0, causal self-attention)
# ---------------------------------------------------------------------------


def _fit_block(block: int, s: int) -> int:
    """Largest usable block size <= ``block`` that divides ``s``: a
    multiple of 128 where one divides, else the gcd (the JAX package's
    ``_fit_block``)."""
    b = min(block, s)
    if s % b == 0:
        return b
    for cand in range(b - b % 128, 0, -128):
        if s % cand == 0:
            return cand
    return math.gcd(s, b)


def _boundaries(s: int, bq: int, bk: int, device) -> torch.Tensor:
    """[s] first key of each row's diagonal band: the query block's start
    snapped down to a key block, ``((r // bq) * bq // bk) * bk``."""
    rows = torch.arange(s, device=device)
    return (rows // bq) * bq // bk * bk


def _two_pass_keep(s: int, bq: int, bk: int, device, band: bool
                   ) -> torch.Tensor:
    """[1, s, s] keys of each row in pass A (before its boundary) or, with
    ``band``, in pass B (from its boundary up to the row)."""
    pos = torch.arange(s, device=device)
    bnd = _boundaries(s, bq, bk, device)[:, None]
    if band:
        keep = (pos[None, :] >= bnd) & (pos[None, :] <= pos[:, None])
    else:
        keep = pos[None, :] < bnd
    return keep[None]


def flash_fwd_full_reference(q, k, v, *, block_q: int, block_k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of pass A (the kernel of ``_flash_fwd_full_kernel``):
    row r attends keys [0, boundary(r)) with no mask, for the blocks
    fitted to s; a row with boundary 0 gets o = 0, lse = NEG_INF."""
    s = q.shape[1]
    keep = _two_pass_keep(s, _fit_block(block_q, s), _fit_block(block_k, s),
                          q.device, band=False)
    return _attend_reference(q, k, v, keep)


def flash_fwd_diag_reference(q, k, v, *, block_q: int, block_k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of pass B (the kernel of ``_flash_fwd_diag_kernel``):
    row r attends keys [boundary(r), r] under the causal mask."""
    s = q.shape[1]
    keep = _two_pass_keep(s, _fit_block(block_q, s), _fit_block(block_k, s),
                          q.device, band=True)
    return _attend_reference(q, k, v, keep)


# Pass numbers of the C interface.
_PASSES = {"flash_fwd_full": 1, "flash_fwd_diag": 2}


def _flash_fwd_pass_cuda(name: str, q, k, v, *, block_q: int, block_k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one pass's Hopper kernel; raise on anything it does not
    take."""
    _check_kernel_inputs(name, q, k, v)
    bh, s, d = q.shape
    if k.shape[1] != s:
        raise ValueError(f"{name} is self-attention: sq {s} != sk "
                         f"{k.shape[1]}")
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    if bh == 0 or s == 0:
        return o, lse
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.kft_flash_fwd_pass_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, s, d, _PASSES[name], _fit_block(block_q, s),
            _fit_block(block_k, s), d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.kft_cuda_error_string(err).decode())
    _count(name)
    return o, lse


def _flash_fwd_pass(name: str, reference, q, k, v, block_q, block_k):
    if q.device.type == "cuda":
        return _flash_fwd_pass_cuda(name, q, k, v, block_q=block_q,
                                    block_k=block_k)
    if q.device.type == "cpu":
        return reference(q, k, v, block_q=block_q, block_k=block_k)
    raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")


def flash_fwd_full(q, k, v, *, block_q: int, block_k: int):
    """Pass A, [bh, s, d] -> (o, lse): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    return _flash_fwd_pass("flash_fwd_full", flash_fwd_full_reference, q, k,
                           v, block_q, block_k)


def flash_fwd_diag(q, k, v, *, block_q: int, block_k: int):
    """Pass B, [bh, s, d] -> (o, lse): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    return _flash_fwd_pass("flash_fwd_diag", flash_fwd_diag_reference, q, k,
                           v, block_q, block_k)


def merge_partials(o_a, lse_a, o_b, lse_b):
    """Exact log-space merge of two normalized attention partials (the
    JAX package's ``merge_partials``): o_* [..., d], lse_* o.shape[:-1];
    an empty partial carries lse = NEG_INF, o = 0.  Computed in float32,
    o returned in o_a's dtype."""
    m = torch.maximum(lse_a, lse_b)
    safe_m = torch.where(m > NEG_INF / 2, m, 0.0)
    wa = torch.where(lse_a > NEG_INF / 2, torch.exp(lse_a - safe_m), 0.0)
    wb = torch.where(lse_b > NEG_INF / 2, torch.exp(lse_b - safe_m), 0.0)
    l = wa + wb
    safe_l = torch.clamp(l, min=1e-37)
    o = (o_a.float() * (wa / safe_l)[..., None]
         + o_b.float() * (wb / safe_l)[..., None])
    lse = torch.where(l > 0.0, safe_m + torch.log(safe_l), NEG_INF)
    return o.to(o_a.dtype), lse


def flash_fwd_two_pass(q, k, v, *, block_q: int, block_k: int,
                       block_diag: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal self-attention forward [bh, s, d] -> (o, lse) by the JAX
    package's two passes: keys before each row's coarse boundary (pass A,
    at the blocks fitted to s), then the diagonal band (pass B), merged
    in log space.  Pass A runs only when some row has a full block; the
    result is then pass B's alone.  ``block_diag`` (> 0) sets the TPU's
    band tiling; pass B's result does not depend on it, and the Hopper
    kernel picks its own tiles."""
    if block_diag <= 0:
        raise ValueError(f"block_diag must be > 0, got {block_diag}")
    s = q.shape[1]
    if k.shape[1] != s:
        raise ValueError(f"the two-pass forward is self-attention: sq {s} "
                         f"!= sk {k.shape[1]}")
    bq, bk = _fit_block(block_q, s), _fit_block(block_k, s)
    o_b, lse_b = flash_fwd_diag(q, k, v, block_q=bq, block_k=bk)
    if ((s // bq - 1) * bq) // bk == 0:
        return o_b, lse_b
    o_a, lse_a = flash_fwd_full(q, k, v, block_q=bq, block_k=bk)
    return merge_partials(o_a, lse_a, o_b, lse_b)


def _fwd_dispatch(q, k, v, causal: bool, block_q: int, block_k: int,
                  block_diag: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single pass or two passes, as the JAX package's ``_fwd_dispatch``:
    two passes need a request (block_diag > 0), causal self-attention
    (sq == sk) and a sequence longer than block_k."""
    if (block_diag and causal and q.shape[1] == k.shape[1]
            and q.shape[1] > block_k):
        return flash_fwd_two_pass(q, k, v, block_q=block_q, block_k=block_k,
                                  block_diag=block_diag)
    return flash_fwd(q, k, v, causal=causal)


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


def _p_and_ds(q, k, v, g, lse, delta, causal):
    """The backward's float32 p = exp(s * scale - lse), forced to 0 where
    lse is the NEG_INF sentinel, with the causal mask as NEG_INF scores,
    and ds = p (dp - delta) scale with dp = g v^T, both [bh, sq, sk]."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~keep[None], NEG_INF)
    lse = lse[..., None]
    finite = lse > NEG_INF / 2
    p = torch.where(finite, torch.exp(s - torch.where(finite, lse, 0.0)),
                    torch.zeros_like(s))
    dp = torch.einsum("bqd,bkd->bqk", g.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_dq_reference(q, k, v, g, lse, delta, *, causal: bool
                       ) -> torch.Tensor:
    """Plain version of the dq kernel: dq = ds k, ds rounded to the
    input dtype first, as the kernel does."""
    _, ds = _p_and_ds(q, k, v, g, lse, delta, causal)
    ds = ds.to(q.dtype).float()
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, g, lse, delta, *, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dkv kernel: dk = ds^T q, dv = p^T g, ds and p
    rounded to the input dtype first, as the kernel does."""
    p, ds = _p_and_ds(q, k, v, g, lse, delta, causal)
    ds = ds.to(q.dtype).float()
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p.to(g.dtype).float(), g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: q, g [bh, sq, d],
    k, v [bh, sk, d], lse, delta [bh, sq] float32 -> (dq, dk, dv) in the
    inputs' dtypes.  The [bh, sq, sk] scores are materialized: for tests,
    CPU runs and the on-card comparison."""
    dq = flash_dq_reference(q, k, v, g, lse, delta, causal=causal)
    return (dq, *flash_dkv_reference(q, k, v, g, lse, delta, causal=causal))


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd")
    if lib.kft_flash_dq_bf16.argtypes is None:
        lib.kft_flash_dq_bf16.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        lib.kft_flash_dq_bf16.restype = ctypes.c_int
        lib.kft_flash_dkv_bf16.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        lib.kft_flash_dkv_bf16.restype = ctypes.c_int
        lib.kft_cuda_error_string.argtypes = [ctypes.c_int]
        lib.kft_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch_bwd(name: str, q, k, v, g, lse, delta, outs, causal: bool
                ) -> None:
    """Check the inputs and launch one backward kernel into ``outs``."""
    _check_kernel_inputs(name, q, k, v, g, lse=lse, delta=delta)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if bh == 0 or sq == 0 or sk == 0:
        # No (query, key) pair: every gradient is zero.
        for t in outs:
            t.zero_()
        return
    lib = _bwd_lib()
    fn = lib.kft_flash_dq_bf16 if name == "flash_dq" else \
        lib.kft_flash_dkv_bf16
    # The launch goes to the calling thread's current device.
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), bh, sq, sk, d, int(causal),
                 d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.kft_cuda_error_string(err).decode())
    _count(name)


def _flash_dq_cuda(q, k, v, g, lse, delta, *, causal: bool) -> torch.Tensor:
    """Launch the dq kernel; raise on anything it does not take."""
    dq = torch.empty_like(q)
    _launch_bwd("flash_dq", q, k, v, g, lse, delta, (dq,), causal)
    return dq


def _flash_dkv_cuda(q, k, v, g, lse, delta, *, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dkv kernel; raise on anything it does not take."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_dkv", q, k, v, g, lse, delta, (dk, dv), causal)
    return dk, dv


def _flash_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dq and dkv kernels."""
    dq = _flash_dq_cuda(q, k, v, g, lse, delta, causal=causal)
    dk, dv = _flash_dkv_cuda(q, k, v, g, lse, delta, causal=causal)
    return dq, dk, dv


def flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[bh, s, d] backward -> (dq, dk, dv): the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return _flash_bwd_cuda(q, k, v, g, lse, delta, causal=causal)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, g, lse, delta, causal=causal)
    raise ValueError(f"flash_bwd runs on cuda or cpu, not {q.device}")


class _FlashFunction(torch.autograd.Function):
    """Differentiable [bh, s, d] flash attention: the counterpart of the
    JAX package's ``custom_vjp`` ``_flash``.  The forward goes through
    ``_fwd_dispatch`` (single pass, or two passes with ``block_diag``)
    and saves (q, k, v, o, lse); the merged lse of the two passes is the
    full softmax's, so one backward serves both.  The backward takes
    delta = rowsum(g * o) in float32 from the o the forward returned (in
    the input dtype, as JAX does) and runs the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_q: int = 512,
                block_k: int = 512, block_diag: int = 0):
        o, lse = _fwd_dispatch(q, k, v, causal, block_q, block_k, block_diag)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        # g comes out of _from_bhsd's transpose and may be strided.
        g = g.contiguous()
        delta = (g.float() * o.float()).sum(-1)
        dq, dk, dv = flash_bwd(q, k, v, g, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_bwd_block(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
    *, causal: bool, block_q: int = 512, block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blockwise backward in [b, s, h, d] layout; lse/delta are [b, h, s].

    GQA: callers pass kv already repeated to q's head count and fold the
    head-group sum themselves.  block_q/block_k are accepted for
    signature parity and unused: the CUDA kernels pick their own tiles.
    """
    del block_q, block_k
    b, sq, h, d = q.shape
    dq, dk, dv = flash_bwd(
        _to_bhsd(q), _to_bhsd(k), _to_bhsd(v), _to_bhsd(g),
        lse.reshape(b * h, sq).contiguous(),
        delta.reshape(b * h, sq).contiguous(), causal=causal)
    return _from_bhsd(dq, b, h), _from_bhsd(dk, b, h), _from_bhsd(dv, b, h)


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
    first valid key (left-padded prompts); it is forward-only, always
    single-pass, and raises under autograd.  Otherwise the forward goes
    through ``_fwd_dispatch``: ``block_diag > 0`` on causal
    self-attention longer than ``block_k`` selects the two-pass forward,
    whose split ``block_q``/``block_k`` define (fitted to the sequence
    as in the JAX package); the single pass picks its own tiles.  Under
    autograd the call goes through ``_FlashFunction`` (forward and
    backward kernels on the card, their plain versions on the CPU).
    """
    if segment_ids is not None:
        return dot_product_attention(
            q, k, v, causal=causal, segment_ids=segment_ids,
            kv_valid_start=kv_valid_start)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if needs_grad and kv_valid_start is not None:
        raise ValueError(
            "flash_attention with kv_valid_start is forward-only "
            "(inference prefill); it cannot be differentiated")
    b, sq, h, d = q.shape
    # repeat_interleave's autograd sums the head-group gradients (GQA).
    k, v = repeat_kv(k, v, h)
    q, k, v = _to_bhsd(q), _to_bhsd(k), _to_bhsd(v)
    if needs_grad:
        out = _FlashFunction.apply(q, k, v, causal, block_q, block_k,
                                   block_diag)
    elif kv_valid_start is not None:
        start = kv_valid_start.to(q.device, torch.int32).repeat_interleave(h)
        out, _ = flash_fwd(q, k, v, causal=causal, kv_start=start)
    else:
        out, _ = _fwd_dispatch(q, k, v, causal, block_q, block_k, block_diag)
    return _from_bhsd(out, b, h)
