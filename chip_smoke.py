#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (kubeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure (exit code 1, no result line):
  1. card: name and power limit from nvidia-smi; build the CUDA kernels
     of the serving and training paths from the sources in the checkout
     (one nvcc per source, started together) and time the build;
  2. kernels: each kernel against its plain PyTorch version on the card:
     the forward (causal / masked / non-causal, head_dim 64 and 128,
     lengths that are not tile multiples, key starts that fully mask the
     first tiles), the backward pair dq / dkv (the training shape, d 64
     with unaligned lengths, non-causal sq != sk, rows whose lse is the
     NEG_INF sentinel), and flash_attention's autograd path (GQA);
  3. timing: each kernel at the shape its path gives it, beside its
     plain version, its bound, and one PyTorch library call;
  4. serve: export a seeded 188M LM (bench.py's configuration, random
     weights), start the port's REST server in this process with bucketed
     static batching, send concurrent mixed-length :predict requests and
     one direct two-row request; the kernels' launch counters are zeroed
     just before and read just after, and every serving kernel must have
     run;
  5. check: every reply is prompt + max_new_tokens tokens in the
     vocabulary, and the prefill logits of one left-padded bf16 batch
     through the kernel are no further from a float32 run of the same
     weights than the same batch through the plain version is;
  6. breakdown (information only): prefill and decode time of one
     bucketed batch, and under torch.profiler the device's busy share
     and the kernels that take its time;
  7. train: the port's LM training entry point (tools/train_lm.main) on
     bench.py's LM configuration (batch 8 x 2048, flash, remat, adamw
     1e-3) for a few steps, launch counters zeroed just before and read
     just after: flash_fwd, flash_dq and flash_dkv must each launch 12
     times a step; losses and grad_norm finite; step time, tokens/s, MFU
     and peak memory printed;
  8. gradients: one step's gradients of the bf16 model (full width and
     depth, batch 2 x 2048) through the kernels and through the plain
     versions, each held to a float32 run of the same weights with plain
     attention: the kernel path may be at most 1.25x further from it;
  9. learning: Trainer.fit for 20 steps on one repeated batch must lower
     the loss by at least 1 nat; then (information only) one profiled
     training step: device busy share, the kernels with the most device
     time, and the share of flash fwd, dq and dkv.

The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import http.client
import itertools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SEED = 20261016
# bench.py's 188M LM (vocab 32000), bf16, flash attention, tied embed.
MODEL = {"vocab_size": 32000, "d_model": 1024, "n_layers": 12,
         "n_heads": 8, "n_kv_heads": 8, "d_ff": 2816, "head_dim": 128,
         "max_seq_len": 2048, "dtype": "bfloat16", "attention": "flash",
         "tied_embeddings": True}
MAX_NEW_TOKENS = 32
BUCKETS = "512,1024,2048"
MICRO_BATCH = 4
PROMPT_LENS = (300, 1800, 520, 1620, 760, 1440, 980, 1210)
DIRECT_ROWS, DIRECT_LEN = 2, 1024
# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 rate).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
# Kernel vs plain version, bf16 inputs, plain version in float32: o
# differs by bf16 rounding of p and of the output, lse by summation order.
# Elementwise bounds, and a bound on ||o - ref||_F / ||ref||_F that holds
# the many small outputs of long rows, which the atol alone would not.
O_TOL = dict(atol=2e-2, rtol=2e-2)
O_REL_TOL = 1e-2
LSE_ATOL = 2e-3
# Prefill logits of the bf16 model against a float32 run of the same
# weights: the kernel path's mean error may exceed the plain bf16 path's
# by this factor at most (both round p and o to bf16, at other points).
LOGITS_ERR_RATIO = 1.25
# Backward kernels against the float32 plain version on the same bf16
# inputs: each of dq, dk, dv within this relative Frobenius error, and
# elementwise within atol + rtol |ref|.  The kernels round ds and p to
# bf16 before their products (2^-9 relative each) and write bf16 (2^-9
# again); an entry near 1 sums thousands of such terms, so a few bf16
# ulps (4e-3 each at 1) is the expected error, and 5e-2 leaves room
# for the sums whose errors do not cancel.
BWD_REL_TOL = 2e-2
BWD_ELEM_TOL = dict(atol=5e-2, rtol=5e-2)
# One training step's gradients of the bf16 model against float32: the
# kernel path's relative error may exceed the plain bf16 path's by this
# factor at most.
GRAD_ERR_RATIO = 1.25
JAX_LOADER = "kubeflow_tpu.serving.loaders:lm_generate"
FWD_SOURCE = "kubeflow_tpu_torch/ops/csrc/flash_fwd.cu"
BWD_SOURCE = "kubeflow_tpu_torch/ops/csrc/flash_bwd.cu"
TPU_KERNELS = {
    "flash_fwd": "kubeflow_tpu/ops/flash.py:70",
    "flash_fwd_masked": "kubeflow_tpu/ops/flash.py:70",
    "flash_dq": "kubeflow_tpu/ops/flash.py:508",
    "flash_dkv": "kubeflow_tpu/ops/flash.py:560",
}
# bench.py's LM training cell (bench.py --model lm defaults): the flags
# of the port's training entry point.
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_FLAGS = [
    "--d-model", "1024", "--n-layers", "12", "--n-heads", "8",
    "--n-kv-heads", "8", "--d-ff", "2816", "--head-dim", "128",
    "--vocab-size", "32000", "--seq-len", str(TRAIN_SEQ),
    "--batch-size-per-device", str(TRAIN_BATCH), "--attention", "flash",
    "--remat", "--learning-rate", "1e-3", "--optimizer", "adamw",
    "--device", "cuda"]
TRAIN_STEPS = 6
LEARN_STEPS, LEARN_BATCH, LEARN_VOCAB = 20, 2, 512
SERVE_KERNELS = ("flash_fwd", "flash_fwd_masked")
TRAIN_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def live_work(bh, sq, sk, causal, starts):
    """What these inputs need: (query, key) pairs attended, query rows
    with at least one valid key, and key rows some query attends.  Rows
    before their first valid key and keys above the diagonal are neither
    read nor computed; such a row's o and lse are still written."""
    allowed = [min(i + 1, sk) if causal else sk for i in range(sq)]
    key_end = min(sq, sk) if causal else sk
    pairs = q_rows = kv_rows = 0
    for s0 in ([0] * bh if starts is None else starts):
        lo = min(max(s0, 0), sk)
        pairs += sum(max(hi - lo, 0) for hi in allowed)
        q_rows += sum(hi > lo for hi in allowed)
        kv_rows += max(key_end - lo, 0)
    return pairs, q_rows, kv_rows


def make_inputs(torch, gen, bh, sq, sk, d, starts):
    q = torch.randn(bh, sq, d, device="cuda", generator=gen).bfloat16()
    k = torch.randn(bh, sk, d, device="cuda", generator=gen).bfloat16()
    v = torch.randn(bh, sk, d, device="cuda", generator=gen).bfloat16()
    ks = None if starts is None else torch.tensor(
        starts, dtype=torch.int32, device="cuda")
    return q, k, v, ks


def check_kernels(torch, flash, gen):
    """Phase 2: each variant against the plain version on the card."""
    variants = [
        # name, bh, sq, sk, d, causal, kv_start per row
        ("causal_188m", 8, 2048, 2048, 128, True, None),
        ("causal_direct_request", DIRECT_ROWS * MODEL["n_heads"],
         DIRECT_LEN, DIRECT_LEN, 128, True, None),
        ("masked_188m", 32, 2048, 2048, 128, True,
         [0] * 8 + [248] * 8 + [1088] * 8 + [1748] * 8),
        ("causal_d64_unaligned", 6, 1000, 1000, 64, True, None),
        ("masked_d64_full_tiles", 4, 777, 777, 64, True,
         [0, 63, 200, 777]),
        ("noncausal_d128", 4, 333, 1500, 128, False, None),
        ("noncausal_masked_d64", 4, 333, 777, 64, False,
         [0, 64, 500, 900]),
    ]
    results = []
    for name, bh, sq, sk, d, causal, starts in variants:
        q, k, v, ks = make_inputs(torch, gen, bh, sq, sk, d, starts)
        o, lse = flash.flash_fwd(q, k, v, causal=causal, kv_start=ks)
        results.append(check_fwd(torch, flash, name, q, k, v, ks, causal,
                                 o, lse))
        del q, k, v, o, lse
    return results


def check_fwd(torch, flash, name, q, k, v, ks, causal, o, lse):
    """The forward kernel's (o, lse) on these inputs against the plain
    version in float32; fails on disagreement, else returns the errors."""
    torch.cuda.synchronize()
    ro, rlse = flash.flash_fwd_reference(
        q.float(), k.float(), v.float(), causal=causal, kv_start=ks)
    err_o = (o.float() - ro).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    rel_o = ((o.float() - ro).norm() / ro.norm()).item()
    ok_o = torch.allclose(o.float(), ro, **O_TOL) and rel_o <= O_REL_TOL
    ok_lse = torch.allclose(lse, rlse, atol=LSE_ATOL, rtol=0)
    finite = bool(torch.isfinite(o).all())
    bh, sq, d = q.shape
    log(f"check {name}: bh={bh} sq={sq} sk={k.shape[1]} d={d} "
        f"causal={causal} masked={ks is not None} max|o-ref|={err_o:.3e} "
        f"|o-ref|_F/|ref|_F={rel_o:.3e} max|lse-ref|={err_lse:.3e} "
        f"(bounds o atol/rtol {O_TOL['atol']}, o relative "
        f"{O_REL_TOL}, lse atol {LSE_ATOL})")
    if not (ok_o and ok_lse and finite):
        fail(f"kernel disagrees with its plain version on {name}")
    return {"variant": name, "masked": ks is not None,
            "max_abs_err_o": err_o, "rel_err_o": rel_o,
            "max_abs_err_lse": err_lse}


def _bwd_errors(torch, got, want):
    """(relative Frobenius error, max |error|, elementwise ok, finite)."""
    err = got.float() - want.float()
    rel = (err.norm() / want.float().norm()).item()
    ok = torch.allclose(got.float(), want.float(), **BWD_ELEM_TOL)
    return rel, err.abs().max().item(), ok, bool(torch.isfinite(got).all())


def check_bwd_kernels(torch, flash, gen, fwd_checks):
    """Phase 2, backward: dq and dkv against the plain version.  The
    forward kernel's (o, lse) they start from is first held against its
    own plain version at the same shape (the training shape among them),
    and its row is added to ``fwd_checks``."""
    variants = [
        # name, bh, sq, sk, d, causal, rows whose lse is NEG_INF
        ("causal_train", TRAIN_BATCH * MODEL["n_heads"], TRAIN_SEQ,
         TRAIN_SEQ, 128, True, False),
        ("causal_d64_unaligned", 6, 1000, 1000, 64, True, False),
        ("noncausal_sq_ne_sk", 4, 333, 1500, 128, False, False),
        ("neg_inf_rows_d64", 4, 777, 777, 64, True, True),
    ]
    results = []
    for name, bh, sq, sk, d, causal, neg_inf in variants:
        q, k, v, _ = make_inputs(torch, gen, bh, sq, sk, d, None)
        g = torch.randn(bh, sq, d, device="cuda", generator=gen).bfloat16()
        o, lse = flash.flash_fwd(q, k, v, causal=causal)
        fwd_checks.append(check_fwd(torch, flash, f"fwd_of_bwd_{name}", q,
                                    k, v, None, causal, o, lse))
        if neg_inf:
            lse[1, ::3] = flash.NEG_INF
            lse[3] = flash.NEG_INF
        delta = (g.float() * o.float()).sum(-1)
        got = flash.flash_bwd(q, k, v, g, lse, delta, causal=causal)
        torch.cuda.synchronize()
        want = flash.flash_bwd_reference(q.float(), k.float(), v.float(),
                                         g.float(), lse, delta,
                                         causal=causal)
        row = {"variant": name, "shape": [bh, sq, sk, d], "causal": causal}
        line = []
        for grad, a, b in zip(("dq", "dk", "dv"), got, want):
            rel, mx, ok, finite = _bwd_errors(torch, a, b)
            row[f"rel_err_{grad}"], row[f"max_abs_err_{grad}"] = rel, mx
            line.append(f"{grad} rel {rel:.3e} max {mx:.3e}")
            if not (ok and finite and rel <= BWD_REL_TOL):
                fail(f"backward kernel {grad} disagrees with its plain "
                     f"version on {name}: relative {rel:.3e}, max {mx:.3e}")
        if neg_inf and not (torch.all(got[0][3] == 0)
                            and torch.all(got[1][3] == 0)):
            fail("a row block with NEG_INF lse got non-zero gradients")
        log(f"check bwd {name}: bh={bh} sq={sq} sk={sk} d={d} "
            f"causal={causal} neg_inf_rows={neg_inf}: {'; '.join(line)} "
            f"(bounds: relative {BWD_REL_TOL}, elementwise atol "
            f"{BWD_ELEM_TOL['atol']} rtol {BWD_ELEM_TOL['rtol']})")
        results.append(row)
        del q, k, v, g, o, lse, delta, got, want
    return results


def check_autograd(torch, flash, gen):
    """Phase 2, autograd: flash_attention(...).backward(g) on the card
    (forward, dq and dkv kernels, GQA repeat) against the same call with
    the plain versions swapped in."""
    b, s, h, hkv, d = 2, 1024, 8, 2, 128
    shapes = ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
    base = [torch.randn(shape, device="cuda", generator=gen).bfloat16()
            for shape in shapes]
    g = torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16()

    def grads():
        q, k, v = (t.clone().requires_grad_() for t in base)
        flash.flash_attention(q, k, v, causal=True).backward(g)
        return q.grad, k.grad, v.grad

    before = dict(flash.launch_counts)
    through_kernels = grads()
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        if flash.launch_counts[name] != before[name] + 1:
            fail(f"autograd through flash_attention did not launch {name}")
    with plain_kernels(flash):
        through_plain = grads()
    line = []
    for name, a, ref in zip(("dq", "dk", "dv"), through_kernels,
                            through_plain):
        rel, mx, ok, finite = _bwd_errors(torch, a, ref)
        line.append(f"{name} rel {rel:.3e} max {mx:.3e}")
        if not (ok and finite and rel <= BWD_REL_TOL):
            fail(f"autograd {name} through the kernels disagrees with the "
                 f"plain path: relative {rel:.3e}")
    log(f"check autograd flash_attention b={b} s={s} h={h} hkv={hkv} "
        f"d={d}: kernels vs plain path {'; '.join(line)}")


class plain_kernels:
    """Swap the kernels' plain versions in for the CUDA launches (the
    comparison runs; nothing of the port's own code path does this)."""

    def __init__(self, flash):
        self.flash = flash

    def __enter__(self):
        f = self.flash
        self.saved = f._flash_fwd_cuda, f._flash_bwd_cuda

        def fwd(q, k, v, *, causal, kv_start=None):
            return f.flash_fwd_reference(q, k, v, causal=causal,
                                         kv_start=kv_start)

        f._flash_fwd_cuda, f._flash_bwd_cuda = fwd, f.flash_bwd_reference
        return self

    def __exit__(self, *exc):
        self.flash._flash_fwd_cuda, self.flash._flash_bwd_cuda = self.saved


def bound(ops, nbytes):
    """(bound ms, what sets it, operations ms, bytes ms)."""
    t_ops = ops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", t_ops, t_bytes)


def time_kernels(torch, flash, gen, checks):
    """Phase 3: each forward variant at the serving path's heaviest
    shape."""
    import torch.nn.functional as F

    heads, d = MODEL["n_heads"], MODEL["head_dim"]
    # Masked: a full bucketed batch at the largest bucket, key starts from
    # the smoke's own prompt mix.  Unmasked: the direct two-row request.
    starts = [2048 - n for n in (1800, 1620, 1440, 1210) for _ in
              range(heads)]
    shapes = {
        "flash_fwd": (DIRECT_ROWS * heads, DIRECT_LEN, None),
        "flash_fwd_masked": (MICRO_BATCH * heads, 2048, starts),
    }
    rows = {}
    for name, (bh, s, st) in shapes.items():
        q, k, v, ks = make_inputs(torch, gen, bh, s, s, d, st)
        ms = time_ms(torch, lambda: flash.flash_fwd(
            q, k, v, causal=True, kv_start=ks), reps=20)
        plain_ms = time_ms(torch, lambda: flash.flash_fwd_reference(
            q, k, v, causal=True, kv_start=ks), reps=5)
        q4, k4, v4 = (t[None] for t in (q, k, v))  # [1, bh, s, d]
        if ks is None:
            def library():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True)
        else:
            pos = torch.arange(s, device="cuda")
            mask = ((pos[None, :, None] >= pos[None, None, :])
                    & (pos[None, None, :] >= ks.long()[:, None, None]))[None]

            def library():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      attn_mask=mask)
        library_ms = time_ms(torch, library, reps=10)
        pairs, q_rows, kv_rows = live_work(bh, s, s, True, st)
        ops = 4 * d * pairs  # q.k and p.v, 2 operations per multiply-add
        # bf16 q, k, v of the live rows read once; o (bf16) and lse (f32)
        # of every row written once; the int32 key starts read once.
        nbytes = 2 * d * (q_rows + 2 * kv_rows) + 2 * bh * s * d \
            + 4 * bh * s + (0 if ks is None else 4 * bh)
        t_bound, by, t_ops, t_bytes = bound(ops, nbytes)
        mine = [c for c in checks if c["masked"] == (ks is not None)]
        rows[name] = {
            "name": name, "route": "cuda", "source": FWD_SOURCE,
            "replaces": TPU_KERNELS[name],
            "shape": {"bh": bh, "sq": s, "sk": s, "d": d, "causal": True},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bound,
            "bound_by": by, "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "library_ms": library_ms,
            "max_abs_err": max(c["max_abs_err_o"] for c in mine),
            "checks": mine,
        }
        log(f"time {name}: bh={bh} s={s} d={d} kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{t_bound:.4f} ms ({by}; operations {t_ops:.4f} ms for "
            f"{ops:.4g}, bytes {t_bytes:.4f} ms for {nbytes:.4g})")
        del q, k, v, ks
    return rows


def time_train_kernels(torch, flash, gen, fwd_rows, bwd_checks):
    """Phase 3, training path: the forward, dq and dkv kernels at the
    training shape (bh 64, s 2048, d 128, causal).  The library yardstick
    of the backward pair is the backward alone of one causal SDPA call
    (torch.autograd.grad on a retained graph, 4-D inputs), which computes
    dq, dk and dv together: it stands on both rows, beside their sum.
    Returns the dq and dkv rows; the forward's numbers go into the
    ``train_shape`` object of its serving-shape row in ``fwd_rows``."""
    import torch.nn.functional as F

    heads, d = MODEL["n_heads"], MODEL["head_dim"]
    bh, s = TRAIN_BATCH * heads, TRAIN_SEQ
    q, k, v, _ = make_inputs(torch, gen, bh, s, s, d, None)
    g = torch.randn(bh, s, d, device="cuda", generator=gen).bfloat16()
    o, lse = flash.flash_fwd(q, k, v, causal=True)
    delta = (g.float() * o.float()).sum(-1)
    args = (q, k, v, g, lse, delta)
    pairs, q_rows, kv_rows = live_work(bh, s, s, True, None)
    fwd_ms = time_ms(torch, lambda: flash.flash_fwd(q, k, v, causal=True),
                     reps=20)
    fwd_plain = time_ms(torch, lambda: flash.flash_fwd_reference(
        q, k, v, causal=True), reps=3)
    dq_ms = time_ms(torch, lambda: flash._flash_dq_cuda(*args, causal=True),
                    reps=20)
    dkv_ms = time_ms(torch, lambda: flash._flash_dkv_cuda(
        *args, causal=True), reps=20)
    dq_plain = time_ms(torch, lambda: flash.flash_dq_reference(
        *args, causal=True), reps=3)
    dkv_plain = time_ms(torch, lambda: flash.flash_dkv_reference(
        *args, causal=True), reps=3)
    q4, k4, v4 = (t.reshape(TRAIN_BATCH, heads, s, d).detach()
                  .requires_grad_() for t in (q, k, v))
    g4 = g.reshape(TRAIN_BATCH, heads, s, d)
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4.detach(), k4.detach(), v4.detach(), is_causal=True), reps=20)
    bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
        out4, (q4, k4, v4), g4, retain_graph=True), reps=20)
    shape = {"bh": bh, "sq": s, "sk": s, "d": d, "causal": True}
    io = 2 * d * (2 * q_rows + 2 * kv_rows) + 8 * bh * s  # q g k v lse delta
    work = {
        # name: (ms, plain ms, library ms, operations, bytes, source)
        "flash_fwd": (fwd_ms, fwd_plain, fwd_lib, 4 * d * pairs,
                      2 * d * (q_rows + 2 * kv_rows) + 2 * bh * s * d
                      + 4 * bh * s, FWD_SOURCE),
        # s, dp and dq: three products, 2 d operations per pair each.
        "flash_dq": (dq_ms, dq_plain, bwd_lib, 6 * d * pairs,
                     io + 2 * d * bh * s, BWD_SOURCE),
        # s, dp, dv and dk: four products.
        "flash_dkv": (dkv_ms, dkv_plain, bwd_lib, 8 * d * pairs,
                      io + 4 * d * bh * s, BWD_SOURCE),
    }
    rows = {}
    for name, (ms, plain_ms, lib_ms, ops, nbytes, src) in work.items():
        t_bound, by, t_ops, t_bytes = bound(ops, nbytes)
        rows[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": TPU_KERNELS[name], "shape": shape, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": t_bound, "bound_by": by,
            "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "library_ms": lib_ms,
            "tflops": ops / (ms * 1e-3) / 1e12,
        }
        log(f"time {name} (training shape): bh={bh} s={s} d={d} kernel "
            f"{ms:.4f} ms ({rows[name]['tflops']:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {t_bound:.4f} "
            f"ms ({by}; operations {t_ops:.4f} ms for {ops:.4g}, bytes "
            f"{t_bytes:.4f} ms for {nbytes:.4g})")
    for name in ("flash_dq", "flash_dkv"):
        rows[name]["library_note"] = (
            "backward of one causal SDPA call: dq, dk and dv together")
        rows[name]["max_abs_err"] = max(
            c[f"max_abs_err_{g_}"] for c in bwd_checks
            for g_ in (("dq",) if name == "flash_dq" else ("dk", "dv")))
        rows[name]["checks"] = bwd_checks
    log(f"time backward pair: dq + dkv {dq_ms + dkv_ms:.4f} ms against the "
        f"SDPA backward's {bwd_lib:.4f} ms")
    # The forward's row keeps the serving shape's numbers at its top level
    # (as the serving slice defined them); the training shape's stand in
    # its train_shape object.
    train_fwd = rows.pop("flash_fwd")
    fwd_rows["flash_fwd"]["train_shape"] = {
        key: train_fwd[key] for key in
        ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ops_bound_ms",
         "bytes_bound_ms", "library_ms", "tflops")}
    del q, k, v, g, o, lse, delta, q4, k4, v4, out4
    return rows


def export_model(torch, base: Path) -> None:
    from kubeflow_tpu_torch.models.convert import params_to_jax
    from kubeflow_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from kubeflow_tpu_torch.serving.export import export

    cfg = TransformerConfig(**dict(MODEL, dtype=torch.float32))
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    export(base, 1, {"params": params_to_jax(model)}, loader=JAX_LOADER,
           config={"model": MODEL, "max_new_tokens": MAX_NEW_TOKENS},
           signature={"inputs": ["tokens"], "outputs": ["tokens"]})
    log(f"exported seeded {n_params / 1e6:.1f}M-parameter LM to {base}")


def post(port: int, body: dict) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/model/lm:predict", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"predict answered {resp.status}: {payload}")
    return payload


def serve(torch, flash, base: Path, prompts, direct):
    """Phase 4: the port's serving entry point, driven over REST."""
    from kubeflow_tpu_torch.serving import main as serving_main

    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base),
        "--port", "0", "--host", "127.0.0.1", "--device", "cuda",
        "--lm_buckets", BUCKETS, "--micro_batch_size", str(MICRO_BATCH)])
    port = httpd.server_address[1]
    try:
        # One short request first, so the timed burst does not carry the
        # process's one-off CUDA and cuBLAS start-up.
        post(port, {"instances": [{"tokens": prompts[0][:16]}]})
        for key in flash.launch_counts:
            flash.launch_counts[key] = 0
        replies = [None] * len(prompts)

        def call(i):
            replies[i] = post(port, {"instances": [{"tokens": prompts[i]}]})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads) or None in replies:
            fail("a batched request did not complete")
        t_batched = time.perf_counter() - t0
        t1 = time.perf_counter()
        direct_reply = post(port, {"instances": [{"tokens": p}
                                                 for p in direct]})
        t_direct = time.perf_counter() - t1
        stats = server.batcher_stats("lm")
    finally:
        serving_main.shutdown(server, httpd)
    counts = {k: flash.launch_counts[k] for k in SERVE_KERNELS}
    n_req = len(prompts) + 1
    n_tok = (len(prompts) + len(direct)) * MAX_NEW_TOKENS
    log(f"served {len(prompts)} concurrent bucketed requests in "
        f"{t_batched:.3f} s and one direct {len(direct)}-row request in "
        f"{t_direct:.3f} s: {n_req / (t_batched + t_direct):.3f} requests/s,"
        f" {n_tok / (t_batched + t_direct):.1f} generated tokens/s "
        f"(host clock, information only)")
    log(f"kernel launches on the serving path: {counts}; batcher: "
        f"{stats['batches']} batches, sizes {stats['batch_size_hist']}")
    return replies, direct_reply, counts


def check_replies(prompts, replies, direct, direct_reply):
    vocab = MODEL["vocab_size"]
    got = [r["predictions"][0]["tokens"] for r in replies]
    got += [p["tokens"] for p in direct_reply["predictions"]]
    for prompt, tokens in zip(list(prompts) + list(direct), got):
        if len(tokens) != len(prompt) + MAX_NEW_TOKENS:
            fail(f"reply of {len(tokens)} tokens for a {len(prompt)}-token "
                 f"prompt, expected {len(prompt) + MAX_NEW_TOKENS}")
        if tokens[:len(prompt)] != prompt:
            fail("a reply does not start with its prompt")
        if not all(0 <= t < vocab for t in tokens):
            fail("a reply holds tokens outside the vocabulary")
    log(f"replies: {len(got)} rows, each prompt + {MAX_NEW_TOKENS} tokens in "
        f"[0, {vocab})")


def load_model(torch, base: Path, dtype):
    """The exported model on the card, weights narrowed to bf16 as the
    loader stages them, computing in ``dtype``."""
    from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
    from kubeflow_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from kubeflow_tpu_torch.ops.quantize import narrow_params
    from kubeflow_tpu_torch.serving.export import PARAMS_FILE, msgpack_restore

    tree = msgpack_restore((base / "1" / PARAMS_FILE).read_bytes())
    params = narrow_params(params_from_jax(tree["params"]), torch.bfloat16)
    cfg = TransformerConfig(**dict(MODEL, dtype=dtype))
    return load_params(Transformer(cfg, device="meta"), params).cuda()


def padded_batch(torch, gen):
    """One bucketed batch at the largest bucket: left-padded tokens, real
    lengths and pad widths."""
    width = 2048
    lengths = torch.tensor([2048, 1500, 900, 300], device="cuda")
    tokens = torch.randint(1, MODEL["vocab_size"], (4, width), device="cuda",
                           generator=gen)
    pad = width - lengths
    tokens[torch.arange(width, device="cuda")[None, :] < pad[:, None]] = 0
    return tokens, lengths, pad


def check_prefill_logits(torch, flash, base: Path, gen) -> None:
    """Phase 5: one left-padded prefill of the bf16 model through the
    kernel and through the plain version, each held to a float32 run of
    the same weights (plain attention) at the real positions."""
    from kubeflow_tpu_torch.models.generate import (
        _forward_with_cache,
        init_cache,
    )

    tokens, lengths, pad = padded_batch(torch, gen)
    width = tokens.shape[1]
    real = torch.arange(width, device="cuda")[None, :] >= pad[:, None]

    def prefill(dtype):
        model = load_model(torch, base, dtype)
        with torch.inference_mode():
            return _forward_with_cache(
                model, tokens, init_cache(model.cfg, 4, width, device="cuda"),
                0, pad_amount=pad)[real]

    before = flash.launch_counts["flash_fwd_masked"]
    through_kernel = prefill(torch.bfloat16)
    if flash.launch_counts["flash_fwd_masked"] != before + MODEL["n_layers"]:
        fail("the padded prefill did not launch the masked kernel per layer")
    with plain_kernels(flash):
        through_plain = prefill(torch.bfloat16)
        reference = prefill(torch.float32)
    for name, logits in (("kernel", through_kernel), ("plain", through_plain)):
        if not torch.isfinite(logits).all():
            fail(f"non-finite prefill logits through the {name} path")
    err_k = (through_kernel - reference).abs()
    err_p = (through_plain - reference).abs()
    top_ref = reference.argmax(-1)
    log(f"prefill logits, padded batch lengths {lengths.tolist()} at bucket "
        f"{width}, {int(real.sum())} real positions, against float32: "
        f"kernel path mean |err| {err_k.mean().item():.4e} max "
        f"{err_k.max().item():.4e} argmax agreement "
        f"{(through_kernel.argmax(-1) == top_ref).float().mean().item():.4f}"
        f"; plain path mean |err| {err_p.mean().item():.4e} max "
        f"{err_p.max().item():.4e} argmax agreement "
        f"{(through_plain.argmax(-1) == top_ref).float().mean().item():.4f}"
        f"; max |kernel - plain| "
        f"{(through_kernel - through_plain).abs().max().item():.4e} "
        f"(bound: kernel mean error <= {LOGITS_ERR_RATIO} x plain)")
    if err_k.mean() > LOGITS_ERR_RATIO * err_p.mean():
        fail("prefill logits through the kernel are further from float32 "
             "than through the plain version")


def breakdown(torch, base: Path, gen) -> None:
    """Phase 6, information only: where the time of one bucketed batch
    goes in generate(): prefill and decode wall time (host clock after a
    synchronize), then, under torch.profiler, the device's busy share and
    the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import (
        DecodeConfig,
        _forward_with_cache,
        generate,
        init_cache,
    )

    model = load_model(torch, base, torch.bfloat16)
    tokens, lengths, pad = padded_batch(torch, gen)
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)

    def run():
        out, _ = generate(model, tokens, decode, prompt_len=lengths)
        torch.cuda.synchronize()
        return out

    def prefill():
        with torch.inference_mode():
            _forward_with_cache(
                model, tokens,
                init_cache(model.cfg, 4, tokens.shape[1] + MAX_NEW_TOKENS,
                           device="cuda"), 0, pad_amount=pad)
        torch.cuda.synchronize()

    run()  # warm-up
    t0 = time.perf_counter()
    prefill()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    run()
    t_total = time.perf_counter() - t0
    step_ms = (t_total - t_prefill) / MAX_NEW_TOKENS * 1e3
    log(f"breakdown, batch of 4 at bucket {tokens.shape[1]}, "
        f"{MAX_NEW_TOKENS} new tokens: generate {t_total * 1e3:.1f} ms = "
        f"prefill {t_prefill * 1e3:.1f} ms + {MAX_NEW_TOKENS} decode steps "
        f"of {step_ms:.2f} ms (host clock)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        t_prof = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log("breakdown: the profiler saw no device time; device busy share "
            "not measured")
        return
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_fwd_kernel" in e.key)
    log(f"breakdown under torch.profiler: wall {t_prof * 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({busy_us / (t_prof * 1e6):.3f}"
        f" of the profiled wall, {busy_us / (t_total * 1e6):.3f} of the "
        f"unprofiled one), flash_fwd kernel {flash_us / 1e3:.3f} ms "
        f"({flash_us / busy_us:.3f} of busy)")
    for e in kernels[:6]:
        log(f"  {e.self_device_time_total / busy_us:.3f} of busy, "
            f"{e.count} launches: {e.key[:100]}")


def train(torch, flash, workdir: Path):
    """Phase 7: the port's training entry point on the bench LM config
    (``train_lm.run``, the work of ``train_lm.main``, which returns the
    trainer and so its last step's metrics)."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.tools import train_lm

    out = workdir / "train_metrics.json"
    argv = TRAIN_FLAGS + ["--steps", str(TRAIN_STEPS), "--log-every", "1",
                          "--max-restarts", "0", "--metrics-out", str(out)]
    torch.cuda.reset_peak_memory_stats()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    trainer = train_lm.run(argv)
    torch.cuda.synchronize()
    counts = dict(flash.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = MODEL["n_layers"] * TRAIN_STEPS
    log(f"kernel launches on the training path ({TRAIN_STEPS} steps): "
        f"{counts} (want {want} = {MODEL['n_layers']} layers x "
        f"{TRAIN_STEPS} steps of each of {', '.join(TRAIN_KERNELS)})")
    bad = [k for k in TRAIN_KERNELS if counts[k] != want]
    if bad:
        fail(f"training-path kernels launched the wrong number of times: "
             f"{bad}")
    history = json.loads(out.read_text())["history"]
    losses = [r["loss"] for r in history]
    last = trainer.last_metrics
    if len(losses) != TRAIN_STEPS or not all(
            map(math.isfinite,
                losses + [last.get("grad_norm", float("nan"))])):
        fail(f"non-finite or missing training metrics: losses {losses}, "
             f"last {last}")
    # Steps 0-1 carry one-off start-up (cuBLAS handles, allocator growth).
    step_s = sorted(r["step_time_s"] for r in history[2:])
    step_s = step_s[len(step_s) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    cfg = TransformerConfig(**{k: v for k, v in MODEL.items()
                               if k not in ("dtype",)})
    mfu = 3 * cfg.flops_per_token() * tokens / step_s / PEAK_BF16_FLOPS
    log(f"train: {TRAIN_STEPS} steps of batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"losses {[round(x, 4) for x in losses]}, last grad_norm "
        f"{last['grad_norm']:.4f}; median step {step_s * 1e3:.1f} ms over "
        f"steps 2-{TRAIN_STEPS - 1} (host clock after a sync each step), "
        f"{tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} (3 x "
        f"flops_per_token x tokens / {PEAK_BF16_FLOPS:.3g}), peak memory "
        f"{peak_gib:.2f} GiB (information only)")
    return counts, {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
                    "mfu": mfu, "peak_gib": peak_gib, "losses": losses}


def check_gradients(torch, flash):
    """Phase 8: one step's gradients of the bf16 model at full width and
    depth through the kernels and through the plain versions, each held
    to a float32 run of the same weights with plain attention."""
    from kubeflow_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        lm_task,
    )

    base = dict(MODEL, max_seq_len=TRAIN_SEQ, remat=True)
    cfg = TransformerConfig(**dict(base, dtype=torch.bfloat16))
    cfg32 = TransformerConfig(**dict(base, dtype=torch.float32,
                                     attention="dot"))
    model = Transformer(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    model32 = Transformer(cfg32, device="meta")
    model32.load_state_dict(
        {k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    tokens = torch.randint(0, MODEL["vocab_size"], (2, TRAIN_SEQ),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(SEED + 1))

    def grads(m):
        _, loss_fn = lm_task(m.cfg, device="cuda")
        loss, _ = loss_fn(m, {}, {"tokens": tokens}, None)
        loss.backward()
        flat = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        return loss.item(), flat

    before = dict(flash.launch_counts)
    loss_k, g_k = grads(model)
    launched = {k: flash.launch_counts[k] - before[k] for k in TRAIN_KERNELS}
    if any(n != MODEL["n_layers"] for n in launched.values()):
        fail(f"the gradient step did not launch each kernel once per layer: "
             f"{launched}")
    with plain_kernels(flash):
        loss_p, g_p = grads(model)
    loss_r, g_r = grads(model32)
    ref = g_r.norm()
    err_k = ((g_k - g_r).norm() / ref).item()
    err_p = ((g_p - g_r).norm() / ref).item()
    log(f"gradients, batch 2 x {TRAIN_SEQ}, {g_r.numel()} parameters, "
        f"against float32 with plain attention (loss {loss_r:.6f}): kernel "
        f"path relative error {err_k:.4e} (loss {loss_k:.6f}), plain bf16 "
        f"path {err_p:.4e} (loss {loss_p:.6f}), |kernel - plain| / |ref| "
        f"{((g_k - g_p).norm() / ref).item():.4e} (bound: kernel <= "
        f"{GRAD_ERR_RATIO} x plain)")
    if not (torch.isfinite(g_k).all() and err_k <= GRAD_ERR_RATIO * err_p):
        fail("gradients through the kernels are further from float32 than "
             "through the plain versions")
    return {"rel_err_kernel": err_k, "rel_err_plain": err_p}


def learn_and_breakdown(torch):
    """Phase 9: Trainer.fit on one repeated batch must learn; then one
    profiled training step of the bench batch (information only)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.train import Trainer

    cfg = TransformerConfig(**dict(MODEL, max_seq_len=TRAIN_SEQ, remat=True,
                                   dtype=torch.bfloat16))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adamw(1e-3), device="cuda")
    state = trainer.create_state(SEED)
    rng = np.random.RandomState(SEED)
    # Tokens from a 512-id subset of the vocabulary: a batch to memorize.
    batch = {"tokens": rng.randint(0, LEARN_VOCAB, size=(
        LEARN_BATCH, TRAIN_SEQ)).astype(np.int32)}
    state = trainer.fit(itertools.repeat(batch), LEARN_STEPS, state=state,
                        log_every=1)
    losses = [r["loss"] for r in trainer.metrics.history]
    log(f"learning: {LEARN_STEPS} steps on one repeated {LEARN_BATCH} x "
        f"{TRAIN_SEQ} batch: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(bound: a drop of at least 1 nat)")
    if not (math.isfinite(losses[-1]) and losses[-1] <= losses[0] - 1.0):
        fail("the loss did not fall by 1 nat on a repeated batch")

    step = trainer.compile_step()
    big = {"tokens": rng.randint(0, MODEL["vocab_size"], size=(
        TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}

    def one():
        nonlocal state
        state, _ = step(state, trainer.shard_batch(big))
        torch.cuda.synchronize()

    one()  # warm-up at this batch shape
    t0 = time.perf_counter()
    one()
    t_step = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        t_prof = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log("train breakdown: the profiler saw no device time; device busy "
            "share not measured")
        return {"step_ms": t_step * 1e3}
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    shares = {}
    for name in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"):
        shares[name] = sum(e.self_device_time_total for e in kernels
                           if name in e.key) / busy_us
    log(f"train breakdown, one step of batch {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"under torch.profiler: wall {t_prof * 1e3:.1f} ms (unprofiled "
        f"{t_step * 1e3:.1f} ms), device busy {busy_us / 1e3:.1f} ms "
        f"({busy_us / (t_prof * 1e6):.3f} of the profiled wall, "
        f"{busy_us / (t_step * 1e6):.3f} of the unprofiled one); share of "
        f"busy: " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    for e in kernels[:8]:
        log(f"  {e.self_device_time_total / busy_us:.3f} of busy, "
            f"{e.count} launches: {e.key[:100]}")
    return {"step_ms": t_step * 1e3, "busy_ms": busy_us / 1e3,
            "shares": shares}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs on an "
             "NVIDIA GPU")
    repo = Path(__file__).resolve().parent
    if not (repo / "kubeflow_tpu_torch").is_dir():
        fail(f"no kubeflow_tpu_torch package beside {__file__}: run from a "
             "checkout of the repository")
    sys.path.insert(0, str(repo))
    from kubeflow_tpu_torch.ops import _build, flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    sources = ("flash_fwd", "flash_bwd")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))  # one nvcc each, together
    log(f"built CUDA kernels {sources} in {time.perf_counter() - t0:.2f} s")
    for src in sources:
        for line in _build.build_logs.get(src, "").splitlines():
            if "Compiling entry" in line:
                log(f"  ptxas {src}: {line.split(chr(39))[1][:90]}")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = check_kernels(torch, flash, gen)
    bwd_checks = check_bwd_kernels(torch, flash, gen, checks)
    check_autograd(torch, flash, gen)
    timed = time_kernels(torch, flash, gen, checks)
    timed.update(time_train_kernels(torch, flash, gen, timed, bwd_checks))

    rng = torch.Generator().manual_seed(SEED)
    vocab = MODEL["vocab_size"]
    prompts = [torch.randint(1, vocab, (n,), generator=rng).tolist()
               for n in PROMPT_LENS]
    direct = [torch.randint(1, vocab, (DIRECT_LEN,), generator=rng).tolist()
              for _ in range(DIRECT_ROWS)]
    workdir = Path(tempfile.mkdtemp(prefix="kft-chip-smoke-"))
    try:
        base = workdir / "lm"
        export_model(torch, base)
        replies, direct_reply, counts = serve(torch, flash, base, prompts,
                                              direct)
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            fail(f"kernels never launched on the serving path: {missing}")
        check_replies(prompts, replies, direct, direct_reply)
        check_prefill_logits(torch, flash, base, gen)
        breakdown(torch, base, gen)
        train_counts, train_info = train(torch, flash, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    grads = check_gradients(torch, flash)
    learned = learn_and_breakdown(torch)

    kernels = []
    for name, row in timed.items():
        # Each kernel's launches on the path its top-level numbers come
        # from: serving for the forward (its training-shape numbers and
        # launches stand in train_shape), training for dq and dkv.
        on_train = name in ("flash_dq", "flash_dkv")
        row["launches"] = train_counts[name] if on_train else counts[name]
        row["path"] = "train" if on_train else "serve"
        row["launches_by_path"] = {"serve": counts.get(name, 0),
                                   "train": train_counts[name]}
        kernels.append(row)
    timed["flash_fwd"]["train_shape"]["launches"] = train_counts["flash_fwd"]
    log(json.dumps({"train": dict(train_info, gradients=grads,
                                  breakdown=learned)}))
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
