#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (kubeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure (exit code 1, no result line):
  1. card: name and power limit from nvidia-smi; build the CUDA kernels
     of the serving and training paths from the sources in the checkout
     (one nvcc per source, started together) and time the build;
  2. kernels: each kernel against its plain PyTorch version on the card:
     the forward (causal / masked / non-causal, head_dim 64 and 128,
     lengths that are not tile multiples, below one 128-row tile and one
     past it, key starts inside a tile and ones that fully mask the
     first tiles, heads of distinct magnitudes at a length that ends
     inside a tile, each head on its own), the backward pair dq / dkv
     (the training shape, d 64 with unaligned lengths, non-causal
     sq != sk, rows whose lse is the NEG_INF sentinel, a length that
     cuts the 128-row and 64-query tiles, causal sk > sq whose key
     tiles past the last query must write zero dk and dv, heads of
     distinct magnitudes with each head's relative error and max
     |err| / RMS printed),
     flash_attention's autograd path (GQA), and the
     two passes of the two-pass causal forward (pass A flash_fwd_full,
     pass B flash_fwd_diag) and their merge (the training split, d 64,
     fitted blocks that are not multiples of 64 or of the 128-row tile,
     a length that is not a tile multiple, the pure band; a shape
     outside the two-pass dispatch launches neither);
  3. timing: each kernel at the shape its path gives it, beside its
     plain version, its bound, and one PyTorch library call; every row
     also with its TFLOP/s, its share of its bound and its instance's
     registers and shared memory; the backward pair plus the float32
     delta pass beside SDPA's backward; the two-pass forward beside the
     single-pass kernel on the same inputs;
  4. serve: export a seeded 188M LM (bench.py's configuration, random
     weights), start the port's REST server in this process with bucketed
     static batching (--lm_static_batcher: the continuous-batching engine
     is the default and launches no flash kernel), send concurrent
     mixed-length :predict requests and one direct two-row request; the
     kernels' launch counters are zeroed just before and read just after,
     and every serving kernel must have run;
  5. check: every reply is prompt + max_new_tokens tokens in the
     vocabulary, and the prefill logits of one left-padded bf16 batch
     through the kernel are no further from a float32 run of the same
     weights than the same batch through the plain version is;
  6. breakdown (information only): prefill and decode time of one
     bucketed batch, and under torch.profiler the device's busy share
     and the kernels that take its time;
 6b. engine: the same server with the JAX CLI's engine defaults (the
     continuous-batching DecodeEngine: 8 slots, fused rounds of 8 steps,
     64-token prefill chunks, 16-token KV blocks, prefix cache on) and
     the bf16 model, its chunked-prefill and rounds programs captured as
     CUDA graphs.  Checks on the captured engine: the eight prompts as
     one concurrent burst, two requests sharing a 1024-token prefix, one
     request with the card's sync debug mode at "error"; every reply
     prompt + max_new_tokens tokens in the vocabulary, no flash kernel
     launched, :stats showing the slots reused, a prefix hit and the JAX
     engine's compiled_programs(); the same engine with the float32
     model (TF32 off) must give generate()'s greedy tokens on four
     prompts; one captured round of 8 steps at 8 live slots must equal
     the eager decode_rounds on the same state (tokens, counts,
     steps_run and the slot scalars), and one captured round runs under
     sync debug mode "error".  Information only, in the same call: the
     capture time and graph-pool bytes; the same burst through the
     engine with cuda_graphs=False and through the static batcher
     (--lm_static_batcher), each with requests/s, tokens/s, TTFT and
     latency p50/p99; the bf16 engine's first difference from bf16
     generate() per prompt; the captured and the eager round at 8 live
     slots in turns, with their device busy shares and the paged-view
     gathers' share under torch.profiler, and one 64-token prefill chunk
     captured and eager;
 6c. speculation: the same server with --speculative_tokens 4 (bf16,
     the engine defaults; its verify program captured beside the
     others) answers a burst of 8 prompts, 4 tiling a random 4-token
     pattern and 4 random (256-1024 tokens); every reply prompt +
     max_new_tokens tokens in the vocabulary, :stats showing verify
     calls (spec_steps > 0) and the JAX engine's compiled_programs()
     for these flags with "verify": 1, no flash kernel launched; at
     float32 (TF32 off) the captured engine with speculation on and
     off gives generate()'s greedy tokens on 4 of the prompts (a
     difference prints the top-2 logit gap where it starts); one
     captured verify call at 8 live slots (a fully accepted window,
     rejected ones, a slot with one token of budget, a retired slot)
     equals the eager verify_step on the same state (tokens, emit,
     lengths, last_token, done; pool within 1e-6), and one runs under
     sync debug mode "error".  Information only: the burst's tokens/s,
     TTFT and latency p50/p99 with speculation on and (same server)
     off, the acceptance, whether the throughput gate was open, and
     the verify call's time beside a captured round of 8 steps;
 6d. tiers: a --role prefill and a --role decode server on the same
     export (/readyz shows each role).  :prefill of a 1024-token prompt
     answers a kv_handoff covering 1008 tokens in 49,545,216 bytes of
     bf16 pages; the decode server's NDJSON :generate with that payload
     streams what its engine answers unstreamed for the same payload,
     and the pages it imported, gathered back, are the exported bytes;
     a 16-token prompt exports nothing; no flash kernel launched; at
     float32 a decode-tier engine importing a prefill-tier engine's
     pages gives the unified engine's and generate()'s tokens on 2
     prompts.  Information only: the payload's bytes, its encode and
     decode time, the :prefill latency, and the decode tier's TTFT
     beside the unified engine's on the same prompt;
 6e. int8: the same weights exported with quantize and kv_cache int8
     (the JAX loader's keys), served over REST through the captured
     engine (int8 weights on the card, an int8 pool of 405,504-byte
     pages with float32 scales) and through the static batcher: every
     reply prompt + max_new_tokens tokens in the vocabulary, the JAX
     engine's compiled_programs(), no flash kernel launched; at float32
     the captured int8 engine gives int8 generate()'s greedy tokens on 4
     prompts; in bf16 the first-step logits of int8 weights over an int8
     cache reach cosine > 0.99 against the unquantized model's.
     Information only: the weight bytes on the card against bf16, the
     pool bytes a page against bf16, a captured round of 8 steps and a
     verify call at 8 live slots on an int8 state beside phase 6b's bf16
     round, and the int8 -> bf16 weight converts' share of the round's
     device time;
 6f. spill tier: a server with --kv_pool_blocks 128 and
     --host_spill_blocks 1024 parks eight sessions of 512-1024 prompt
     tokens (park_kv), more pages than its pool holds: it must spill,
     never shed, never destroy-evict, and every second turn must equal
     that of a control server with the default pool; a failover, the
     parking server's :fetch_kv of a session resumed on a fresh server
     with resume_tokens over :generate, gives the parking server's
     tokens, for the bf16 export and for the int8 one; no flash kernel
     launched.  Information only: pages spilled out and re-imported,
     spill-out and re-import ms a page, the resume TTFT against the
     cold prefill's, and the fetched payload's bytes and its encode and
     decode time;
 6g. adapters: three seeded rank-4 adapters (alpha, beta, gamma; factor
     scale 0.05) written with the port's save_adapter and served with
     --adapters_dir at the engine defaults (--adapter_slots 8, programs
     captured): a REST burst of eight :predict requests, two each of lm,
     lm@alpha, lm@beta and lm@gamma, every reply prompt + max_new_tokens
     tokens in the vocabulary, :stats with the three resident and the
     JAX engine's compiled_programs(), /readyz advertising them,
     lm@ghost answering 404.  At float32 (TF32 off): each co-batched
     request equals its run alone on the same engine, base rows equal a
     base-only engine's, each variant differs from base, the engine
     captured and ran the base-only engine's programs; in a 2-slot
     registry a hot load with one adapter pinned evicts only the idle
     one, and the evicted adapter reloaded into another's row decodes
     its tokens again through the graphs captured at construction.  No
     flash kernel launched.  Information only (bf16): the burst's TTFT
     and tokens/s, the stack's bytes on the card, one hot load's ms,
     and a captured round of 8 steps at 8 live slots with mixed adapter
     rows against the same round with no adapter stack;
  7. train: the port's LM training entry point (tools/train_lm.run) on
     bench.py's LM configuration (batch 8 x 2048, flash, remat, adamw
     1e-3) for a few steps, launch counters zeroed just before and read
     just after: flash_fwd, flash_dq and flash_dkv must each launch 12
     times a step; losses and grad_norm finite; step time, tokens/s, MFU
     and peak memory printed; then the same cell with the two-pass
     forward (--flash-block-diag 256, adafactor 1e-3, 2 steps a call)
     through lm_task and Trainer as bench.py builds it: flash_fwd_full,
     flash_fwd_diag, flash_dq and flash_dkv 12 times a step, flash_fwd
     never;
  8. gradients: one step's gradients of the bf16 model (full width and
     depth, batch 2 x 2048) through the kernels (single pass, then two
     passes) and through the plain versions, each held to a float32 run
     of the same weights with plain attention: a kernel path may be at
     most 1.25x further from it;
  9. learning: Trainer.fit for 20 steps on one repeated batch must lower
     the loss by at least 1 nat; then (information only) one profiled
     training step: device busy share, the kernels with the most device
     time, and the share of flash fwd, dq and dkv;
 10. checkpoints and data: tools/train_lm.run with adafactor, KFTR
     shards written by the port and verified checkpoints every 2 steps:
     the saved steps verify, a rerun resumes after the last one, a
     truncated newest step is walked back over; one save and one
     restore timed;
 11. CNN serve: a seeded ResNet-50 (224 x 224) and Inception-v3 (299 x
     299), 1000 classes, every leaf drawn from numpy, exported under the
     JAX loader name and served by the port's REST server with
     --micro_batch_size 8 (the classifier loader, the MicroBatcher): a
     concurrent burst of 16 :predict requests per model (uint8 pixel
     lists and float32 lists in turns), one :predict and one :classify
     of one image alone, one direct 8-row request.  Every reply's scores
     sum to 1 within 1e-3 with the top k their sorted head; :classify
     gives :predict's top k; each served row equals the loader's own
     predict on the same image at a batch size the batcher served; the
     bf16 logits are within a bound (relative Frobenius) of a float32 run
     of the same weights, and a control run with BatchNorm normalizing in
     bf16 is not (2.6e-3 for ResNet-50, 1.9e-3 for Inception-v3); no flash
     kernel launches.  Information only:
     requests/s, latency p50/p99, the batch-size histogram, and one
     batch of 8 under torch.profiler (busy share, top kernels);
 12. CNN train: tools/train_cnn.run on bench.py's ResNet-50 cell (batch
     256 x 224 x 224, bf16, sgd 0.1 with momentum 0.9, synthetic data)
     for 4 steps with checkpoints every 2: losses finite, the saved
     steps verify; Trainer.fit for 30 steps on one repeated batch of 32
     must bring the mean loss of the last 5 below the first; no flash
     kernel launches.  Information only: the step on a batch staged on
     the card (time, images/s, MFU, peak memory) and one profiled step.

The phases' times are printed.  The line before the last is a JSON
object {"kernels": [...]}; the last is {"ok": true, "device": {...}}.
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
# Phase 6b: two engine requests share a prefix of this many tokens; the
# engine's prefill chunk width (the CLI default).
SHARED_PREFIX = 1024
CHUNK = 64
# Phase 6c: the server's --speculative_tokens, and the burst's prompt
# lengths (a tiled and a random prompt of each).
SPEC_TOKENS = 4
SPEC_LENS = (256, 512, 768, 1024)
# Phase 6d: the handed-off prompt, and its bf16 pages' bytes: 12 layers x
# 1008 covered positions (63 full 16-token pages, at most length - 1) x 8
# kv heads x 128 x 2 bytes x 2 sides.
HANDOFF_LEN = 1024
HANDOFF_BYTES = 12 * 1008 * 8 * 128 * 2 * 2
# Phase 6e: the int8 export's config keys, and a pool page's bytes by the
# code: 12 layers x 16 positions x 8 kv heads x (128 int8 values + one
# float32 scale) x 2 sides, against 12 x 16 x 8 x 128 x 2 bytes x 2 sides
# in bf16.  The float32 identity's prompt lengths; the cosine bound of
# tests/test_quantize.py.
INT8_CONFIG = {"quantize": "int8", "kv_cache": "int8"}
INT8_PAGE_BYTES = 12 * 16 * 8 * (128 + 4) * 2
BF16_PAGE_BYTES = 12 * 16 * 8 * 128 * 2 * 2
INT8_LENS = (300, 170, 410, 90)
INT8_COSINE = 0.99
# Phase 6f: the spilling server's pool and host tier in pages, the parked
# sessions' prompt lengths (their contexts fill 346 pages), the new
# tokens of each second turn, and the tokens a failed-over request had
# delivered before its :fetch_kv.
SPILL_POOL, SPILL_HOST = 128, 1024
SPILL_LENS = (512, 1024, 576, 640, 512, 704, 544, 768)
TURN2_NEW = 16
FETCH_DELIVERED = 8
# Phase 6g: three seeded adapters at rank 4 whose factors are drawn at
# random_adapter_factors' default scale of 0.05 (each variant's greedy
# tokens must differ from base), and the two prompts each of base and the
# three variants decodes.
ADAPTERS = ("alpha", "beta", "gamma")
ADAPTER_RANK = 4
ADAPTER_SCALE = 0.05
ADAPTER_LENS = (300, 170)
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
    "flash_fwd_full": "kubeflow_tpu/ops/flash.py:241",
    "flash_fwd_diag": "kubeflow_tpu/ops/flash.py:291",
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
# bench.py --model lm --flash-block-diag 256 --optimizer adafactor
# --steps-per-call 2: the two-pass forward's (block_q, block_k,
# block_diag) on the training path.
TWO_PASS_BLOCKS = (512, 1024, 256)
TWO_PASS_STEPS, TWO_PASS_STEPS_PER_CALL = 6, 2
TWO_PASS_KERNELS = ("flash_fwd_full", "flash_fwd_diag", "flash_dq",
                    "flash_dkv")
# The checkpoint and data phase: train_lm.run on the bench flags, saving
# every CKPT_EVERY steps, over KFTR shards of CKPT_EXAMPLES examples.
CKPT_EVERY, CKPT_EXAMPLES, CKPT_SHARDS = 2, 64, 4
LEARN_STEPS, LEARN_BATCH, LEARN_VOCAB = 20, 2, 512
# Phases 11-12: the CNN family.  Phase 11 serves these exports through the
# classifier loader and the MicroBatcher; each model's name, its loader
# config and its image size (the canonical input of each).
CNN_SERVED = {
    "resnet": ({"family": "resnet50", "num_classes": 1000, "top_k": 5}, 224),
    "inception": ({"family": "inception_v3", "num_classes": 1000,
                   "top_k": 5}, 299),
}
CNN_LOADER = "kubeflow_tpu.serving.loaders:classifier"
CNN_MICRO_BATCH, CNN_BURST, CNN_DIRECT_ROWS = 8, 16, 8
# bf16 logits against a float32 run of the same weights (TF32 off): each
# model's relative Frobenius error bound, between its sound readings
# (NVIDIA H100 80GB HBM3 at 700 W, here: ResNet-50 2.05e-3, Inception-v3
# 1.49e-3) and its control run with BatchNorm normalizing in bf16
# (3.30e-3 and 2.42e-3), about 1.25x from each.  Phase 11 runs the
# control too: it must exceed the bound.
CNN_LOGITS_REL_TOL = {"resnet": 2.6e-3, "inception": 1.9e-3}
# bench.py's ResNet-50 cell (bench_resnet): 224 x 224, batch 256 a chip,
# bf16, optax.sgd(0.1, momentum=0.9); the flags of the port's entry point.
CNN_TRAIN_BATCH = 256
CNN_TRAIN_FLAGS = [
    "--model", "resnet50", "--image-size", "224", "--num-classes", "1000",
    "--batch-size-per-device", str(CNN_TRAIN_BATCH), "--dtype", "bfloat16",
    "--learning-rate", "0.1", "--device", "cuda"]
CNN_TRAIN_STEPS, CNN_CKPT_EVERY = 4, 2
CNN_LEARN_STEPS, CNN_LEARN_BATCH = 30, 32
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
        # The kernel's 128-row query and 128-key tiles: below one tile,
        # one past a tile, and key starts inside a tile.
        ("causal_below_one_tile", 4, 100, 100, 128, True, None),
        ("causal_one_past_a_tile", 4, 129, 129, 128, True, None),
        ("noncausal_one_past_tiles_d64", 4, 129, 257, 64, False, None),
        ("masked_start_inside_a_tile", 4, 300, 300, 128, True,
         [129, 200, 255, 1]),
    ]
    results = []
    for name, bh, sq, sk, d, causal, starts in variants:
        q, k, v, ks = make_inputs(torch, gen, bh, sq, sk, d, starts)
        o, lse = flash.flash_fwd(q, k, v, causal=causal, kv_start=ks)
        results.append(check_fwd(torch, flash, name, q, k, v, ks, causal,
                                 o, lse))
        del q, k, v, o, lse
    check_cross_head(torch, flash, gen)
    return results


def check_cross_head(torch, flash, gen):
    """Phase 2: heads of distinct magnitudes (k and v scaled by the head's
    index) at a length that ends inside a tile, each head held to the plain
    version on its own: a tile that read the next head's rows instead of
    the zeros the kernel's loads fill in past a head's end would show.
    Fails on disagreement; its errors (of scaled data) stay out of the
    kernels line."""
    bh, s, d = 6, 200, 128
    q, k, v, _ = make_inputs(torch, gen, bh, s, s, d, None)
    mag = torch.arange(1, bh + 1, device="cuda",
                       dtype=torch.float32)[:, None, None]
    k = (k.float() * (1 + mag / 4)).bfloat16()
    v = (v.float() * (1 + mag / 2)).bfloat16()
    for causal in (True, False):
        o, lse = flash.flash_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ro, rlse = flash.flash_fwd_reference(q.float(), k.float(),
                                             v.float(), causal=causal)
        for h in range(bh):
            compare_out(torch, f"cross_head_causal{int(causal)}_h{h}", o[h],
                        lse[h], ro[h], rlse[h],
                        f"head {h} of bh={bh} s={s} d={d} causal={causal}, "
                        f"k x {1 + (h + 1) / 4}, v x {1 + (h + 1) / 2}")


def check_fwd(torch, flash, name, q, k, v, ks, causal, o, lse):
    """The forward kernel's (o, lse) on these inputs against the plain
    version in float32; fails on disagreement, else returns the errors."""
    torch.cuda.synchronize()
    ro, rlse = flash.flash_fwd_reference(
        q.float(), k.float(), v.float(), causal=causal, kv_start=ks)
    row = compare_out(torch, name, o, lse, ro, rlse,
                      f"bh={q.shape[0]} sq={q.shape[1]} sk={k.shape[1]} "
                      f"d={q.shape[2]} causal={causal} "
                      f"masked={ks is not None}")
    return dict(row, masked=ks is not None)


def compare_out(torch, name, o, lse, ro, rlse, what):
    """(o, lse) of a kernel against its plain version's (ro, rlse) within
    O_TOL, O_REL_TOL and LSE_ATOL; fails on disagreement, else returns
    the errors.  Against a reference of all zeros (pass A where no row
    has a key: o = 0, lse = NEG_INF) the relative bound applies to the
    largest error itself."""
    err_o = (o.float() - ro).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    ref_norm = ro.norm().item()
    rel_o = ((o.float() - ro).norm().item() / ref_norm if ref_norm
             else err_o)
    ok_o = torch.allclose(o.float(), ro, **O_TOL) and rel_o <= O_REL_TOL
    ok_lse = torch.allclose(lse, rlse, atol=LSE_ATOL, rtol=0)
    finite = bool(torch.isfinite(o).all())
    log(f"check {name}: {what} max|o-ref|={err_o:.3e} "
        f"|o-ref|_F/|ref|_F={rel_o:.3e} max|lse-ref|={err_lse:.3e} "
        f"(bounds o atol/rtol {O_TOL['atol']}, o relative "
        f"{O_REL_TOL}, lse atol {LSE_ATOL})")
    if not (ok_o and ok_lse and finite):
        fail(f"kernel disagrees with its plain version on {name}")
    return {"variant": name, "max_abs_err_o": err_o, "rel_err_o": rel_o,
            "max_abs_err_lse": err_lse}


def check_two_pass_kernels(torch, flash, gen):
    """Phase 2, two-pass forward: pass A (flash_fwd_full) and pass B
    (flash_fwd_diag) each against its plain version, and their merge
    against the single pass's plain version, at the training shape and
    split, d 64, fitted blocks that are not multiples of 64 or of the
    128-row tile (per-row bounds), a length that is not a tile multiple
    and the pure band (pass A not launched); then a shape that fails the
    two-pass dispatch must launch neither pass."""
    bq, bk, bd = TWO_PASS_BLOCKS
    variants = [
        # name, bh, s, d, block_q, block_k
        ("train", TRAIN_BATCH * MODEL["n_heads"], TRAIN_SEQ, 128, bq, bk),
        ("d64", 16, TRAIN_SEQ, 64, bq, bk),
        ("bq32_bk64", 8, 128, 128, 32, 64),
        ("bq_bk32_s96", 8, 96, 64, 32, 32),
        ("bq_bk400_s1200", 8, 1200, 128, 400, 400),
        ("pure_band", 8, 1024, 128, bq, bk),
        # Fitted blocks that are multiples of 64 but not of the kernel's
        # 128-row or 128-key tile: per-row bounds.
        ("bq_bk192_s768", 8, 768, 128, 192, 192),
        ("bq64_bk128_s512_d64", 8, 512, 64, 64, 128),
    ]
    results = {"flash_fwd_full": [], "flash_fwd_diag": [], "merged": []}
    for name, bh, s, d, vq, vk in variants:
        q, k, v, _ = make_inputs(torch, gen, bh, s, s, d, None)
        ref = [t.float() for t in (q, k, v)]
        what = f"bh={bh} s={s} d={d} block_q={vq} block_k={vk}"
        for kernel, fn, plain in (
                ("flash_fwd_full", flash.flash_fwd_full,
                 flash.flash_fwd_full_reference),
                ("flash_fwd_diag", flash.flash_fwd_diag,
                 flash.flash_fwd_diag_reference)):
            o, lse = fn(q, k, v, block_q=vq, block_k=vk)
            torch.cuda.synchronize()
            results[kernel].append(compare_out(
                torch, f"{kernel}_{name}", o, lse,
                *plain(*ref, block_q=vq, block_k=vk), what))
        before = dict(flash.launch_counts)
        o, lse = flash.flash_fwd_two_pass(q, k, v, block_q=vq, block_k=vk,
                                          block_diag=bd)
        torch.cuda.synchronize()
        launched = {key: flash.launch_counts[key] - before[key]
                    for key in ("flash_fwd", "flash_fwd_full",
                                "flash_fwd_diag")}
        full = 0 if name == "pure_band" else 1
        if launched != {"flash_fwd": 0, "flash_fwd_full": full,
                        "flash_fwd_diag": 1}:
            fail(f"two-pass forward on {name} launched {launched}")
        results["merged"].append(compare_out(
            torch, f"two_pass_merged_{name}", o, lse,
            *flash.flash_fwd_reference(*ref, causal=True),
            f"{what} against the single pass's plain version"))
        del q, k, v, ref, o, lse
    q, k, v, _ = make_inputs(torch, gen, 8, TRAIN_SEQ, TRAIN_SEQ, 128, None)
    before = dict(flash.launch_counts)
    # sq <= block_k: the single pass.
    flash._fwd_dispatch(q, k, v, True, bq, TRAIN_SEQ, bd)
    torch.cuda.synchronize()
    launched = {key: flash.launch_counts[key] - before[key]
                for key in ("flash_fwd", "flash_fwd_full", "flash_fwd_diag")}
    if launched != {"flash_fwd": 1, "flash_fwd_full": 0, "flash_fwd_diag": 0}:
        fail(f"a shape outside the two-pass dispatch launched {launched}")
    log(f"check two-pass dispatch: s {TRAIN_SEQ} <= block_k {TRAIN_SEQ} "
        f"launched {launched}")
    return results


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
        # 1153 = 9 x 128 + 1: cuts dq's 128-row and 128-key tiles and
        # dkv's 128-key and 64-query tiles.
        ("causal_tile_cut_d128", 6, 1153, 1153, 128, True, False),
        # Causal sk > sq: dkv's key tiles from 256 on hold no live query
        # and must still write their zero dk and dv.
        ("causal_sk_gt_sq_zero_store", 4, 200, 777, 128, True, False),
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
        if causal and sk > sq and not (torch.all(got[1][:, sq:] == 0)
                                       and torch.all(got[2][:, sq:] == 0)):
            fail("keys past the last query got non-zero dk or dv")
        log(f"check bwd {name}: bh={bh} sq={sq} sk={sk} d={d} "
            f"causal={causal} neg_inf_rows={neg_inf}: {'; '.join(line)} "
            f"(bounds: relative {BWD_REL_TOL}, elementwise atol "
            f"{BWD_ELEM_TOL['atol']} rtol {BWD_ELEM_TOL['rtol']})")
        results.append(row)
        del q, k, v, g, o, lse, delta, got, want
    return results


def check_bwd_heads_apart(torch, flash):
    """Phase 2, backward: heads of distinct magnitudes (q, k, v and g
    scaled up to 4x by the head's index) at a length that ends inside
    every tile, as tests/test_torch_flash_bwd_cuda.py's
    test_heads_stay_apart builds them: each head's relative Frobenius
    error and its largest error over the head's RMS, for dq, dk and dv.
    A head that read another head's rows would stand apart from the
    rest; a scale effect moves them together.  Fails when a head's
    relative error exceeds BWD_REL_TOL."""
    import numpy as np

    bh, s = 6, 200
    rng = np.random.default_rng(5)
    worst = 0.0
    for d in (64, 128):
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (bh, s, d), np.float32)).to("cuda", torch.bfloat16)
            for _ in range(4))
        mag = torch.arange(1, bh + 1, device="cuda",
                           dtype=torch.float32)[:, None, None]
        q, k, v, g = ((t.float() * (1 + mag / f)).bfloat16()
                      for t, f in ((q, 8), (k, 4), (v, 2), (g, 3)))
        for causal in (True, False):
            o, lse = flash.flash_fwd(q, k, v, causal=causal)
            delta = (g.float() * o.float()).sum(-1)
            got = flash.flash_bwd(q, k, v, g, lse, delta, causal=causal)
            torch.cuda.synchronize()
            ref = flash.flash_bwd_reference(q.float(), k.float(), v.float(),
                                            g.float(), lse, delta,
                                            causal=causal)
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                cells = []
                for h in range(bh):
                    err = a[h].float() - b[h].float()
                    rel = (err.norm() / b[h].float().norm()).item()
                    rms = b[h].float().pow(2).mean().sqrt()
                    worst = max(worst, rel)
                    cells.append(f"h{h} {rel:.3e} "
                                 f"{(err.abs().max() / rms).item():.3e}")
                log(f"check bwd heads apart d={d} causal={causal} {name} "
                    f"(relative Frobenius, max|err|/rms per head): "
                    + "; ".join(cells))
    if worst > BWD_REL_TOL:
        fail(f"a head's backward error {worst:.3e} exceeds {BWD_REL_TOL}")


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
        self.saved = f._flash_fwd_cuda, f._flash_bwd_cuda, \
            f._flash_fwd_pass_cuda
        plain = {"flash_fwd_full": f.flash_fwd_full_reference,
                 "flash_fwd_diag": f.flash_fwd_diag_reference}

        def fwd(q, k, v, *, causal, kv_start=None):
            return f.flash_fwd_reference(q, k, v, causal=causal,
                                         kv_start=kv_start)

        def one_pass(name, q, k, v, *, block_q, block_k):
            return plain[name](q, k, v, block_q=block_q, block_k=block_k)

        f._flash_fwd_cuda, f._flash_bwd_cuda, f._flash_fwd_pass_cuda = \
            fwd, f.flash_bwd_reference, one_pass
        return self

    def __exit__(self, *exc):
        (self.flash._flash_fwd_cuda, self.flash._flash_bwd_cuda,
         self.flash._flash_fwd_pass_cuda) = self.saved


def _instance(lib, entry, *args):
    """What a kernel instance uses, as the loaded kernel reports it through
    the C entry point ``entry``: registers a thread at entry (ptxas's
    count) and shared memory a CTA at launch."""
    import ctypes

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 2)()
    err = fn(*args, info)
    if err != 0:
        fail(f"instance query failed: {lib.kft_cuda_error_string(err)}")
    return dict(zip(("registers", "smem_bytes"), list(info)))


def instance_info(flash, d, causal, masked, pass_=0, bq=0, bk=0):
    """The forward instance launched for these arguments."""
    return _instance(flash._lib(), "kft_flash_fwd_instance_bf16", d,
                     int(causal), int(masked), pass_, bq, bk)


def bwd_instance_info(flash, name, d, causal):
    """The dq or dkv instance launched for these arguments."""
    return _instance(flash._bwd_lib(), "kft_flash_bwd_instance_bf16",
                     int(name == "flash_dkv"), d, int(causal))


def row_stats(row, ops):
    """TFLOP/s and share of its bound of a timed row, in place."""
    row["tflops"] = ops / (row["ms"] * 1e-3) / 1e12
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return (f"{row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} of its "
            f"bound; instance {row['instance']['registers']} registers, "
            f"{row['instance']['smem_bytes']} bytes shared memory")


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
            "instance": instance_info(flash, d, True, ks is not None),
        }
        stats = row_stats(rows[name], ops)
        log(f"time {name}: bh={bh} s={s} d={d} kernel {ms:.4f} ms ({stats})"
            f", plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
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
    # The float32 row sum delta = rowsum(g * o) that _FlashFunction's
    # backward computes before the pair (SDPA's backward includes its own).
    delta_ms = time_ms(torch, lambda: (g.float() * o.float()).sum(-1),
                       reps=20)
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
        }
        log(f"time {name} (training shape): bh={bh} s={s} d={d} kernel "
            f"{ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {t_bound:.4f} "
            f"ms ({by}; operations {t_ops:.4f} ms for {ops:.4g}, bytes "
            f"{t_bytes:.4f} ms for {nbytes:.4g})")
    for name in ("flash_dq", "flash_dkv"):
        rows[name]["instance"] = bwd_instance_info(flash, name, d, True)
        log(f"time {name} (training shape): "
            f"{row_stats(rows[name], work[name][3])}")
        rows[name]["library_note"] = (
            "backward of one causal SDPA call: dq, dk and dv together")
        rows[name]["delta_pass_ms"] = delta_ms
        rows[name]["max_abs_err"] = max(
            c[f"max_abs_err_{g_}"] for c in bwd_checks
            for g_ in (("dq",) if name == "flash_dq" else ("dk", "dv")))
        rows[name]["checks"] = bwd_checks
    log(f"time backward pair: dq + dkv {dq_ms + dkv_ms:.4f} ms, with the "
        f"float32 delta pass ({delta_ms:.4f} ms) "
        f"{dq_ms + dkv_ms + delta_ms:.4f} ms, against the SDPA backward's "
        f"{bwd_lib:.4f} ms (its own row sum included)")
    rows["flash_fwd"]["instance"] = instance_info(flash, d, True, False)
    log(f"time flash_fwd (training shape): "
        f"{row_stats(rows['flash_fwd'], work['flash_fwd'][3])}")
    # The forward's row keeps the serving shape's numbers at its top level
    # (as the serving slice defined them); the training shape's stand in
    # its train_shape object.
    train_fwd = rows.pop("flash_fwd")
    fwd_rows["flash_fwd"]["train_shape"] = {
        key: train_fwd[key] for key in
        ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ops_bound_ms",
         "bytes_bound_ms", "library_ms", "tflops", "bound_share",
         "instance")}
    del q, k, v, g, o, lse, delta, q4, k4, v4, out4
    return rows


def two_pass_work(bh, s, bq, bk):
    """Per pass, what the two-pass split needs: (pairs attended, query
    rows with at least one key, key rows some query attends), and each
    row's boundary.  Pass A: keys [0, boundary(r)); pass B: [boundary(r),
    r], so every key is its own row's."""
    bnd = [((r // bq) * bq // bk) * bk for r in range(s)]
    full = (bh * sum(bnd), bh * sum(b > 0 for b in bnd), bh * max(bnd))
    diag = (bh * sum(r - b + 1 for r, b in enumerate(bnd)), bh * s, bh * s)
    return full, diag, bnd


def time_two_pass(torch, flash, gen, checks):
    """Phase 3, two-pass forward at the training shape and split: pass A,
    pass B, the merge and the whole two-pass forward, beside the
    single-pass kernel on the same inputs.  Yardsticks: pass A, one SDPA
    call of the rows past the split against the keys before it (every
    such row's boundary); pass B, SDPA with the band's boolean mask; the
    two-pass forward, SDPA is_causal."""
    import torch.nn.functional as F

    heads, d = MODEL["n_heads"], MODEL["head_dim"]
    bh, s = TRAIN_BATCH * heads, TRAIN_SEQ
    bq, bk, bd = TWO_PASS_BLOCKS
    q, k, v, _ = make_inputs(torch, gen, bh, s, s, d, None)
    fns = {
        "flash_fwd_full": (lambda: flash.flash_fwd_full(
            q, k, v, block_q=bq, block_k=bk), lambda: (
            flash.flash_fwd_full_reference(q, k, v, block_q=bq,
                                           block_k=bk))),
        "flash_fwd_diag": (lambda: flash.flash_fwd_diag(
            q, k, v, block_q=bq, block_k=bk), lambda: (
            flash.flash_fwd_diag_reference(q, k, v, block_q=bq,
                                           block_k=bk))),
    }
    full_work, diag_work, bnd = two_pass_work(bh, s, bq, bk)
    split = bnd[-1]
    if any(b != split for b in bnd[split:]):
        fail("the training split's rows past the boundary differ")
    q4, k4, v4 = (t.reshape(TRAIN_BATCH, heads, s, d) for t in (q, k, v))
    pos = torch.arange(s, device="cuda")
    band = ((pos[None, :] >= torch.tensor(bnd, device="cuda")[:, None])
            & (pos[None, :] <= pos[:, None]))
    library = {
        "flash_fwd_full": lambda: F.scaled_dot_product_attention(
            q4[:, :, split:], k4[:, :, :split], v4[:, :, :split]),
        "flash_fwd_diag": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=band),
    }
    rows = {}
    work = {"flash_fwd_full": full_work, "flash_fwd_diag": diag_work}
    for name, (kernel, plain) in fns.items():
        ms = time_ms(torch, kernel, reps=20)
        plain_ms = time_ms(torch, plain, reps=3)
        lib_ms = time_ms(torch, library[name], reps=20)
        pairs, q_rows, kv_rows = work[name]
        ops = 4 * d * pairs
        # bf16 q of the rows with keys, k and v of the keys attended, read
        # once; o (bf16) and lse (f32) of every row written once.
        nbytes = 2 * d * (q_rows + 2 * kv_rows) + 2 * bh * s * d + 4 * bh * s
        t_bound, by, t_ops, t_bytes = bound(ops, nbytes)
        rows[name] = {
            "name": name, "route": "cuda", "source": FWD_SOURCE,
            "replaces": TPU_KERNELS[name],
            "shape": {"bh": bh, "s": s, "d": d, "block_q": bq,
                      "block_k": bk, "block_diag": bd},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bound,
            "bound_by": by, "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "library_ms": lib_ms,
            "max_abs_err": max(c["max_abs_err_o"] for c in checks[name]),
            "checks": checks[name],
            "instance": instance_info(flash, d, True, False,
                                      flash._PASSES[name], bq, bk),
        }
        stats = row_stats(rows[name], ops)
        log(f"time {name} (training shape): bh={bh} s={s} d={d} block_q="
            f"{bq} block_k={bk}: kernel {ms:.4f} ms "
            f"({stats}), plain {plain_ms:.4f} ms,"
            f" sdpa {lib_ms:.4f} ms, bound {t_bound:.4f} ms ({by}; "
            f"operations {t_ops:.4f} ms for {ops:.4g}, bytes {t_bytes:.4f} "
            f"ms for {nbytes:.4g})")
    (o_a, lse_a), (o_b, lse_b) = fns["flash_fwd_full"][0](), \
        fns["flash_fwd_diag"][0]()
    merge_ms = time_ms(torch, lambda: flash.merge_partials(
        o_a, lse_a, o_b, lse_b), reps=20)
    total_ms = time_ms(torch, lambda: flash.flash_fwd_two_pass(
        q, k, v, block_q=bq, block_k=bk, block_diag=bd), reps=20)
    single_ms = time_ms(torch, lambda: flash.flash_fwd(q, k, v, causal=True),
                        reps=20)
    causal_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), reps=20)
    summary = {
        "pass_a_ms": rows["flash_fwd_full"]["ms"],
        "pass_b_ms": rows["flash_fwd_diag"]["ms"], "merge_ms": merge_ms,
        "two_pass_ms": total_ms, "single_pass_kernel_ms": single_ms,
        "sdpa_causal_ms": causal_ms,
        "max_abs_err_merged": max(c["max_abs_err_o"]
                                  for c in checks["merged"]),
    }
    log(f"time two-pass forward (training shape): pass A "
        f"{summary['pass_a_ms']:.4f} + pass B {summary['pass_b_ms']:.4f} + "
        f"merge {merge_ms:.4f} ms; whole call {total_ms:.4f} ms against the "
        f"single-pass kernel's {single_ms:.4f} ms and SDPA is_causal's "
        f"{causal_ms:.4f} ms")
    del q, k, v, q4, k4, v4, band, o_a, lse_a, o_b, lse_b
    return rows, summary


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


def post(port: int, body: dict, path: str = "/model/lm:predict") -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"POST {path} answered {resp.status}: {payload}")
    return payload


def serve(torch, flash, base: Path, prompts, direct):
    """Phase 4: the port's serving entry point, driven over REST, on the
    static bucketed batcher (--lm_static_batcher: the engine is the
    default for lm_generate models and launches no flash kernel)."""
    from kubeflow_tpu_torch.serving import main as serving_main

    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base),
        "--port", "0", "--host", "127.0.0.1", "--device", "cuda",
        "--lm_static_batcher", "--lm_buckets", BUCKETS,
        "--micro_batch_size", str(MICRO_BATCH)])
    port = httpd.server_address[1]
    try:
        # One short request first, so the timed burst does not carry the
        # process's one-off CUDA and cuBLAS start-up.
        post(port, {"instances": [{"tokens": prompts[0][:16]}]})
        for key in flash.launch_counts:
            flash.launch_counts[key] = 0
        replies, latencies, t_batched = burst(port, prompts)
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


def pct(values, q):
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(len(ordered) * q))]


def burst(port: int, prompts):
    """Every prompt as its own concurrent :predict request; returns the
    replies, each request's latency and the burst's wall time (host
    clock)."""
    replies = [None] * len(prompts)
    latencies = [None] * len(prompts)

    def call(i):
        t = time.perf_counter()
        replies[i] = post(port, {"instances": [{"tokens": prompts[i]}]})
        latencies[i] = time.perf_counter() - t

    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or None in replies:
        fail("a request of the burst did not complete")
    return replies, latencies, time.perf_counter() - t0


def get(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        payload = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"GET {path} answered {resp.status}: {payload}")
    return payload


def engine_prefill_width() -> int:
    """The serving entry point's engine prefill width for these flags:
    the largest bucket, clamped to the prompt room."""
    return min(max(int(b) for b in BUCKETS.split(",")),
               MODEL["max_seq_len"] - MAX_NEW_TOKENS)


def burst_info(prompts, latencies, t_burst, stats) -> dict:
    """Throughput and latency of one burst; TTFT from the engine's clock
    (the static batcher returns no token before its last: None)."""
    n_tok = len(prompts) * MAX_NEW_TOKENS
    return {
        "burst_s": t_burst,
        "requests_per_s": len(prompts) / t_burst,
        "tokens_per_s": n_tok / t_burst,
        "ttft_p50_ms": stats.get("ttft_p50_ms"),
        "ttft_p99_ms": stats.get("ttft_p99_ms"),
        "latency_p50_s": pct(latencies, 0.5),
        "latency_p99_s": pct(latencies, 0.99),
    }


def log_burst(what: str, info: dict) -> None:
    ttft = ("TTFT not delivered before the last token"
            if info["ttft_p50_ms"] is None else
            f"TTFT p50 {info['ttft_p50_ms']:.1f} ms p99 "
            f"{info['ttft_p99_ms']:.1f} ms (engine clock)")
    log(f"{what} burst: {info['burst_s']:.3f} s, "
        f"{info['requests_per_s']:.3f} requests/s, "
        f"{info['tokens_per_s']:.1f} generated tokens/s; {ttft}; latency "
        f"p50 {info['latency_p50_s']:.3f} s p99 "
        f"{info['latency_p99_s']:.3f} s (client clock; information only; "
        f"{card_line()})")


def serve_engine(torch, flash, base: Path, prompts):
    """Phase 6b: the port's serving entry point with the JAX CLI's engine
    defaults (8 slots, fused rounds of 8, 64-token chunks, 16-token
    blocks, prefix cache on), the bf16 188M LM at full width and depth,
    its programs captured as CUDA graphs.  The eight prompts as one
    concurrent burst, then two requests that share a 1024-token prefix,
    then one request with the card's sync debug mode at "error".  No
    flash kernel may launch; :stats must show the slots reused, a prefix
    hit, and the JAX engine's compiled_programs() for these flags.  Then
    (information only) the same burst through the same server with the
    engine's programs run eagerly (cuda_graphs=False), then through the
    static batcher."""
    from kubeflow_tpu_torch.serving import main as serving_main
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    def eager_engine(loaded):
        spec = loaded.predict.engine_spec
        return DecodeEngine(spec["model"], spec["decode"], slots=8,
                            prefill_len=engine_prefill_width(),
                            decode_rounds=8, name="lm-eager",
                            cuda_graphs=False)

    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base),
        "--port", "0", "--host", "127.0.0.1", "--device", "cuda",
        "--lm_buckets", BUCKETS])
    port = httpd.server_address[1]
    rng = torch.Generator().manual_seed(SEED + 1)
    vocab = MODEL["vocab_size"]
    prefix = torch.randint(1, vocab, (SHARED_PREFIX,), generator=rng)
    pair = [(prefix.tolist() + torch.randint(1, vocab, (n,), generator=rng)
             .tolist()) for n in (100, 200)]
    launches_before = dict(flash.launch_counts)
    try:
        engine = server._batchers["lm"]
        if not engine.cuda_graphs or engine.capture_info is None:
            fail("the served engine did not capture its programs")
        capture = dict(engine.capture_info)
        replies, latencies, t_burst = burst(port, prompts)
        burst_stats = get(port, "/model/lm:stats")["batcher"]
        pair_replies = [post(port, {"instances": [{"tokens": p}]})
                        for p in pair]
        torch.cuda.set_sync_debug_mode("error")
        try:
            post(port, {"instances": [{"tokens": prompts[0][:64]}]})
        finally:
            torch.cuda.set_sync_debug_mode(0)
        stats = get(port, "/model/lm:stats")["batcher"]
        # The same burst, same server, engine programs run eagerly.
        server.enable_batching("lm", eager_engine)
        eager_replies, eager_lat, t_eager = burst(port, prompts)
        eager_stats = get(port, "/model/lm:stats")["batcher"]
        launches_engine = dict(flash.launch_counts)
        # And through the static batcher (--lm_static_batcher's).
        server.enable_batching("lm", serving_main.batcher_factory(
            micro_batch_size=MICRO_BATCH, batch_timeout_s=5e-3,
            lm_buckets=BUCKETS, lm_engine=False))
        static_replies, static_lat, t_static = burst(port, prompts)
    finally:
        serving_main.shutdown(server, httpd)
    if launches_engine != launches_before:
        fail("the engine path launched a flash kernel: "
             f"{launches_before} -> {launches_engine}")
    check_replies(prompts + pair, replies + pair_replies, [], None)
    check_replies(prompts, eager_replies, [], None)
    check_replies(prompts, static_replies, [], None)
    want_programs = {"chunked_prefill": 1, "step": 0, "verify": 0,
                     "decode_rounds": 1}
    for what, got in (("captured", stats), ("eager", eager_stats)):
        if got["compiled_programs"] != want_programs:
            fail(f"{what} engine compiled_programs "
                 f"{got['compiled_programs']}, the JAX engine reports "
                 f"{want_programs} for these flags")
    if stats["prefix_hits"] < 1 or stats["cached_prompt_tokens"] \
            < SHARED_PREFIX:
        fail(f"no prefix hit on the shared {SHARED_PREFIX}-token prefix: "
             f"{stats['prefix_hits']} hits, "
             f"{stats['cached_prompt_tokens']} cached tokens")
    if stats["requests"] <= stats["slots"] or stats["active_slots"] \
            or stats["in_flight_requests"]:
        fail(f"slots not reused and released: {stats['requests']} "
             f"requests through {stats['slots']} slots, "
             f"{stats['active_slots']} still active")
    info = {
        "capture": capture,
        "captured": dict(
            burst_info(prompts, latencies, t_burst, burst_stats),
            token_latency_p50_ms=burst_stats["token_latency_p50_ms"],
            steps_per_round_p50=burst_stats["steps_per_round_p50"],
            prefill_chunks=burst_stats["prefill_chunks"]),
        "eager": dict(
            burst_info(prompts, eager_lat, t_eager, eager_stats),
            token_latency_p50_ms=eager_stats["token_latency_p50_ms"]),
        "static": burst_info(prompts, static_lat, t_static, {}),
        "prefix_hits": stats["prefix_hits"],
        "cached_prompt_tokens": stats["cached_prompt_tokens"],
        "compiled_programs": stats["compiled_programs"],
    }
    log(f"engine capture: {capture['programs']} as CUDA graphs in "
        f"{capture['seconds']:.3f} s, graph pool {capture['pool_bytes']} "
        f"bytes")
    log_burst("captured engine", info["captured"])
    log_burst("eager engine (cuda_graphs=False)", info["eager"])
    log_burst("static batcher", info["static"])
    log(f"burst time, captured engine / eager engine / static batcher: "
        f"{t_burst:.3f} / {t_eager:.3f} / {t_static:.3f} s; the captured "
        f"engine's {info['captured']['prefill_chunks']} prefill chunks, "
        f"steps per round p50 {info['captured']['steps_per_round_p50']}")
    log(f"engine :stats: {stats['requests']} requests through "
        f"{stats['slots']} slots, prefix hits {stats['prefix_hits']} "
        f"({stats['cached_prompt_tokens']} cached tokens), "
        f"compiled_programs {stats['compiled_programs']}; one request "
        f"served under sync debug mode 'error'")
    return [r["predictions"][0]["tokens"] for r in replies], info


def engine_identity(torch, flash, base: Path, prompts, bf16_tokens):
    """Phase 6b, token identity: the same engine with the float32 model
    (TF32 off) on four of the prompts must give each prompt's greedy
    tokens of generate() alone at float32.  The bf16 engine's tokens
    against bf16 generate() are information only: the first position
    where the two differ, per prompt."""
    from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    model = load_model(torch, base, torch.float32)
    # Built after TF32 was switched off: the captured graphs keep the
    # math mode of their capture.
    engine = DecodeEngine(model, decode, slots=8,
                          prefill_len=engine_prefill_width(),
                          decode_rounds=8, name="fp32-identity")
    if not engine.cuda_graphs:
        fail("the float32 identity engine did not capture its programs")
    four = prompts[:4]
    outs = [None] * len(four)

    def call(i):
        outs[i] = engine.submit({"tokens": four[i]})["tokens"][0].tolist()

    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(four))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        engine.close()
    if None in outs:
        fail("a float32 engine request did not complete")
    with plain_kernels(flash):
        for prompt, got in zip(four, outs):
            want, _ = generate(model, torch.tensor([prompt]), decode)
            if got != want[0].tolist():
                fail(f"float32 engine tokens of a {len(prompt)}-token prompt "
                     "differ from generate() alone")
    log(f"captured engine token identity at float32: {len(four)} prompts "
        f"{[len(p) for p in four]} equal generate() alone, "
        f"{MAX_NEW_TOKENS} tokens each")
    del model
    model = load_model(torch, base, torch.bfloat16)
    firsts = []
    for prompt, got in zip(prompts, bf16_tokens):
        want, _ = generate(model, torch.tensor([prompt]), decode)
        new_got, new_want = got[len(prompt):], want[0, len(prompt):].tolist()
        firsts.append(next((j for j, (a, b) in enumerate(
            zip(new_got, new_want)) if a != b), None))
    log(f"bf16 engine against bf16 generate() alone, first differing new "
        f"token per prompt (None = identical; information only): {firsts}")
    return firsts


def engine_round(torch, base: Path):
    """Phase 6b, the fused round at 8 live slots (the burst's prompt
    lengths, pool and tables as the engine sizes them), called directly
    through the engine's Rounds program, captured and eager, on one
    state.  Checked: one captured round equals the eager decode_rounds
    on a copy of the same state (tokens, counts, steps_run, slot
    scalars), and one captured round runs under sync debug mode
    "error".  Information only: the captured and the eager round's time
    (host clock after a synchronize, median of 5, in turns), then under
    torch.profiler each one's device busy share, and the share of the
    device time the paged-view gathers take (one gather timed alone by
    CUDA events, times the round's 2 x layers x steps gathers); last,
    one 64-token prefill chunk at offset 1024, captured and eager, timed
    the same way."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import (
        DecodeConfig,
        _pool_with_scratch,
        decode_rounds,
        init_paged_state,
    )
    from kubeflow_tpu_torch.serving.programs import ChunkedPrefill, Rounds

    model = load_model(torch, base, torch.bfloat16)
    slots, bt, k = 8, 16, 8
    mb = -(-(engine_prefill_width() + MAX_NEW_TOKENS) // bt)
    nb = slots * mb

    def fresh():
        return init_paged_state(model.cfg, slots, nb, bt, device="cuda")

    state = fresh()
    tables = torch.full((slots, mb), nb, dtype=torch.int64, device="cuda")
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    progs = {"captured": Rounds(model, decode, state, tables, k, True),
             "eager": Rounds(model, decode, state, tables, k, False)}
    chunks = {"captured": ChunkedPrefill(model, decode, state, tables,
                                         CHUNK, True),
              "eager": ChunkedPrefill(model, decode, state, tables, CHUNK,
                                      False)}
    pool = torch.cuda.graph_pool_handle()
    t0 = time.perf_counter()
    with torch.inference_mode():       # on the fresh state, as the engine
        progs["captured"].capture(pool)
        chunks["captured"].capture(pool)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    tables.copy_(torch.arange(nb, device="cuda").view(slots, mb))
    lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device="cuda")
    live = {"lengths": lengths, "stop_len": lengths + MAX_NEW_TOKENS,
            "done": torch.zeros(slots, dtype=torch.bool, device="cuda"),
            "last_token": torch.randint(
                1, MODEL["vocab_size"], (slots,), dtype=torch.int32,
                device="cuda")}

    def reset():
        for name, value in live.items():
            state[name].copy_(value)

    def one_round(name):
        with torch.inference_mode():
            return progs[name].run(k)

    # Identity: the captured round against decode_rounds on a copy.
    reset()
    twin = fresh()
    for name, value in state.items():
        twin[name].copy_(value)
    with torch.inference_mode():
        twin, want_toks, want_counts, want_steps = decode_rounds(
            model, twin, decode, k, tables, k)
    toks, counts, steps = one_round("captured")
    torch.cuda.synchronize()
    if not (torch.equal(toks, want_toks) and torch.equal(counts, want_counts)
            and int(steps) == int(want_steps) == k
            and counts.tolist() == [k] * slots):
        fail(f"a captured round differs from decode_rounds: steps "
             f"{int(steps)} / {int(want_steps)}, counts {counts.tolist()} / "
             f"{want_counts.tolist()}")
    for name in ("lengths", "stop_len", "last_token", "done", "keys"):
        if not torch.equal(state[name], twin[name]):
            fail(f"a captured round's {name} differs from decode_rounds'")
    pool_err = max(float((state[n].float() - twin[n].float()).abs().max())
                   for n in ("cache_k", "cache_v"))
    del twin
    log(f"captured round equals decode_rounds on the same state: {k} "
        f"steps at {slots} slots, tokens, counts and slot scalars equal; "
        f"pool max |err| {pool_err:.3e}")

    def timed(name):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_round(name)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in progs:
        timed(name)
    times = {name: [] for name in progs}
    for i in range(5):
        for name in (("captured", "eager") if i % 2 == 0
                     else ("eager", "captured")):
            times[name].append(timed(name))
    round_ms = {name: sorted(t)[2] * 1e3 for name, t in times.items()}
    reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one_round("captured")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    info = {"steps": k, "slots": slots, "capture_s": capture_s,
            "pool_max_abs_err": pool_err}
    pool = _pool_with_scratch(state["cache_k"])[0]
    gather_ms = time_ms(torch, lambda: pool[tables], 20)
    gathers = 2 * MODEL["n_layers"] * k
    info.update(gather_ms=gather_ms, gathers_per_round=gathers)
    for name in progs:
        reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_round(name)
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        row = {"round_ms": round_ms[name], "profiled_ms": t_prof * 1e3}
        if busy_us == 0:
            log(f"{name} round: the profiler saw no device time; busy "
                "share and gather share not measured")
        else:
            kernels.sort(key=lambda e: e.self_device_time_total,
                         reverse=True)
            row.update(busy_ms=busy_us / 1e3,
                       busy_share=busy_us / (t_prof * 1e6),
                       gather_share=gather_ms * gathers / (busy_us / 1e3))
            log(f"{name} round under torch.profiler: wall "
                f"{t_prof * 1e3:.1f} ms, device busy {busy_us / 1e3:.2f} ms "
                f"({row['busy_share']:.3f} of the profiled wall); "
                f"paged-view gather {gather_ms:.4f} ms x {gathers} = "
                f"{gather_ms * gathers:.2f} ms, {row['gather_share']:.3f} "
                f"of busy")
            for e in kernels[:6]:
                log(f"  {e.self_device_time_total / busy_us:.3f} of busy, "
                    f"{e.count} launches: {e.key[:100]}")
        info[name] = row
    # One prefill chunk of slot 0's prompt at offset 1024, in turns.
    segment = torch.ones(CHUNK, dtype=torch.int64).numpy()
    chunk_times = {name: [] for name in chunks}
    for i in range(6):
        for name in (("captured", "eager") if i % 2 == 0
                     else ("eager", "captured")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                chunks[name].run(segment, 1024, 1100, MAX_NEW_TOKENS, 0, 0)
            torch.cuda.synchronize()
            chunk_times[name].append(time.perf_counter() - t0)
    info["chunk_ms"] = {name: sorted(t[1:])[2] * 1e3
                        for name, t in chunk_times.items()}
    for prog in (progs["captured"], chunks["captured"]):
        prog.release()
    log(f"engine prefill chunk of {CHUNK} tokens at offset 1024: captured "
        f"{info['chunk_ms']['captured']:.2f} ms, eager "
        f"{info['chunk_ms']['eager']:.2f} ms (host clock after "
        f"synchronize, median of 5 after one warm-up, in turns)")
    log(f"engine fused round, {k} steps at {slots} live slots (lengths "
        f"{list(PROMPT_LENS)}): captured {round_ms['captured']:.2f} ms "
        f"({round_ms['captured'] / k:.2f} ms a step), eager "
        f"{round_ms['eager']:.2f} ms ({round_ms['eager'] / k:.2f} ms a "
        f"step), in turns, host clock after synchronize, median of 5; "
        f"capture {capture_s:.3f} s; one captured round under sync debug "
        f"mode 'error' ({card_line()})")
    return info


# -- phase 6c: speculation --------------------------------------------------

def spec_prompts(torch, seed: int):
    """Phase 6c's burst: for each length, a prompt tiling a random
    4-token pattern and a random prompt, in turns (8 prompts)."""
    rng = torch.Generator().manual_seed(seed)
    vocab = MODEL["vocab_size"]
    prompts = []
    for n in SPEC_LENS:
        pattern = torch.randint(1, vocab, (4,), generator=rng).tolist()
        prompts.append((pattern * (n // 4 + 1))[:n])
        prompts.append(torch.randint(1, vocab, (n,), generator=rng).tolist())
    return prompts


def stream_generate(port: int, body: dict):
    """POST :generate and read its NDJSON stream line by line; returns
    (the streamed tokens, seconds to the first token line, seconds to the
    done line), client clock."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/model/lm:generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            fail(f"POST :generate answered {resp.status}: {resp.read()!r}")
        tokens, ttft, done = [], None, None
        while True:
            line = resp.readline()
            if not line:
                break
            msg = json.loads(line)
            if "tokens" in msg:
                ttft = ttft if ttft is not None else time.perf_counter() - t0
                tokens += msg["tokens"]
            elif msg.get("done"):
                done = time.perf_counter() - t0
            elif "error" in msg:
                fail(f":generate streamed an error line: {msg}")
    finally:
        conn.close()
    if done is None or ttft is None:
        fail(":generate ended without a token or a done line")
    return tokens, ttft, done


def first_difference(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def top2_gap(torch, flash, model, tokens) -> float:
    """The gap between the two largest next-token logits after
    ``tokens`` (plain attention): how near a tie a differing argmax
    was."""
    with plain_kernels(flash), torch.inference_mode():
        logits = model(torch.tensor([tokens], device="cuda"))[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def engine_tokens(engine, prompts, extra=None):
    """Every prompt as its own concurrent submit; the token lists."""
    outs = [None] * len(prompts)

    def call(i):
        inputs = {"tokens": prompts[i], **(extra[i] if extra else {})}
        outs[i] = engine.submit(inputs)["tokens"][0].tolist()

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if None in outs:
        fail(f"a request to engine {engine._metric_name!r} did not "
             "complete")
    return outs


def check_identity(torch, flash, model, what, prompts, got, want):
    """Fatal token identity, with the top-2 logit gap where the tokens
    first differ."""
    for prompt, a, b in zip(prompts, got, want):
        j = first_difference(a, b)
        if j is not None or len(a) != len(b):
            gap = top2_gap(torch, flash, model, b[:j]) if j else None
            fail(f"{what}: a {len(prompt)}-token prompt's tokens differ at "
                 f"position {j} of {len(b)}; the reference's top-2 logit "
                 f"gap there is {gap}")


def serve_spec(torch, flash, base: Path):
    """Phase 6c over REST: the server with --speculative_tokens 4 at the
    JAX CLI's engine defaults (bf16 model, programs captured), a burst of
    8 prompts (4 tiled, 4 random); then, information only, the same burst
    through the same server with speculation off."""
    from kubeflow_tpu_torch.serving import main as serving_main
    from kubeflow_tpu_torch.serving.engine import _SPEC_RATE_MARGIN

    prompts = spec_prompts(torch, SEED + 3)
    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base),
        "--port", "0", "--host", "127.0.0.1", "--device", "cuda",
        "--lm_buckets", BUCKETS, "--speculative_tokens", str(SPEC_TOKENS)])
    port = httpd.server_address[1]
    launches_before = dict(flash.launch_counts)
    try:
        engine = server._batchers["lm"]
        if engine.speculative_tokens != SPEC_TOKENS or not engine.cuda_graphs \
                or "Verify" not in engine.capture_info["programs"]:
            fail("the speculating engine did not capture its verify program")
        replies, latencies, t_burst = burst(port, prompts)
        stats = get(port, "/model/lm:stats")["batcher"]
        gate = {"verify_rate_ema": engine._rate_verify_ema,
                "step_rate_ema": engine._rate_step_ema}
        server.enable_batching("lm", serving_main.batcher_factory(
            micro_batch_size=0, batch_timeout_s=5e-3, lm_buckets=BUCKETS,
            decode_rounds=8))
        off_replies, off_lat, t_off = burst(port, prompts)
        off_stats = get(port, "/model/lm:stats")["batcher"]
    finally:
        serving_main.shutdown(server, httpd)
    if dict(flash.launch_counts) != launches_before:
        fail("the speculating engine launched a flash kernel")
    check_replies(prompts, replies, [], None)
    check_replies(prompts, off_replies, [], None)
    want_programs = {"chunked_prefill": 1, "step": 0, "verify": 1,
                     "decode_rounds": 1}
    if stats["spec_steps"] <= 0:
        fail(f"no verify call ran in the speculating burst: {stats}")
    if stats["compiled_programs"] != want_programs:
        fail(f"speculating engine compiled_programs "
             f"{stats['compiled_programs']}, the JAX engine reports "
             f"{want_programs} under these flags")
    gate_open = (gate["verify_rate_ema"] is not None
                 and gate["step_rate_ema"] is not None
                 and gate["verify_rate_ema"]
                 >= _SPEC_RATE_MARGIN * gate["step_rate_ema"])
    on_tokens = [r["predictions"][0]["tokens"] for r in replies]
    off_tokens = [r["predictions"][0]["tokens"] for r in off_replies]
    info = {
        "on": burst_info(prompts, latencies, t_burst, stats),
        "off": burst_info(prompts, off_lat, t_off, off_stats),
        "spec_steps": stats["spec_steps"],
        "spec_drafted": stats["spec_drafted"],
        "spec_accepted": stats["spec_accepted"],
        "spec_acceptance_rate": stats["spec_acceptance_rate"],
        "accepted_per_step": stats["accepted_per_step"],
        "fused_rounds": stats["fused_rounds"],
        "gate": dict(gate, open=gate_open),
        "bf16_on_off_first_difference": [
            first_difference(a, b) for a, b in zip(on_tokens, off_tokens)],
        "compiled_programs": stats["compiled_programs"],
    }
    log_burst("speculating engine (--speculative_tokens 4)", info["on"])
    log_burst("same server, speculation off", info["off"])
    log(f"speculation: {stats['spec_steps']} verify calls beside "
        f"{stats['fused_rounds']} fused rounds, drafted "
        f"{stats['spec_drafted']}, accepted {stats['spec_accepted']} "
        f"(rate {stats['spec_acceptance_rate']}, "
        f"{stats['accepted_per_step']} extra tokens a verify call); "
        f"throughput gate {'open' if gate_open else 'closed'} at the end "
        f"(verify {gate['verify_rate_ema']} / round "
        f"{gate['step_rate_ema']} delivered tokens/s EMA); bf16 on/off "
        f"first differing position per prompt "
        f"{info['bf16_on_off_first_difference']} (information only)")
    return info


def spec_identity(torch, flash, base: Path):
    """Phase 6c, token identity at float32 (TF32 off): the captured
    engine with speculation on and off, and generate() alone, on 4 of
    the burst's prompts (tiled and random in turns)."""
    from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    prompts = spec_prompts(torch, SEED + 3)[:4]
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    model = load_model(torch, base, torch.float32)
    outs, stats = {}, {}
    for spec in (SPEC_TOKENS, 0):
        engine = DecodeEngine(model, decode, slots=8,
                              prefill_len=engine_prefill_width(),
                              decode_rounds=8, speculative_tokens=spec,
                              name=f"fp32-spec{spec}")
        try:
            outs[spec] = engine_tokens(engine, prompts)
            stats[spec] = engine.stats()
        finally:
            engine.close()
    with plain_kernels(flash):
        want = [generate(model, torch.tensor([p]), decode)[0][0].tolist()
                for p in prompts]
    check_identity(torch, flash, model, "float32 engine, speculation on",
                   prompts, outs[SPEC_TOKENS], want)
    check_identity(torch, flash, model, "float32 engine, speculation off",
                   prompts, outs[0], want)
    on = stats[SPEC_TOKENS]
    log(f"float32 token identity: the engine with speculation on "
        f"({on['spec_steps']} verify calls, {on['spec_accepted']} of "
        f"{on['spec_drafted']} drafts accepted) and off equal generate() "
        f"alone on {len(prompts)} prompts {[len(p) for p in prompts]}, "
        f"{MAX_NEW_TOKENS} tokens each")
    del model
    return {"verify_calls": on["spec_steps"],
            "accepted": on["spec_accepted"], "drafted": on["spec_drafted"]}


def verify_call(torch, base: Path):
    """Phase 6c, the verify program at 8 live slots (the burst's lengths,
    pool and tables as the engine sizes them, the pool filled with
    random k/v): one captured call against the eager verify_step on a
    copy of the same state (tokens, emit, lengths, last_token and done
    equal, the pool within 1e-6), one captured call under sync debug
    mode "error"; then, information only, the captured verify call's
    time beside a captured fused round of 8 steps on the same state."""
    from kubeflow_tpu_torch.models.generate import (
        DecodeConfig,
        init_paged_state,
        verify_step,
    )
    from kubeflow_tpu_torch.serving.programs import Rounds, Verify

    model = load_model(torch, base, torch.bfloat16)
    slots, bt, k = 8, 16, 8
    mb = -(-(engine_prefill_width() + MAX_NEW_TOKENS) // bt)
    nb = slots * mb
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    state = init_paged_state(model.cfg, slots, nb, bt, device="cuda")
    tables = torch.full((slots, mb), nb, dtype=torch.int64, device="cuda")
    verify = Verify(model, decode, state, tables, SPEC_TOKENS, True)
    rounds = Rounds(model, decode, state, tables, k, True)
    pool = torch.cuda.graph_pool_handle()
    with torch.inference_mode():       # on the fresh state, as the engine
        verify.capture(pool)
        rounds.capture(pool)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for name in ("cache_k", "cache_v"):
        state[name].copy_(0.5 * torch.randn(
            state[name].shape, generator=gen, device="cuda"))
    tables.copy_(torch.arange(nb, device="cuda").view(slots, mb))
    lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device="cuda")
    live = {"lengths": lengths, "stop_len": lengths + MAX_NEW_TOKENS,
            "done": torch.zeros(slots, dtype=torch.bool, device="cuda"),
            "last_token": torch.randint(
                1, MODEL["vocab_size"], (slots,), dtype=torch.int32,
                device="cuda", generator=gen)}
    live["stop_len"][1] = PROMPT_LENS[1] + 1      # one token of budget
    live["done"][6] = True                        # a retired slot
    draft = torch.randint(1, MODEL["vocab_size"], (slots, SPEC_TOKENS),
                          dtype=torch.int32, generator=torch.Generator()
                          .manual_seed(SEED + 5)).numpy()
    draft_len = [4, 4, 3, 2, 4, 0, 4, 1]

    def reset():
        for name, value in live.items():
            state[name].copy_(value)

    def eager(draft):
        twin = init_paged_state(model.cfg, slots, nb, bt, device="cuda")
        for name, value in state.items():
            twin[name].copy_(value)
        with torch.inference_mode():
            return verify_step(model, twin, decode, SPEC_TOKENS,
                               torch.from_numpy(draft),
                               torch.tensor(draft_len), tables)

    reset()
    # Slot 0 drafts its window's own greedy targets, one position at a
    # time: a fully accepted window beside the random (rejected) ones.
    for j in range(SPEC_TOKENS):
        draft[0, j] = int(eager(draft)[1][0, j])
    twin, want_toks, want_emit = eager(draft)
    with torch.inference_mode():
        toks, emit = verify.run(draft, draft_len)
    torch.cuda.synchronize()
    if not (torch.equal(toks, want_toks) and torch.equal(emit, want_emit)):
        fail(f"a captured verify call differs from verify_step: emit "
             f"{emit.tolist()} / {want_emit.tolist()}")
    for name in ("lengths", "last_token", "done", "stop_len"):
        if not torch.equal(state[name], twin[name]):
            fail(f"a captured verify call's {name} differs from "
                 "verify_step's")
    pool_err = max(float((state[n].float() - twin[n].float()).abs().max())
                   for n in ("cache_k", "cache_v"))
    if pool_err > 1e-6:
        fail(f"a captured verify call's pool is {pool_err:.3e} from "
             "verify_step's")
    if int(emit[0]) != SPEC_TOKENS + 1 or int(emit[6]) != 0 \
            or int(emit[1]) != 1 or not bool(state["done"][1]):
        fail(f"verify emit {emit.tolist()}: the accepted window, the "
             "retired slot or the slot with one token of budget is wrong")
    del twin
    reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            verify.run(draft, draft_len)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    def timed(fn):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    calls = {"verify": lambda: verify.run(draft, draft_len),
             "round": lambda: rounds.run(k)}
    for fn in calls.values():
        timed(fn)
    times = {name: [] for name in calls}
    for i in range(5):
        for name in (("verify", "round") if i % 2 == 0
                     else ("round", "verify")):
            times[name].append(timed(calls[name]))
    ms = {name: sorted(t)[2] * 1e3 for name, t in times.items()}

    def one_verify():
        reset()
        with torch.inference_mode():
            verify.run(draft, draft_len)
        torch.cuda.synchronize()

    profiled = profile_busy(torch, one_verify,
                            f"captured verify call at {slots} live slots",
                            top=6)
    for prog in (verify, rounds):
        prog.release()
    log(f"captured verify call at {slots} live slots (window "
        f"{SPEC_TOKENS + 1}) equals verify_step on the same state: tokens, "
        f"emit {emit.tolist()}, lengths, last_token and done equal, pool "
        f"max |err| {pool_err:.3e}; one call under sync debug mode "
        f"'error'.  Verify call {ms['verify']:.2f} ms against a fused round "
        f"of {k} steps {ms['round']:.2f} ms ({ms['round'] / k:.2f} ms a "
        f"step), captured, host clock after synchronize, median of 5 in "
        f"turns ({card_line()})")
    return {"verify_ms": ms["verify"], "round_ms": ms["round"],
            "round_steps": k, "pool_max_abs_err": pool_err,
            "emit": emit.tolist(), "profile": profiled}


# -- phase 6d: the disaggregated tiers --------------------------------------

def serve_tiers(torch, flash, base: Path):
    """Phase 6d over REST: a --role prefill and a --role decode server on
    the same export (bf16, engine defaults).  The decode server first
    streams a unified :generate of a 1024-token prompt (its TTFT is the
    yardstick); the prefill server's :prefill of the same prompt must
    cover 1008 tokens in 49,545,216 bytes of bf16 pages; the decode
    server's :generate with that payload must stream the tokens its
    engine returns for the same payload unstreamed, and the pages it
    imported, gathered back, must be the exported bytes; a 16-token
    prompt exports nothing.  No flash kernel launches."""
    from kubeflow_tpu_torch.models.generate import gather_kv_pages
    from kubeflow_tpu_torch.serving import http as serving_http
    from kubeflow_tpu_torch.serving import main as serving_main

    rng = torch.Generator().manual_seed(SEED + 6)
    vocab = MODEL["vocab_size"]
    prompt = torch.randint(1, vocab, (HANDOFF_LEN,), generator=rng).tolist()
    short = torch.randint(1, vocab, (16,), generator=rng).tolist()
    # A second prompt of the same length, new to both servers: the
    # engines' own times for an export and an import, without REST.
    fresh = torch.randint(1, vocab, (HANDOFF_LEN,), generator=rng).tolist()
    servers = {}
    launches_before = dict(flash.launch_counts)
    try:
        for role in ("prefill", "decode"):
            servers[role] = serving_main.start([
                "--model_name", "lm", "--model_base_path", str(base),
                "--port", "0", "--host", "127.0.0.1", "--device", "cuda",
                "--lm_buckets", BUCKETS, "--role", role])
        ports = {role: httpd.server_address[1]
                 for role, (_, httpd) in servers.items()}
        for role, port in ports.items():
            ready = get(port, "/readyz")
            if ready.get("role") != role:
                fail(f"/readyz of the {role} server shows {ready}")
        unified, ttft_unified, t_unified = stream_generate(
            ports["decode"], {"tokens": prompt})
        t0 = time.perf_counter()
        answer = post(ports["prefill"], {"tokens": prompt},
                      "/model/lm:prefill")
        t_prefill = time.perf_counter() - t0
        wire = answer["kv_handoff"]
        if wire is None or answer["tokens_covered"] != HANDOFF_LEN - 16:
            fail(f":prefill of {HANDOFF_LEN} tokens covered "
                 f"{answer['tokens_covered']}, expected {HANDOFF_LEN - 16}")
        t0 = time.perf_counter()
        payload = serving_http.decode_kv_handoff(wire)
        t_decode = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = serving_http.encode_kv_handoff(
            dict(payload, tokens_covered=answer["tokens_covered"]))
        t_encode = time.perf_counter() - t0
        if again != wire:
            fail("the handoff re-encoded is not the wire form it came in")
        nbytes = sum(payload[s].numel() * payload[s].element_size()
                     for s in ("k", "v"))
        if nbytes != HANDOFF_BYTES or payload["k"].dtype != torch.bfloat16:
            fail(f"the handoff payload holds {nbytes} bytes of "
                 f"{payload['k'].dtype}, expected {HANDOFF_BYTES} of bf16")
        streamed, ttft_tiered, t_tiered = stream_generate(
            ports["decode"], {"tokens": prompt, "kv_handoff": wire})
        engine = servers["decode"][0]._batchers["lm"]
        direct = engine.submit({"tokens": prompt, "kv_handoff": payload})[
            "tokens"][0].tolist()
        # The last request took slot 0 (every other slot idle); its table
        # row and pages stay until that slot's next admission.
        n = answer["tokens_covered"] // 16
        (pages_k, _), (pages_v, _) = gather_kv_pages(
            engine._state, engine._tables[0][:n])
        # The breakdown (information only): the body's JSON both ways,
        # and each engine's own export and import of the fresh prompt.
        body = {"tokens": prompt, "kv_handoff": wire}
        t0 = time.perf_counter()
        text = json.dumps(body)
        t_dumps = time.perf_counter() - t0
        t0 = time.perf_counter()
        json.loads(text)
        t_loads = time.perf_counter() - t0
        del text, body
        pre_engine = servers["prefill"][0]._batchers["lm"]
        t0 = time.perf_counter()
        fresh_out = pre_engine.prefill_export({"tokens": fresh})
        t_export = time.perf_counter() - t0
        timing = engine.submit({"tokens": fresh, "return_timing": True,
                                "kv_handoff": fresh_out["kv_handoff"]})
        short_answer = post(ports["prefill"], {"tokens": short},
                            "/model/lm:prefill")
        pre_stats = get(ports["prefill"], "/model/lm:stats")["batcher"]
        dec_stats = get(ports["decode"], "/model/lm:stats")["batcher"]
    finally:
        for server, httpd in servers.values():
            serving_main.shutdown(server, httpd)
    if dict(flash.launch_counts) != launches_before:
        fail("the tiered engines launched a flash kernel")
    if prompt + streamed != direct:
        fail("the decode tier's streamed tokens differ from its unstreamed "
             "reply to the same payload")
    if len(streamed) != MAX_NEW_TOKENS or not all(
            0 <= t < vocab for t in streamed):
        fail(f"the decode tier streamed {len(streamed)} tokens")
    if not (torch.equal(pages_k, payload["k"])
            and torch.equal(pages_v, payload["v"])):
        fail("the pages the decode tier imported are not the exported bytes")
    if short_answer["kv_handoff"] is not None:
        fail("a 16-token prompt exported a kv_handoff")
    if dec_stats["handoff_pages_in"] != 3 * n \
            or dec_stats["compiled_programs"].get("kv_import") != 1 \
            or pre_stats["handoff_pages_out"] != 2 * n:
        fail(f"handoff counters: out {pre_stats['handoff_pages_out']}, in "
             f"{dec_stats['handoff_pages_in']}, programs "
             f"{dec_stats['compiled_programs']}")
    info = {
        "payload_bytes": nbytes, "wire_bytes": len(json.dumps(wire)),
        "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
        "encode_ms": t_encode * 1e3,
        "json_dumps_ms": t_dumps * 1e3, "json_loads_ms": t_loads * 1e3,
        "engine_export_ms": t_export * 1e3,
        "engine_import_ttft_ms": timing["ttft_s"] * 1e3,
        "ttft_unified_s": ttft_unified, "ttft_tiered_s": ttft_tiered,
        "latency_unified_s": t_unified, "latency_tiered_s": t_tiered,
        "bf16_tiered_first_difference": first_difference(
            streamed, unified[:len(streamed)]),
    }
    log(f"tiers: :prefill of {HANDOFF_LEN} tokens in {t_prefill * 1e3:.1f} "
        f"ms covers {answer['tokens_covered']} in {nbytes} bytes of bf16 "
        f"pages ({info['wire_bytes']} bytes of JSON); decode "
        f"{t_decode * 1e3:.1f} ms, encode {t_encode * 1e3:.1f} ms; decode "
        f"tier TTFT {ttft_tiered * 1e3:.1f} ms against the unified "
        f"engine's {ttft_unified * 1e3:.1f} ms, latency "
        f"{t_tiered:.3f} / {t_unified:.3f} s (client clock); imported "
        f"pages equal the exported bytes; bf16 tiered against unified, "
        f"first differing new token {info['bf16_tiered_first_difference']}"
        f" (information only; {card_line()})")
    log(f"tiers, breakdown (information only): the :generate body's JSON "
        f"{t_dumps * 1e3:.1f} ms to write and {t_loads * 1e3:.1f} ms to "
        f"parse; without REST the prefill engine exports a fresh "
        f"{HANDOFF_LEN}-token prompt in {t_export * 1e3:.1f} ms (prefill "
        f"and the page gather) and the decode engine's TTFT on it, the "
        f"import and one chunk, is {timing['ttft_s'] * 1e3:.1f} ms")
    return info


def tier_identity(torch, flash, base: Path):
    """Phase 6d, token identity at float32 (TF32 off): a prefill-tier
    engine exports two prompts' pages and a decode-tier engine imports
    them; its tokens must equal its own unified run of each prompt
    (served first, before any page was imported) and generate()."""
    from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    rng = torch.Generator().manual_seed(SEED + 7)
    prompts = [torch.randint(1, MODEL["vocab_size"], (n,),
                             generator=rng).tolist() for n in (300, 170)]
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    model = load_model(torch, base, torch.float32)
    engines = [DecodeEngine(model, decode, slots=8, prefill_len=512,
                            decode_rounds=8, name=f"fp32-{role}")
               for role in ("prefill", "decode")]
    pre, dec = engines
    try:
        unified = engine_tokens(dec, prompts)
        payloads = [pre.prefill_export({"tokens": p})["kv_handoff"]
                    for p in prompts]
        tiered = engine_tokens(dec, prompts,
                               [{"kv_handoff": ho} for ho in payloads])
        pages_in = dec.stats()["handoff_pages_in"]
    finally:
        for engine in engines:
            engine.close()
    with plain_kernels(flash):
        want = [generate(model, torch.tensor([p]), decode)[0][0].tolist()
                for p in prompts]
    check_identity(torch, flash, model, "float32 decode tier", prompts,
                   tiered, unified)
    check_identity(torch, flash, model, "float32 unified engine", prompts,
                   unified, want)
    covered = [ho["tokens_covered"] for ho in payloads]
    log(f"float32 token identity: the decode tier ({pages_in} pages "
        f"imported, coverage {covered}) equals the unified engine and "
        f"generate() on {len(prompts)} prompts {[len(p) for p in prompts]}")
    del model
    return {"covered": covered, "pages_in": pages_in}


# -- phase 6e: int8 weights and the int8 KV pool ---------------------------

def export_int8(base: Path, int8_base: Path) -> None:
    """The int8 serving export of the same weights: the params file linked
    and model.json naming ``quantize`` and ``kv_cache`` int8 (the JAX
    loader's keys)."""
    import os

    from kubeflow_tpu_torch.serving.export import (
        FORMAT,
        MODEL_FILE,
        PARAMS_FILE,
    )

    vdir = int8_base / "1"
    vdir.mkdir(parents=True)
    os.link(base / "1" / PARAMS_FILE, vdir / PARAMS_FILE)
    (vdir / MODEL_FILE).write_text(json.dumps({
        "format": FORMAT, "loader": JAX_LOADER,
        "config": dict(INT8_CONFIG, model=MODEL,
                       max_new_tokens=MAX_NEW_TOKENS),
        "signature": {"inputs": ["tokens"], "outputs": ["tokens"]}}))


def int8_model(torch, base: Path, dtype):
    """The exported weights quantized as the loader stages them (int8
    matmul weights on the card), computing in ``dtype``, and its int8
    decode config."""
    from kubeflow_tpu_torch.serving.export import PARAMS_FILE, msgpack_restore
    from kubeflow_tpu_torch.serving.loaders import lm_generate

    tree = msgpack_restore((base / "1" / PARAMS_FILE).read_bytes())
    name = str(dtype).replace("torch.", "")
    predict = lm_generate(dict(
        INT8_CONFIG, model=dict(MODEL, dtype=name),
        max_new_tokens=MAX_NEW_TOKENS), device="cuda")(tree)
    return predict.engine_spec["model"], predict.engine_spec["decode"]


def weight_bytes(model) -> int:
    """Bytes of the model's weights on the card: its parameters and its
    int8 QTensors (values and scales)."""
    from kubeflow_tpu_torch.ops.quantize import QTensor

    total = sum(p.numel() * p.element_size() for p in model.parameters())
    for module in model.modules():
        total += sum(v.nbytes for v in vars(module).values()
                     if isinstance(v, QTensor))
    return total


def page_bytes(state) -> int:
    """Bytes of one pool page, both sides, values and scales."""
    from kubeflow_tpu_torch.ops.quantize import QTensor

    total = 0
    for name in ("cache_k", "cache_v"):
        pool = state[name]
        parts = (pool.values, pool.scale) if isinstance(pool, QTensor) \
            else (pool,)
        total += sum(t[:, 0].numel() * t.element_size() for t in parts)
    return total


def serve_int8(torch, flash, base: Path, int8_base: Path):
    """Phase 6e over REST: the int8 export (``quantize`` and ``kv_cache``
    int8) served through the captured engine (a burst of four prompts,
    its weights int8 QTensors on the card, its pool int8 with float32
    scales), then through the static batcher (``generate()`` over an int8
    cache); neither may launch a flash kernel."""
    from kubeflow_tpu_torch.ops.quantize import QTensor
    from kubeflow_tpu_torch.serving import main as serving_main

    prompts = [torch.randint(1, MODEL["vocab_size"], (n,),
                             generator=torch.Generator().manual_seed(
                                 SEED + 9 + n)).tolist()
               for n in PROMPT_LENS[:4]]
    launches_before = dict(flash.launch_counts)
    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(int8_base),
        "--port", "0", "--host", "127.0.0.1", "--device", "cuda",
        "--lm_buckets", BUCKETS])
    port = httpd.server_address[1]
    try:
        engine = server._batchers["lm"]
        if engine.capture_info is None:
            fail("the int8 engine did not capture its programs")
        model = engine.model
        if not isinstance(model.layers[0].attn.wq, QTensor) \
                or model.embed.values.dtype != torch.int8:
            fail("the int8 export's weights are not int8 on the card")
        if not isinstance(engine._state["cache_k"], QTensor):
            fail("the int8 export's pool is not int8")
        served_bytes = weight_bytes(model)
        pool_page = page_bytes(engine._state)
        replies, latencies, t_burst = burst(port, prompts)
        stats = get(port, "/model/lm:stats")["batcher"]
        server.enable_batching("lm", serving_main.batcher_factory(
            micro_batch_size=MICRO_BATCH, batch_timeout_s=5e-3,
            lm_buckets=BUCKETS, lm_engine=False))
        static_replies, static_lat, t_static = burst(port, prompts)
    finally:
        serving_main.shutdown(server, httpd)
    launches = {k: flash.launch_counts[k] - launches_before.get(k, 0)
                for k in flash.launch_counts}
    if any(launches.values()):
        fail(f"the int8 path launched flash kernels: {launches}")
    check_replies(prompts, replies, [], None)
    check_replies(prompts, static_replies, [], None)
    if stats["compiled_programs"] != {"chunked_prefill": 1, "step": 0,
                                      "verify": 0, "decode_rounds": 1}:
        fail(f"int8 engine compiled_programs {stats['compiled_programs']}")
    if pool_page != INT8_PAGE_BYTES:
        fail(f"an int8 pool page holds {pool_page} bytes, expected "
             f"{INT8_PAGE_BYTES}")
    info = {"engine": burst_info(prompts, latencies, t_burst, stats),
            "static": burst_info(prompts, static_lat, t_static, {}),
            "weight_bytes": served_bytes, "page_bytes": pool_page,
            "flash_launches": launches}
    log_burst("int8 engine", info["engine"])
    log_burst("int8 static batcher", info["static"])
    return info


def int8_identity(torch, flash, base: Path):
    """Phase 6e, token identity at float32 (TF32 off): the engine with
    int8 weights over an int8 pool (programs captured) gives the port's
    int8 generate()'s greedy tokens on four prompts."""
    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    model, decode = int8_model(torch, base, torch.float32)
    rng = torch.Generator().manual_seed(SEED + 10)
    prompts = [torch.randint(1, MODEL["vocab_size"], (n,),
                             generator=rng).tolist() for n in INT8_LENS]
    launches_before = dict(flash.launch_counts)
    engine = DecodeEngine(model, decode, slots=8, prefill_len=512,
                          decode_rounds=8, name="int8-fp32")
    try:
        got = engine_tokens(engine, prompts)
    finally:
        engine.close()
    want = [generate(model, torch.tensor([p]), decode)[0][0].tolist()
            for p in prompts]
    if dict(flash.launch_counts) != launches_before:
        fail("the float32 int8 engine or generate() launched a flash kernel")
    check_identity(torch, flash, model, "float32 int8 engine", prompts, got,
                   want)
    log(f"float32 token identity: the int8 engine (int8 weights and pool) "
        f"equals int8 generate() on {len(prompts)} prompts "
        f"{list(INT8_LENS)}")
    del model


def int8_numbers(torch, flash, base: Path, bf16_round_ms):
    """Phase 6e in bf16: the first-step logits of int8 weights over an int8
    cache against the unquantized model's (cosine above INT8_COSINE, the
    bound of the reference's own tests); then, information only, the
    weight bytes of both on the card, a captured fused round of 8 steps
    at 8 live slots and a captured verify call on an int8 state (host
    clock after synchronize, median of 5), the round's device busy time
    under torch.profiler and the share of it the int8 -> bf16 weight
    converts take (one decode step's converts timed alone by CUDA events,
    times the steps)."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import (
        DecodeConfig,
        generate,
        init_paged_state,
    )
    from kubeflow_tpu_torch.ops.quantize import QTensor
    from kubeflow_tpu_torch.serving.programs import Rounds, Verify

    model_q, decode_q = int8_model(torch, base, torch.bfloat16)
    model = load_model(torch, base, torch.bfloat16)
    rng = torch.Generator().manual_seed(SEED + 11)
    prompt = torch.randint(1, MODEL["vocab_size"], (2, 512), generator=rng)
    launches_before = dict(flash.launch_counts)
    _, logits_q = generate(model_q, prompt, DecodeConfig(
        max_new_tokens=1, kv_cache_dtype="int8"))
    if dict(flash.launch_counts) != launches_before:
        fail("int8 generate() launched a flash kernel")
    _, logits = generate(model, prompt, DecodeConfig(max_new_tokens=1))
    a, b = logits_q.double().flatten(), logits.double().flatten()
    cosine = float(a @ b / (a.norm() * b.norm()))
    if not cosine > INT8_COSINE:
        fail(f"bf16 int8 logits against the unquantized model: cosine "
             f"{cosine:.6f}, bound {INT8_COSINE}")
    bytes_q, bytes_bf16 = weight_bytes(model_q), weight_bytes(model)
    del model
    slots, bt, k = 8, 16, 8
    mb = -(-(engine_prefill_width() + MAX_NEW_TOKENS) // bt)
    nb = slots * mb
    state = init_paged_state(model_q.cfg, slots, nb, bt, "int8",
                             device="cuda")
    tables = torch.full((slots, mb), nb, dtype=torch.int64, device="cuda")
    rounds = Rounds(model_q, decode_q, state, tables, k, True)
    verify = Verify(model_q, decode_q, state, tables, SPEC_TOKENS, True)
    pool = torch.cuda.graph_pool_handle()
    with torch.inference_mode():
        rounds.capture(pool)
        verify.capture(pool)
    tables.copy_(torch.arange(nb, device="cuda").view(slots, mb))
    lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device="cuda")

    def reset():
        state["lengths"].copy_(lengths)
        state["stop_len"].copy_(lengths + MAX_NEW_TOKENS)
        state["done"].zero_()
        state["last_token"].fill_(7)

    draft = torch.randint(1, MODEL["vocab_size"], (slots, SPEC_TOKENS),
                          generator=rng).int().numpy()
    draft_len = torch.full((slots,), SPEC_TOKENS, dtype=torch.int32).numpy()

    def timed(fn):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    calls = {"round": lambda: rounds.run(k),
             "verify": lambda: verify.run(draft, draft_len)}
    times = {name: [] for name in calls}
    for i in range(6):
        for name in (("round", "verify") if i % 2 == 0
                     else ("verify", "round")):
            times[name].append(timed(calls[name]))
    ms = {name: sorted(t[1:])[2] * 1e3 for name, t in times.items()}
    reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            rounds.run(k)
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    weights = [v for m in model_q.modules() for v in vars(m).values()
               if isinstance(v, QTensor)]
    # One decode step converts each int8 weight once: wq, both wkv sides,
    # wo, both wi sides and the MLP's wo per layer (each QTensor here
    # whole), and the tied embedding for the logits.
    convert_ms = time_ms(torch, lambda: [w.values.to(torch.bfloat16)
                                         for w in weights], 20)
    rounds.release()
    verify.release()
    info = {"cosine": cosine, "weight_bytes_int8": bytes_q,
            "weight_bytes_bf16": bytes_bf16,
            "page_bytes_int8": INT8_PAGE_BYTES,
            "page_bytes_bf16": BF16_PAGE_BYTES,
            "round_ms": ms["round"], "verify_ms": ms["verify"],
            "bf16_round_ms": bf16_round_ms,
            "convert_ms_per_step": convert_ms}
    if busy_us:
        info.update(round_busy_ms=busy_us / 1e3,
                    convert_share=convert_ms * k / (busy_us / 1e3))
    log(f"int8 against bf16 (information only; {card_line()}): weights "
        f"{bytes_q} / {bytes_bf16} bytes on the card "
        f"({bytes_q / bytes_bf16:.3f}x); pool page {INT8_PAGE_BYTES} / "
        f"{BF16_PAGE_BYTES} bytes ({INT8_PAGE_BYTES / BF16_PAGE_BYTES:.3f}"
        f"x); captured round of {k} steps at {slots} live slots "
        f"{ms['round']:.2f} ms against the bf16 round's {bf16_round_ms:.2f}"
        f" ms (phase 6b, this call); captured verify call, window "
        f"{SPEC_TOKENS + 1}, {ms['verify']:.2f} ms; first-step logits "
        f"cosine {cosine:.6f} against the unquantized model")
    if busy_us:
        log(f"int8 round under torch.profiler: device busy "
            f"{busy_us / 1e3:.2f} ms; one step's int8 -> bf16 weight "
            f"converts {convert_ms:.4f} ms (CUDA events), "
            f"{info['convert_share']:.3f} of the round's busy time")
    else:
        log("int8 round: the profiler saw no device time; the converts' "
            "share is not measured")
    return info


# -- phase 6f: the host spill tier, session park and :fetch_kv ------------

def spill_tier(torch, flash, base: Path, int8_base: Path):
    """Phase 6f over REST.  Server A serves the bf16 export with
    ``--kv_pool_blocks 128 --host_spill_blocks 1024``; control server C
    with the default pool (1024 pages, nothing spills).  Eight sessions
    of 512-1024 prompt tokens park (``park_kv``) on both: their pages
    exceed A's pool, so A must spill, never shed and never
    destroy-evict; each second turn on A must equal C's.  Then a
    failover: A's ``:fetch_kv`` of a session's prompt plus its first
    delivered tokens, resumed with ``resume_tokens`` on a fresh server
    B over :generate, must give A's tokens; likewise between two int8
    servers.  Information only: the pages spilled out and in, the
    spill-out and re-import ms a page (host clock), the resume TTFT on A
    against the cold prefill TTFT of the same context on B (client
    clock, :generate), and the fetched payload's bytes and its decode
    and encode ms.  No flash kernel launches."""
    from kubeflow_tpu_torch.serving import http as serving_http
    from kubeflow_tpu_torch.serving import main as serving_main

    rng = torch.Generator().manual_seed(SEED + 12)
    vocab = MODEL["vocab_size"]
    prompts = [torch.randint(1, vocab, (n,), generator=rng).tolist()
               for n in SPILL_LENS]
    extra = [torch.randint(1, vocab, (TURN2_NEW,), generator=rng).tolist()
             for _ in SPILL_LENS]

    def start(export, *flags):
        return serving_main.start([
            "--model_name", "lm", "--model_base_path", str(export),
            "--port", "0", "--host", "127.0.0.1", "--device", "cuda",
            "--lm_buckets", BUCKETS, *flags])

    def tokens_of(reply):
        return reply["predictions"][0]["tokens"]

    launches_before = dict(flash.launch_counts)
    servers = {}
    try:
        servers["a"] = start(base, "--kv_pool_blocks", str(SPILL_POOL),
                             "--host_spill_blocks", str(SPILL_HOST))
        servers["c"] = start(base)
        servers["b"] = start(base)
        port = {k: httpd.server_address[1]
                for k, (_, httpd) in servers.items()}
        turn1 = {}
        for name in ("a", "c"):
            turn1[name] = [tokens_of(post(port[name], {"instances": [
                {"tokens": p, "park_kv": True}]})) for p in prompts]
        parked = get(port["a"], "/model/lm:stats")["batcher"]
        engine_a = servers["a"][0]._batchers["lm"]
        mgr_parked = engine_a._mgr.stats()
        turn2 = {"a": [], "c": []}
        ttft_resume = None
        for i, t1 in enumerate(turn1["a"]):
            ctx = t1 + extra[i]
            if i == 0:
                streamed, ttft_resume, _ = stream_generate(
                    port["a"], {"tokens": ctx})
                turn2["a"].append(ctx + streamed)
            else:
                turn2["a"].append(tokens_of(post(
                    port["a"], {"instances": [{"tokens": ctx}]})))
            turn2["c"].append(tokens_of(post(
                port["c"], {"instances": [{"tokens": ctx}]})))
        # The cold prefill of session 0's second-turn context on fresh B.
        _, ttft_cold, _ = stream_generate(
            port["b"], {"tokens": turn1["a"][0] + extra[0]})
        resumed = get(port["a"], "/model/lm:stats")["batcher"]
        mgr_resumed = engine_a._mgr.stats()
        timing = dict(engine_a.spill_timing)
        # Failover of session 1 after FETCH_DELIVERED tokens: A's pages
        # over :fetch_kv, resumed on B.
        p = prompts[1]
        delivered = turn1["a"][1][len(p):len(p) + FETCH_DELIVERED]
        t0 = time.perf_counter()
        fetched = post(port["a"], {"tokens": p + delivered},
                       "/model/lm:fetch_kv")
        t_fetch = time.perf_counter() - t0
        wire = fetched["kv_handoff"]
        if wire is None:
            fail(f":fetch_kv of a parked session missed: {fetched}")
        t0 = time.perf_counter()
        payload = serving_http.decode_kv_handoff(wire)
        t_decode = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = serving_http.encode_kv_handoff(
            dict(payload, tokens_covered=fetched["tokens_covered"]))
        t_encode = time.perf_counter() - t0
        if again != wire:
            fail("the fetched payload re-encoded is not its wire form")
        nbytes = sum(payload[s].numel() * payload[s].element_size()
                     for s in ("k", "v"))
        streamed, _, _ = stream_generate(port["b"], {
            "tokens": p, "resume_tokens": delivered, "kv_handoff": wire})
        fetch_resumed = p + delivered + streamed
        fetch_b = get(port["b"], "/model/lm:stats")["batcher"]
    finally:
        for server, httpd in servers.values():
            serving_main.shutdown(server, httpd)
    # The same failover between two int8 servers.
    servers = {}
    try:
        servers["a8"] = start(int8_base, "--host_spill_blocks",
                              str(SPILL_HOST))
        servers["b8"] = start(int8_base)
        port8 = {k: httpd.server_address[1]
                 for k, (_, httpd) in servers.items()}
        p8 = prompts[2]
        want8 = tokens_of(post(port8["a8"], {"instances": [
            {"tokens": p8, "park_kv": True}]}))
        delivered8 = want8[len(p8):len(p8) + FETCH_DELIVERED]
        fetched8 = post(port8["a8"], {"tokens": p8 + delivered8},
                        "/model/lm:fetch_kv")
        wire8 = fetched8["kv_handoff"]
        if wire8 is None or set(wire8["k"]) != {"values", "scale"} \
                or wire8["k"]["values"]["dtype"] != "int8":
            fail(f"the int8 :fetch_kv payload is not int8 values and "
                 f"scales: {None if wire8 is None else wire8['k'].keys()}")
        payload8 = serving_http.decode_kv_handoff(wire8)
        nbytes8 = sum(t.numel() * t.element_size() for s in ("k", "v")
                      for t in payload8[s].values())
        streamed8, _, _ = stream_generate(port8["b8"], {
            "tokens": p8, "resume_tokens": delivered8, "kv_handoff": wire8})
    finally:
        for server, httpd in servers.values():
            serving_main.shutdown(server, httpd)
    if dict(flash.launch_counts) != launches_before:
        fail("the spill tier's engines launched a flash kernel")
    if turn1["a"] != turn1["c"]:
        fail("a parked first turn differs between the spilling server and "
             "the control")
    for i, (got, want) in enumerate(zip(turn2["a"], turn2["c"])):
        if got != want:
            fail(f"session {i}'s second turn on the spilling server differs "
                 f"from the control at new token "
                 f"{first_difference(got, want)}")
    if parked["kv_spill_pages_out"] <= 0 or resumed["kv_spill_pages_in"] \
            <= 0 or resumed["shed"] or mgr_resumed["evictions"] \
            or mgr_resumed["block_evictions"] \
            or parked["parked_sessions"] != len(prompts):
        fail(f"spill tier: pages out {parked['kv_spill_pages_out']}, in "
             f"{resumed['kv_spill_pages_in']}, shed {resumed['shed']}, "
             f"evictions {mgr_resumed['evictions']} records / "
             f"{mgr_resumed['block_evictions']} blocks, parked "
             f"{parked['parked_sessions']}")
    if fetch_resumed != turn1["a"][1] or fetch_b["handoff_pages_in"] < 1:
        fail(f"the bf16 fetch-resume on B differs from A's tokens at new "
             f"token {first_difference(fetch_resumed, turn1['a'][1])}")
    if p8 + delivered8 + streamed8 != want8:
        fail("the int8 fetch-resume differs from the parking server's "
             "tokens")
    info = {
        "sessions": len(prompts),
        "parked_pages": sum((len(t) - 1) // 16 for t in turn1["a"]),
        "pages_out": resumed["kv_spill_pages_out"],
        "pages_in": resumed["kv_spill_pages_in"],
        "host_tier_used": resumed["host_tier_used"],
        "prefix_hits": resumed["prefix_hits"],
        "spill_out_ms_per_page": timing["out_s"] * 1e3
        / max(1, timing["out_pages"]),
        "spill_in_ms_per_page": timing["in_s"] * 1e3
        / max(1, timing["in_pages"]),
        "timed_pages": {"out": timing["out_pages"],
                        "in": timing["in_pages"]},
        "ttft_resume_ms": ttft_resume * 1e3,
        "ttft_cold_ms": ttft_cold * 1e3,
        "fetch_bytes": nbytes, "fetch_wire_bytes": len(json.dumps(wire)),
        "fetch_ms": t_fetch * 1e3, "decode_ms": t_decode * 1e3,
        "encode_ms": t_encode * 1e3,
        "fetch_covered": fetched["tokens_covered"],
        "fetch_bytes_int8": nbytes8,
        "fetch_covered_int8": fetched8["tokens_covered"],
    }
    log(f"spill tier: {len(prompts)} sessions parked ({info['parked_pages']}"
        f" full pages) on a {SPILL_POOL}-page pool with a {SPILL_HOST}-page "
        f"host tier: {info['pages_out']} pages spilled out, "
        f"{info['pages_in']} re-imported, shed 0, evictions 0; every second "
        f"turn equals the control's; spill-out "
        f"{info['spill_out_ms_per_page']:.3f} ms a page, re-import "
        f"{info['spill_in_ms_per_page']:.3f} ms a page (host clock, "
        f"{timing['out_pages']} and {timing['in_pages']} pages timed)")
    log(f"spill tier, resume TTFT of a {len(turn1['a'][0] + extra[0])}-token"
        f" second turn {info['ttft_resume_ms']:.1f} ms against its cold "
        f"prefill's {info['ttft_cold_ms']:.1f} ms (client clock, "
        f":generate); :fetch_kv of {fetched['tokens_covered']} tokens in "
        f"{info['fetch_ms']:.1f} ms, {nbytes} bytes of bf16 pages "
        f"({info['fetch_wire_bytes']} of JSON), decode "
        f"{info['decode_ms']:.1f} ms, encode {info['encode_ms']:.1f} ms; "
        f"the resumed failover equals the parking server's tokens at bf16 "
        f"and at int8 ({nbytes8} bytes of int8 pages and scales for "
        f"{fetched8['tokens_covered']} tokens) (information only; "
        f"{card_line()})")
    return info


# -- phase 6g: adapter-array serving ----------------------------------------

def write_adapters(torch, adir: Path) -> dict:
    """The three seeded adapters of the phase, written with the port's
    ``save_adapter`` (the JAX package's artifact format); their
    digests."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serving.adapters import (
        random_adapter_factors,
        save_adapter,
    )

    cfg = TransformerConfig(**dict(MODEL, dtype=torch.float32))
    adir.mkdir(parents=True)
    return {name: save_adapter(str(adir / f"{name}.npz"),
                               random_adapter_factors(
                                   cfg, ADAPTER_RANK, SEED + 40 + i,
                                   scale=ADAPTER_SCALE))
            for i, name in enumerate(ADAPTERS)}


def adapter_prompts(torch):
    rng = torch.Generator().manual_seed(SEED + 13)
    return [torch.randint(1, MODEL["vocab_size"], (n,),
                          generator=rng).tolist() for n in ADAPTER_LENS]


def adapter_work(prompts):
    """Two requests each of base and every adapter: (adapter or None,
    prompt) in the order base, alpha, beta, gamma for each prompt."""
    return [(a, p) for p in prompts for a in (None,) + ADAPTERS]


def post_status(port: int, path: str, body: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def stack_bytes(stack) -> int:
    return sum(t.numel() * t.element_size()
               for leaves in stack.values() for t in leaves.values())


def serve_adapters(torch, flash, base: Path, adir: Path):
    """Phase 6g over REST: the bf16 export with ``--adapters_dir`` at the
    JAX CLI's engine defaults (8 slots, ``--adapter_slots 8``,
    ``--adapter_rank 4``; programs captured).  A burst of eight
    concurrent :predict requests, two each of ``lm``, ``lm@alpha``,
    ``lm@beta`` and ``lm@gamma``: every reply prompt + max_new_tokens
    tokens in the vocabulary, :stats with the three adapters resident and
    the JAX engine's compiled_programs() for these flags, /readyz
    advertising them, ``lm@ghost`` answering 404.  Information only:
    the burst's TTFT and tokens/s, the stack's bytes on the card, and
    which bf16 variants' tokens differ from base."""
    from kubeflow_tpu_torch.serving import main as serving_main

    prompts = adapter_prompts(torch)
    work = adapter_work(prompts)
    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base),
        "--port", "0", "--host", "127.0.0.1", "--device", "cuda",
        "--lm_buckets", BUCKETS, "--adapters_dir", str(adir),
        "--adapter_slots", "8", "--adapter_rank", str(ADAPTER_RANK)])
    port = httpd.server_address[1]
    try:
        engine = server._batchers["lm"]
        if engine.capture_info is None:
            fail("the adapter engine did not capture its programs")
        # One short request first: the burst must not carry the
        # process's one-off start-up.
        post(port, {"instances": [{"tokens": prompts[0][:16]}]})
        replies = [None] * len(work)
        latencies = [None] * len(work)

        def call(i):
            adapter, prompt = work[i]
            name = "lm" if adapter is None else f"lm@{adapter}"
            t = time.perf_counter()
            replies[i] = post(port, {"instances": [{"tokens": prompt}]},
                              f"/model/{name}:predict")
            latencies[i] = time.perf_counter() - t

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(work))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t_burst = time.perf_counter() - t0
        if None in replies:
            fail("a request of the adapter burst did not complete")
        stats = get(port, "/model/lm:stats")["batcher"]
        ready = get(port, "/readyz")
        status, body = post_status(port, "/model/lm@ghost:predict", {
            "instances": [{"tokens": prompts[0][:8]}]})
        on_card = stack_bytes(engine._adapter_stack)
    finally:
        serving_main.shutdown(server, httpd)
    check_replies([p for _, p in work], replies, [], None)
    if stats["compiled_programs"] != {"chunked_prefill": 1, "step": 0,
                                      "verify": 0, "decode_rounds": 1}:
        fail(f"adapter engine compiled_programs {stats['compiled_programs']}")
    if stats["adapters"]["adapters_resident"] != len(ADAPTERS):
        fail(f"adapter engine stats {stats['adapters']}")
    if {a["name"] for a in ready.get("adapters", {}).get("lm", ())} \
            != set(ADAPTERS):
        fail(f"/readyz does not advertise the adapters: {ready}")
    if status != 404:
        fail(f"an unknown adapter answered {status}: {body}")
    toks = [r["predictions"][0]["tokens"] for r in replies]
    differs = {a: [toks[i] != toks[i - 1 - j] for i, (b, _) in
                   enumerate(work) if b == a]
               for j, a in enumerate(ADAPTERS)}
    info = {"burst": burst_info([p for _, p in work], latencies, t_burst,
                                stats),
            "stack_bytes": on_card,
            "bf16_differs_from_base": differs}
    log_burst("adapter engine (2 x base, lm@alpha, lm@beta, lm@gamma)",
              info["burst"])
    log(f"adapter stack on the card: {on_card} bytes for 9 rows (8 slots "
        f"and the base row) at rank {ADAPTER_RANK}, "
        f"{on_card / 9 / 1e6:.3f} MB a row; bf16 variants differing from "
        f"base per prompt (information only): {differs}; lm@ghost "
        f"answered 404")
    return info


def adapter_identity(torch, flash, base: Path, adir: Path):
    """Phase 6g at float32 (TF32 off), engines with programs captured and
    the prefix cache off (so a rerun of a prompt prefills as its first
    run did): the burst of eight mixed requests through one engine gives
    each request its tokens alone on the same engine; base rows equal a
    base-only engine's; each variant differs from base on both prompts;
    the engine captured and ran the programs the base-only engine did.
    Then a 2-slot registry: with alpha pinned, loading gamma evicts only
    the idle beta, and beta reloaded into a row another adapter held
    decodes its tokens again through the graphs captured at
    construction."""
    from kubeflow_tpu_torch.models.generate import DecodeConfig
    from kubeflow_tpu_torch.serving.adapters import AdapterRegistry
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    model = load_model(torch, base, torch.float32)
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    geometry = dict(slots=8, prefill_len=512, decode_rounds=8,
                    prefix_caching=False)
    prompts = adapter_prompts(torch)
    work = adapter_work(prompts)

    def registry(slots, name):
        return AdapterRegistry(model.cfg, slots=slots, rank=ADAPTER_RANK,
                               directory=str(adir), name=name)

    def request(adapter, prompt):
        return dict({"tokens": prompt},
                    **({"adapter": adapter} if adapter else {}))

    def alone(engine, items):
        return [engine.submit(request(a, p))["tokens"][0].tolist()
                for a, p in items]

    def programs_of(engine):
        return (engine.capture_info["programs"], engine.compiled_programs())

    engine = DecodeEngine(model, decode, adapters=registry(8, "ad-fp32"),
                          name="adapters-fp32", **geometry)
    try:
        together = engine_tokens(engine, [p for _, p in work],
                                 extra=[request(a, p) for a, p in work])
        single = alone(engine, work)
        ad_programs = programs_of(engine)
        ad_pool = engine.capture_info["pool_bytes"]
    finally:
        engine.close()
    engine = DecodeEngine(model, decode, name="base-fp32", **geometry)
    try:
        base_rows = alone(engine, [w for w in work if w[0] is None])
        base_programs = programs_of(engine)
        base_pool = engine.capture_info["pool_bytes"]
    finally:
        engine.close()
    for (adapter, prompt), a, b in zip(work, together, single):
        if a != b:
            fail(f"float32 adapter engine: {adapter or 'base'} on a "
                 f"{len(prompt)}-token prompt co-batched differs from its "
                 f"run alone at position {first_difference(a, b)}")
    if [t for (a, _), t in zip(work, together) if a is None] != base_rows:
        fail("float32 adapter engine: base rows differ from a base-only "
             "engine's")
    for i, (adapter, _) in enumerate(work):
        if adapter is not None and together[i] == together[
                i - 1 - ADAPTERS.index(adapter)]:
            fail(f"float32: adapter {adapter} decoded base's tokens")
    if ad_programs != base_programs:
        fail(f"the adapter engine's programs {ad_programs} differ from a "
             f"base-only engine's {base_programs}")
    log(f"float32 adapter identity: {len(work)} co-batched requests (2 x "
        f"base, alpha, beta, gamma on prompts of {list(ADAPTER_LENS)} "
        f"tokens) equal their runs alone; base rows equal a base-only "
        f"engine's; every variant differs from base; programs "
        f"{ad_programs[0]}, compiled {ad_programs[1]}, as the base-only "
        f"engine's (graph pool {ad_pool} bytes against {base_pool})")
    want = {(a, tuple(p)): t for (a, p), t in zip(work, single)}
    prompt = prompts[0]
    reg = registry(2, "ad-hot")
    engine = DecodeEngine(model, decode, adapters=reg, name="adapters-hot",
                          **geometry)
    try:
        graphs = [id(p.graph) for p in engine._programs()]
        for adapter in ("alpha", "beta"):
            if alone(engine, [(adapter, prompt)])[0] != want[
                    (adapter, tuple(prompt))]:
                fail(f"2-slot registry: {adapter} differs from its tokens "
                     "on the 8-slot engine")
        pin, _ = reg.acquire("alpha")
        try:
            got = alone(engine, [("gamma", prompt)])[0]
            resident = {r["name"] for r in reg.loaded()}
        finally:
            reg.release(pin)
        if resident != {"alpha", "gamma"}:
            fail(f"a hot load with alpha pinned left {resident} resident")
        if got != want[("gamma", tuple(prompt))]:
            fail("gamma hot-loaded into beta's row decodes other tokens")
        got = alone(engine, [("beta", prompt)])[0]
        rows = {r["name"]: r["index"] for r in reg.loaded()}
        if got != want[("beta", tuple(prompt))]:
            fail(f"beta reloaded into row {rows.get('beta')} decodes other "
                 "tokens through the captured graphs")
        if [id(p.graph) for p in engine._programs()] != graphs:
            fail("the engine recaptured a program for a hot load")
        hot_stats = engine.stats()["adapters"]
    finally:
        engine.close()
    log(f"float32 hot load into a 2-slot registry: gamma evicted only the "
        f"idle beta while alpha was pinned; beta reloaded into row "
        f"{rows['beta']} (resident now {sorted(rows)}) decodes its tokens "
        f"again through the graphs captured at construction; registry "
        f"{hot_stats['adapters_resident']} resident, "
        f"{hot_stats['adapters_pinned']} pinned")
    del model
    return {"requests": len(work), "programs": ad_programs[0],
            "graph_pool_bytes": ad_pool, "base_graph_pool_bytes": base_pool,
            "beta_reload_row": rows["beta"]}


def adapter_numbers(torch, base: Path, adir: Path, bf16_round_ms):
    """Phase 6g in bf16, information only: one hot load (the registry's
    acquire of an adapter from disk, host clock; then the copy of the
    whole stack into the device stack, as the engine makes it, host clock
    after synchronize), and a captured round of 8 steps at 8 live slots
    with the adapter rows (0, 1, 2, 3, 0, 1, 2, 3) against the same round
    with no adapter stack, in turns (median of 5 after one warm-up),
    each with its device busy time under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import (
        DecodeConfig,
        init_paged_state,
    )
    from kubeflow_tpu_torch.serving.adapters import AdapterRegistry
    from kubeflow_tpu_torch.serving.engine import copy_adapter_stack
    from kubeflow_tpu_torch.serving.programs import Rounds

    model = load_model(torch, base, torch.bfloat16)
    reg = AdapterRegistry(model.cfg, slots=8, rank=ADAPTER_RANK,
                          directory=str(adir), name="ad-numbers")
    acquire_ms = {}
    for name in ADAPTERS:
        t0 = time.perf_counter()
        idx, _ = reg.acquire(name)
        acquire_ms[name] = (time.perf_counter() - t0) * 1e3
        reg.release(idx)
    snapshot, _ = reg.stack_snapshot()
    stack = {grp: {k: torch.zeros(a.shape, dtype=torch.bfloat16,
                                  device="cuda")
                   for k, a in leaves.items()}
             for grp, leaves in snapshot.items()}
    copy_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        copy_adapter_stack(stack, snapshot)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    slots, bt, k = 8, 16, 8
    mb = -(-(engine_prefill_width() + MAX_NEW_TOKENS) // bt)
    nb = slots * mb
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    states = {name: init_paged_state(model.cfg, slots, nb, bt,
                                     device="cuda")
              for name in ("adapters", "base")}
    tables = torch.full((slots, mb), nb, dtype=torch.int64, device="cuda")
    rounds = {"adapters": Rounds(model, decode, states["adapters"], tables,
                                 k, True, adapters=stack),
              "base": Rounds(model, decode, states["base"], tables, k,
                             True)}
    pool = torch.cuda.graph_pool_handle()
    with torch.inference_mode():
        for prog in rounds.values():
            prog.capture(pool)
    tables.copy_(torch.arange(nb, device="cuda").view(slots, mb))
    lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device="cuda")
    rows = torch.tensor([0, 1, 2, 3] * 2, dtype=torch.int32, device="cuda")

    def reset(name):
        state = states[name]
        state["lengths"].copy_(lengths)
        state["stop_len"].copy_(lengths + MAX_NEW_TOKENS)
        state["done"].zero_()
        state["last_token"].fill_(7)
        state["adapter_ids"].copy_(rows if name == "adapters" else 0 * rows)

    def timed(name):
        reset(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            rounds[name].run(k)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    times = {name: [] for name in rounds}
    for i in range(6):
        for name in (("adapters", "base") if i % 2 == 0
                     else ("base", "adapters")):
            times[name].append(timed(name))
    ms = {name: sorted(t[1:])[2] * 1e3 for name, t in times.items()}
    busy = {}
    for name in rounds:
        reset(name)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                rounds[name].run(k)
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        busy[name] = busy_us / 1e3 if busy_us else None
    for prog in rounds.values():
        prog.release()
    info = {"round_ms": ms["adapters"], "base_round_ms": ms["base"],
            "ratio": ms["adapters"] / ms["base"],
            "phase_6b_round_ms": bf16_round_ms,
            "round_busy_ms": busy["adapters"],
            "base_round_busy_ms": busy["base"],
            "acquire_ms": acquire_ms, "stack_copy_ms": sorted(copy_ms)[1],
            "stack_bytes": stack_bytes(stack)}
    log(f"adapters in bf16 (information only; {card_line()}): captured "
        f"round of {k} steps at {slots} live slots with adapter rows "
        f"{rows.tolist()} {ms['adapters']:.2f} ms against "
        f"{ms['base']:.2f} ms with no adapter stack, in turns "
        f"({info['ratio']:.3f}x; phase 6b's round {bf16_round_ms:.2f} ms); "
        f"device busy {busy['adapters']} / {busy['base']} ms under "
        f"torch.profiler; one hot load: acquire from disk "
        f"{acquire_ms} ms (host clock), copy of the {info['stack_bytes']}"
        f"-byte stack to the card {info['stack_copy_ms']:.3f} ms (host "
        f"clock after synchronize, median of 3)")
    del model
    return info


def check_replies(prompts, replies, direct, direct_reply):
    vocab = MODEL["vocab_size"]
    got = [r["predictions"][0]["tokens"] for r in replies]
    if direct_reply is not None:
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


def step_stats(records, tokens):
    """Median step time of the logged records, and MFU at ``tokens`` a
    step (3 x flops_per_token x tokens over the bf16 peak)."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    step_s = sorted(r["step_time_s"] for r in records)
    step_s = step_s[len(step_s) // 2]
    cfg = TransformerConfig(**{k: v for k, v in MODEL.items()
                               if k not in ("dtype",)})
    return step_s, 3 * cfg.flops_per_token() * tokens / step_s \
        / PEAK_BF16_FLOPS


def train(torch, flash, workdir: Path):
    """Phase 7: the port's training entry point on the bench LM config
    (``train_lm.run``, the work of ``train_lm.main``, which returns the
    trainer and so its last step's metrics)."""
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
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s, mfu = step_stats(history[2:], tokens)
    log(f"train: {TRAIN_STEPS} steps of batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"losses {[round(x, 4) for x in losses]}, last grad_norm "
        f"{last['grad_norm']:.4f}; median step {step_s * 1e3:.1f} ms over "
        f"steps 2-{TRAIN_STEPS - 1} (host clock after a sync each step), "
        f"{tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} (3 x "
        f"flops_per_token x tokens / {PEAK_BF16_FLOPS:.3g}), peak memory "
        f"{peak_gib:.2f} GiB (information only)")
    return counts, {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
                    "mfu": mfu, "peak_gib": peak_gib, "losses": losses}


def train_two_pass(torch, flash):
    """Phase 7b: bench.py's LM cell with --flash-block-diag 256
    --optimizer adafactor --steps-per-call 2, built as bench_lm builds it
    (lm_task and Trainer over one repeated random batch), launch counters
    zeroed just before fit and read just after: flash_fwd_full,
    flash_fwd_diag, flash_dq and flash_dkv 12 times a step each,
    flash_fwd never."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.train import Trainer

    bq, bk, bd = TWO_PASS_BLOCKS
    cfg = TransformerConfig(**dict(
        MODEL, max_seq_len=TRAIN_SEQ, dtype=torch.bfloat16, remat=True,
        flash_block_q=bq, flash_block_k=bk, flash_block_diag=bd))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adafactor(1e-3), device="cuda",
                      flops_per_example=cfg.flops_per_token() * TRAIN_SEQ,
                      peak_flops_per_chip=PEAK_BF16_FLOPS)
    state = trainer.create_state()
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, size=(
        TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    trainer.fit(itertools.repeat(batch), TWO_PASS_STEPS, state=state,
                examples_per_step=TRAIN_BATCH, log_every=1,
                steps_per_call=TWO_PASS_STEPS_PER_CALL)
    torch.cuda.synchronize()
    counts = dict(flash.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = MODEL["n_layers"] * TWO_PASS_STEPS
    log(f"kernel launches on the two-pass training path ({TWO_PASS_STEPS} "
        f"steps): {counts} (want {want} of each of "
        f"{', '.join(TWO_PASS_KERNELS)}, 0 of flash_fwd)")
    bad = [k for k in TWO_PASS_KERNELS if counts[k] != want]
    if bad or counts["flash_fwd"] or counts["flash_fwd_masked"]:
        fail(f"two-pass training launched the wrong kernels: {counts}")
    history = trainer.metrics.history
    losses = [r["loss"] for r in history]
    last = trainer.last_metrics
    if len(losses) != TWO_PASS_STEPS // TWO_PASS_STEPS_PER_CALL or not all(
            map(math.isfinite, losses + [last.get("grad_norm", math.nan)])):
        fail(f"non-finite or missing two-pass training metrics: losses "
             f"{losses}, last {last}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # The first call carries one-off start-up.
    step_s, mfu = step_stats(history[1:], tokens)
    log(f"train two-pass: {TWO_PASS_STEPS} steps ({TWO_PASS_STEPS_PER_CALL}"
        f" a call) of batch {TRAIN_BATCH} x {TRAIN_SEQ}, adafactor 1e-3, "
        f"blocks {TWO_PASS_BLOCKS}: losses {[round(x, 4) for x in losses]}, "
        f"last grad_norm {last['grad_norm']:.4f}; median step "
        f"{step_s * 1e3:.1f} ms over calls 2-{len(history)} (host clock "
        f"after a sync each call), {tokens / step_s:.0f} tokens/s, MFU "
        f"{mfu:.4f}, peak memory {peak_gib:.2f} GiB (information only)")
    return counts, {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
                    "mfu": mfu, "peak_gib": peak_gib, "losses": losses}


def checkpoint_and_data(torch, workdir: Path):
    """Phase 10: tools/train_lm.run on the bench flags with
    --optimizer adafactor, --data-files (KFTR shards written by the
    port's writer) and --checkpoint-dir: 4 steps saving every 2, each
    saved step verified; a rerun to 6 steps resumes at step 4; with the
    newest step's file truncated, a rerun to 8 steps walks back to the
    step before it.  Then one save and one restore of the trained state,
    timed."""
    import numpy as np

    from kubeflow_tpu_torch.data import write_example_shards
    from kubeflow_tpu_torch.runtime import checkpoint
    from kubeflow_tpu_torch.tools import train_lm

    rng = np.random.RandomState(SEED)
    files = [str(p) for p in write_example_shards(
        ({"tokens": rng.randint(0, MODEL["vocab_size"], size=(
            TRAIN_SEQ,)).astype(np.int32)} for _ in range(CKPT_EXAMPLES)),
        workdir / "data", examples_per_shard=CKPT_EXAMPLES // CKPT_SHARDS)]
    ckpt = workdir / "ckpt"
    flags = TRAIN_FLAGS + [
        "--optimizer", "adafactor", "--data-files", *files,
        "--checkpoint-dir", str(ckpt), "--checkpoint-every", str(CKPT_EVERY),
        "--log-every", "1", "--max-restarts", "0"]

    def run(steps):
        t0 = time.perf_counter()
        trainer = train_lm.run(flags + ["--steps", str(steps)])
        seen = [r["step"] for r in trainer.metrics.history]
        losses = [r["loss"] for r in trainer.metrics.history]
        if not all(map(math.isfinite, losses)):
            fail(f"non-finite losses with checkpoints and data: {losses}")
        return trainer, seen, time.perf_counter() - t0

    trainer, seen, t_first = run(4)
    steps = trainer.checkpoints.all_steps()
    verdicts = {s: checkpoint.verify_step(ckpt, s) for s in steps}
    if seen != [0, 1, 2, 3] or steps != [1, 3] or not all(
            ok for ok, _ in verdicts.values()):
        fail(f"first run: history {seen}, saved {steps}, verify {verdicts}")
    _, seen, t_resume = run(6)
    if seen != [4, 5]:
        fail(f"the rerun to 6 steps did not resume at step 4: {seen}")
    newest = checkpoint.list_checkpoint_steps(ckpt)[-1]
    state_file = ckpt / str(newest) / checkpoint.STATE_FILE
    state_file.write_bytes(state_file.read_bytes()[:-4096])
    trainer, seen, t_walk = run(8)
    if newest != 5 or seen != [4, 5, 6, 7]:
        fail(f"truncated step {newest}: the rerun to 8 steps trained "
             f"{seen}, not a walk back to step 3 (steps 4-7)")
    nbytes = sum(v["size"] for v in json.loads(checkpoint.manifest_path(
        ckpt, 7).read_text())["files"].values())
    # One save and one restore of the trained state, timed.
    fresh = trainer.create_state()
    mgr = checkpoint.CheckpointManager(workdir / "timed")
    t0 = time.perf_counter()
    _, start = checkpoint.CheckpointManager(ckpt).restore_or_init(fresh)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.save(0, fresh)
    t_save_call = time.perf_counter() - t0
    mgr.wait()
    t_save = time.perf_counter() - t0
    if start != 8 or not checkpoint.verify_step(workdir / "timed", 0)[0]:
        fail(f"restore started at {start}, want 8; or the timed save "
             "did not verify")
    log(f"checkpoint and data: 4 steps saved {steps} (verified), a rerun "
        f"resumed at step 4, a truncated step {newest} walked back to "
        f"step 3; runs took {t_first:.1f} / {t_resume:.1f} / {t_walk:.1f} "
        f"s (three model inits included); checkpoint {nbytes} bytes; save "
        f"{t_save:.3f} s ({t_save_call:.3f} s in the caller: the host "
        f"copy), restore {t_restore:.3f} s (information only)")
    return {"checkpoint_bytes": nbytes, "save_s": t_save,
            "save_call_s": t_save_call, "restore_s": t_restore}


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
    # The same weights with the two-pass forward (pass A, pass B, merge).
    bq, bk, bd = TWO_PASS_BLOCKS
    model2 = Transformer(TransformerConfig(**dict(
        base, dtype=torch.bfloat16, flash_block_q=bq, flash_block_k=bk,
        flash_block_diag=bd)), device="meta")
    model2.load_state_dict(
        {k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    before = dict(flash.launch_counts)
    loss_2, g_2 = grads(model2)
    launched = {k: flash.launch_counts[k] - before[k]
                for k in TWO_PASS_KERNELS + ("flash_fwd",)}
    if launched != dict({k: MODEL["n_layers"] for k in TWO_PASS_KERNELS},
                        flash_fwd=0):
        fail(f"the two-pass gradient step launched {launched}")
    del model2
    with plain_kernels(flash):
        loss_p, g_p = grads(model)
    loss_r, g_r = grads(model32)
    ref = g_r.norm()
    err_k = ((g_k - g_r).norm() / ref).item()
    err_2 = ((g_2 - g_r).norm() / ref).item()
    err_p = ((g_p - g_r).norm() / ref).item()
    log(f"gradients, batch 2 x {TRAIN_SEQ}, {g_r.numel()} parameters, "
        f"against float32 with plain attention (loss {loss_r:.6f}): kernel "
        f"path relative error {err_k:.4e} (loss {loss_k:.6f}), two-pass "
        f"kernel path {err_2:.4e} (loss {loss_2:.6f}), plain bf16 "
        f"path {err_p:.4e} (loss {loss_p:.6f}), |kernel - plain| / |ref| "
        f"{((g_k - g_p).norm() / ref).item():.4e} (bound: each kernel "
        f"path <= {GRAD_ERR_RATIO} x plain)")
    if not (torch.isfinite(g_k).all() and torch.isfinite(g_2).all()
            and max(err_k, err_2) <= GRAD_ERR_RATIO * err_p):
        fail("gradients through the kernels are further from float32 than "
             "through the plain versions")
    return {"rel_err_kernel": err_k, "rel_err_two_pass": err_2,
            "rel_err_plain": err_p}


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


def cnn_model(name: str, dtype, device):
    """The served model of ``name`` as its loader config builds it."""
    from kubeflow_tpu_torch.models.inception import InceptionV3
    from kubeflow_tpu_torch.models.resnet import ResNetConfig

    config, _ = CNN_SERVED[name]
    if config["family"] == "inception_v3":
        return InceptionV3(num_classes=config["num_classes"], dtype=dtype,
                           device=device)
    return ResNetConfig._FACTORIES[config["family"]](
        num_classes=config["num_classes"], dtype=dtype, device=device,
        num_filters=config.get("num_filters", 64))


def export_cnn(torch, base: Path, name: str) -> dict:
    from kubeflow_tpu_torch.serving.export import export

    config, size = CNN_SERVED[name]
    from kubeflow_tpu_torch.testing.cnn import random_cnn_variables

    model = cnn_model(name, torch.float32, "meta")
    variables = random_cnn_variables(model, SEED)
    export(base, 1, variables, loader=CNN_LOADER, config=config,
           signature={"inputs": {"image": [None, size, size, 3]},
                      "outputs": {"scores": [None, config["num_classes"]]}})
    n = sum(p.numel() for p in model.parameters())
    log(f"exported seeded {config['family']} ({n} parameters, "
        f"{size} x {size}, {config['num_classes']} classes) to {base}")
    return variables


def profile_busy(torch, fn, what: str, top: int = 8) -> dict:
    """One call of ``fn`` (which ends in a synchronize) under
    torch.profiler: device busy time, its share of the profiled wall,
    and the kernels with the most device time (information only)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log(f"{what}: the profiler saw no device time; busy share not "
            "measured")
        return {"wall_ms": wall * 1e3, "busy_ms": None}
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log(f"{what} under torch.profiler: wall {wall * 1e3:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms ({busy_us / (wall * 1e6):.3f} of the "
        f"wall), {sum(e.count for e in kernels)} kernel launches "
        f"(information only)")
    tops = []
    for e in kernels[:top]:
        share = e.self_device_time_total / busy_us
        tops.append({"kernel": e.key[:100], "share": share,
                     "launches": e.count})
        log(f"  {share:.3f} of busy, {e.count} launches: {e.key[:100]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / (wall * 1e6), "top": tops}


def cnn_images(name: str, n: int, seed: int, floats: bool = False):
    """n uint8 images of the model's size; with ``floats``, every odd one
    sent as float32 pixels scaled to [0, 1] instead."""
    import numpy as np

    _, size = CNN_SERVED[name]
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
              for _ in range(n)]
    return [im.astype(np.float32) / 255.0 if floats and i % 2 else im
            for i, im in enumerate(images)]


def check_cnn_reply(name: str, reply: dict) -> None:
    """Scores of the model's width summing to 1, the top k sorted and
    equal to the scores at its classes."""
    import numpy as np

    config, _ = CNN_SERVED[name]
    scores = np.asarray(reply["scores"], np.float64)
    classes = np.asarray(reply["top_k_classes"])
    top = np.asarray(reply["top_k_scores"], np.float64)
    if scores.shape != (config["num_classes"],) or not np.all(
            np.isfinite(scores)) or abs(scores.sum() - 1.0) > 1e-3:
        fail(f"{name}: scores of shape {scores.shape} summing to "
             f"{scores.sum()}")
    if classes.shape != (config["top_k"],) or np.any(np.diff(top) > 0) \
            or not np.array_equal(top, scores[classes]) \
            or top[0] != scores.max():
        fail(f"{name}: top k {classes.tolist()} / {top.tolist()} is not the "
             "sorted head of the scores")


class bf16_batchnorm:
    """Phase 11's control run: eval-mode BatchNorm normalizing in bf16
    (its statistics, scale and bias rounded to bf16, the arithmetic in
    bf16) where the models normalize in float32.  The logits bound must
    not hold this run."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from kubeflow_tpu_torch.models import resnet

        torch = self.torch
        self.resnet, self.forward = resnet, resnet.BatchNorm.forward
        forward = self.forward

        def bf16_forward(module, x, stats, train):
            if train or x.dtype != torch.bfloat16:
                return forward(module, x, stats, train)

            def channel(t):
                return t.to(torch.bfloat16)[:, None, None]

            inv = torch.rsqrt(channel(stats["var"]) + module.epsilon)
            return (x - channel(stats["mean"])) * inv \
                * channel(module.scale) + channel(module.bias), stats

        resnet.BatchNorm.forward = bf16_forward
        return self

    def __exit__(self, *exc):
        self.resnet.BatchNorm.forward = self.forward


def serve_cnn_model(torch, base: Path, name: str, variables: dict):
    """Phase 11, one model: the port's serving entry point with
    --micro_batch_size 8, a concurrent burst of 16 :predict requests
    (uint8 pixel lists and float32 lists in turns), then one :predict and
    one :classify of the same image alone, and one direct 8-row request
    of uint8 pixels.
    Every reply checked; the served scores equal to the loader's own
    predict on the same rows at the batch size they were served in; the
    bf16 logits held to a float32 run of the same weights."""
    import numpy as np

    from kubeflow_tpu_torch.models.convert_cnn import load_cnn_variables
    from kubeflow_tpu_torch.serving import main as serving_main

    config, size = CNN_SERVED[name]
    images = cnn_images(name, CNN_BURST, SEED + 11, floats=True)
    direct = cnn_images(name, CNN_DIRECT_ROWS, SEED + 12)
    server, httpd = serving_main.start([
        "--model_name", name, "--model_base_path", str(base),
        "--port", "0", "--host", "127.0.0.1", "--device", "cuda",
        "--micro_batch_size", str(CNN_MICRO_BATCH)])
    port = httpd.server_address[1]
    route = f"/model/{name}"
    try:
        post(port, {"instances": [images[0].tolist()]},
             f"{route}:predict")  # the process's first cuDNN work
        before = server.batcher_stats(name)["batch_size_hist"]
        replies, latencies = [None] * CNN_BURST, [None] * CNN_BURST

        def call(i):
            t = time.perf_counter()
            replies[i] = post(port, {"instances": [images[i].tolist()]},
                              f"{route}:predict")["predictions"][0]
            latencies[i] = time.perf_counter() - t

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(CNN_BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t_burst = time.perf_counter() - t0
        if None in replies:
            fail(f"{name}: a request of the burst did not complete")
        stats = server.batcher_stats(name)
        alone = post(port, {"instances": [images[0].tolist()]},
                     f"{route}:predict")["predictions"][0]
        classified = post(port, {"instances": [images[0].tolist()]},
                          f"{route}:classify")
        t1 = time.perf_counter()
        direct_reply = post(port, {"instances": [x.tolist()
                                                 for x in direct]},
                            f"{route}:predict")["predictions"]
        t_direct = time.perf_counter() - t1
        predict = server.get(name).predict
    finally:
        serving_main.shutdown(server, httpd)
    for reply in replies + [alone] + direct_reply:
        check_cnn_reply(name, reply)
    pairs = classified["result"]["classifications"]
    want = [[str(c), s] for c, s in zip(alone["top_k_classes"],
                                        alone["top_k_scores"])]
    if len(pairs) != 1 or pairs[0] != want:
        fail(f"{name}: :classify {pairs} is not :predict's top k {want}")

    # The server adds no numeric change: each served row equals the
    # loader's predict on the same image at its served batch size (the
    # batcher pads to 1, 2, 4 or 8 rows; the image repeated to fill).
    hist = {n: k - before.get(n, 0)
            for n, k in stats["batch_size_hist"].items()
            if k > before.get(n, 0)}
    padded = sorted({next(s for s in (1, 2, 4, 8) if s >= int(n))
                     for n in hist})

    def scores_at(image, rows):
        batch = np.stack([image] * rows)
        return predict({"image": batch})["scores"][0]

    for i, reply in enumerate(replies):
        got = np.asarray(reply["scores"], np.float32)
        if not any(np.array_equal(got, scores_at(images[i], rows))
                   for rows in padded):
            fail(f"{name}: served request {i} differs from the loader's "
                 f"predict at every served batch size {padded}")
    mine = predict({"image": np.stack(direct)})["scores"]
    if not np.array_equal(np.asarray([r["scores"] for r in direct_reply],
                                     np.float32), mine):
        fail(f"{name}: the direct 8-row reply differs from the loader's "
             "predict on the same rows")
    if not np.array_equal(np.asarray(alone["scores"], np.float32),
                          scores_at(images[0], 1)):
        fail(f"{name}: the lone request differs from the loader's predict")

    # bf16 logits against float32 (TF32 off) on the direct rows.
    x = torch.from_numpy(np.stack(direct).astype(np.float32) / 255.0).cuda()
    f32 = cnn_model(name, torch.float32, "cuda")
    stats32 = load_cnn_variables(f32, variables)
    with torch.inference_mode():
        want32 = f32(x, stats32)
        got16 = predict.model(x, predict.batch_stats)
        with bf16_batchnorm(torch):
            control = predict.model(x, predict.batch_stats)
    rel = ((got16 - want32).norm() / want32.norm()).item()
    rel_control = ((control - want32).norm() / want32.norm()).item()
    bound = CNN_LOGITS_REL_TOL[name]
    log(f"{name}: bf16 logits against float32 (TF32 off) on "
        f"{CNN_DIRECT_ROWS} images: relative Frobenius error {rel:.4e}, "
        f"the control with BatchNorm normalizing in bf16 {rel_control:.4e} "
        f"(bound {bound}); argmax agrees on "
        f"{int((got16.argmax(-1) == want32.argmax(-1)).sum())} of "
        f"{CNN_DIRECT_ROWS}")
    if not rel <= bound:
        fail(f"{name}: bf16 logits are {rel:.4e} from float32")
    if not rel_control > bound:
        fail(f"{name}: the bf16-BatchNorm control reads {rel_control:.4e}, "
             f"inside the bound {bound}: the bound would not see that loss "
             "of precision")
    del f32, stats32

    def one_batch():
        predict({"image": np.stack(direct)})
        torch.cuda.synchronize()

    one_batch()
    t0 = time.perf_counter()
    one_batch()
    t_batch = time.perf_counter() - t0
    busy = profile_busy(torch, one_batch,
                        f"{name}: one served batch of {CNN_DIRECT_ROWS}")
    info = {
        "burst_s": t_burst, "requests_per_s": CNN_BURST / t_burst,
        "latency_p50_s": pct(latencies, 0.5),
        "latency_p99_s": pct(latencies, 0.99),
        "batch_size_hist": hist, "direct_8_rows_s": t_direct,
        "batch_of_8_ms": t_batch * 1e3, "logits_rel_err": rel,
        "control_rel_err": rel_control,
        "profile": busy}
    log(f"{name} ({config['family']}, {size} x {size}): burst of "
        f"{CNN_BURST} :predict in {t_burst:.3f} s, "
        f"{info['requests_per_s']:.2f} requests/s, latency p50 "
        f"{info['latency_p50_s']:.3f} s p99 {info['latency_p99_s']:.3f} s "
        f"(client clock, JSON encoding in the same process); batch sizes "
        f"{hist}; direct {CNN_DIRECT_ROWS}-row request {t_direct:.3f} s; "
        f"one batch of {CNN_DIRECT_ROWS} through the loader "
        f"{t_batch * 1e3:.2f} ms (host clock after a sync; information "
        f"only; {card_line()})")
    return info


def serve_cnn(torch, flash, workdir: Path) -> dict:
    """Phase 11: ResNet-50 at 224 and Inception-v3 at 299 (1000 classes,
    seeded weights) served over REST through the classifier loader and
    the MicroBatcher; no flash kernel may launch."""
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    info = {}
    for name in CNN_SERVED:
        base = workdir / name
        variables = export_cnn(torch, base, name)
        info[name] = serve_cnn_model(torch, base, name, variables)
    launched = {k: n for k, n in flash.launch_counts.items() if n}
    if launched:
        fail(f"the CNN serving path launched flash kernels: {launched}")
    log("CNN serving launched no flash kernel")
    return info


def train_cnn_phase(torch, flash, workdir: Path) -> dict:
    """Phase 12: tools/train_cnn.run on bench.py's ResNet-50 cell (batch
    256 at 224, bf16, sgd(0.1, momentum 0.9), synthetic data) for 4
    steps, verified checkpoints every 2; Trainer.fit for 30 steps on one
    repeated batch of 32 must lower the loss; then, information only,
    the step on a batch staged on the card: time, images/s, MFU, peak
    memory and one profiled step."""
    import numpy as np

    from kubeflow_tpu_torch.models.classification import classification_task
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.runtime import checkpoint, optim
    from kubeflow_tpu_torch.runtime.train import Trainer
    from kubeflow_tpu_torch.tools import train_cnn

    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    ckpt = workdir / "cnn_ckpt"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_cnn.run(CNN_TRAIN_FLAGS + [
        "--steps", str(CNN_TRAIN_STEPS), "--log-every", "1",
        "--checkpoint-dir", str(ckpt), "--checkpoint-every",
        str(CNN_CKPT_EVERY), "--max-restarts", "0"])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    history = trainer.metrics.history
    losses = [r["loss"] for r in history]
    if len(losses) != CNN_TRAIN_STEPS or not all(
            map(math.isfinite, losses + [trainer.last_metrics.get(
                "grad_norm", float("nan"))])):
        fail(f"train_cnn: non-finite or missing losses {losses}")
    saved = trainer.checkpoints.all_steps()
    verdicts = {s: checkpoint.verify_step(ckpt, s) for s in saved}
    if saved != [1, 3] or not all(ok for ok, _ in verdicts.values()):
        fail(f"train_cnn: saved steps {saved}, verify {verdicts}")
    run_step = sorted(r["step_time_s"] for r in history[1:])
    run_step = run_step[len(run_step) // 2]
    log(f"train_cnn.run: {CNN_TRAIN_STEPS} steps of ResNet-50, batch "
        f"{CNN_TRAIN_BATCH} x 224 x 224, losses "
        f"{[round(x, 4) for x in losses]}, saved steps {saved} (verified); "
        f"median step {run_step * 1e3:.1f} ms over steps 1-"
        f"{CNN_TRAIN_STEPS - 1} with the host drawing each synthetic batch "
        f"(numpy randn), whole run {t_run:.1f} s (information only)")

    flops = ResNetConfig("resnet50").fwd_flops_per_image
    cfg = ResNetConfig("resnet50", dtype=torch.bfloat16)

    def fresh_trainer():
        init_fn, loss_fn = classification_task(
            cfg.build(device="cuda"), (1, 224, 224, 3), device="cuda")
        return Trainer(init_fn=init_fn, loss_fn=loss_fn,
                       tx=optim.sgd(0.1, momentum=0.9), device="cuda")

    learner = fresh_trainer()
    rng = np.random.RandomState(SEED)
    batch = {"image": rng.randn(CNN_LEARN_BATCH, 224, 224, 3).astype(
        np.float32), "label": rng.randint(0, 1000, size=(CNN_LEARN_BATCH,))}
    learner.fit(itertools.repeat(batch), CNN_LEARN_STEPS,
                state=learner.create_state(SEED), log_every=1)
    learned = [r["loss"] for r in learner.metrics.history]
    tail = sum(learned[-5:]) / 5
    log(f"learning: {CNN_LEARN_STEPS} steps on one repeated batch of "
        f"{CNN_LEARN_BATCH}: first loss {learned[0]:.4f}, mean of the last "
        f"5 {tail:.4f}, a drop of {learned[0] - tail:.4f} (bound: the mean "
        f"of the last 5 below the first)")
    if not (math.isfinite(tail) and tail < learned[0]):
        fail("the ResNet-50 loss did not fall on a repeated batch")
    del learner

    timer = fresh_trainer()
    state = timer.create_state(SEED)
    step = timer.compile_step()
    big = timer.shard_batch({
        "image": rng.randn(CNN_TRAIN_BATCH, 224, 224, 3).astype(np.float32),
        "label": rng.randint(0, 1000, size=(CNN_TRAIN_BATCH,))})
    torch.cuda.reset_peak_memory_stats()

    def one():
        nonlocal state
        state, _ = step(state, big)
        torch.cuda.synchronize()

    one()  # warm-up at this batch shape
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        one()
        times.append(time.perf_counter() - t0)
    step_s = sorted(times)[1]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    mfu = 3 * flops * CNN_TRAIN_BATCH / step_s / PEAK_BF16_FLOPS
    log(f"ResNet-50 step on a staged batch of {CNN_TRAIN_BATCH} x 224 x "
        f"224: median of 3 {step_s * 1e3:.1f} ms (host clock after a "
        f"sync), {CNN_TRAIN_BATCH / step_s:.1f} images/s, MFU {mfu:.4f} "
        f"(3 x {flops:.3g} x {CNN_TRAIN_BATCH} / step / "
        f"{PEAK_BF16_FLOPS:.3g}), peak memory {peak_gib:.2f} GiB "
        f"(information only; {card_line()})")
    busy = profile_busy(torch, one, f"one ResNet-50 training step of "
                        f"batch {CNN_TRAIN_BATCH}")
    launched = {k: n for k, n in flash.launch_counts.items() if n}
    if launched:
        fail(f"the CNN training path launched flash kernels: {launched}")
    log("CNN training launched no flash kernel")
    return {"run_losses": losses, "run_step_ms": run_step * 1e3,
            "saved_steps": saved, "learn_first": learned[0],
            "learn_last5": tail, "step_ms": step_s * 1e3,
            "images_per_s": CNN_TRAIN_BATCH / step_s, "mfu": mfu,
            "peak_gib": peak_gib, "profile": busy}


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
    phase_s = {}
    t_phase = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase[0], 3)
        t_phase[0] = now

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
    phase_done("1 card and build")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = check_kernels(torch, flash, gen)
    bwd_checks = check_bwd_kernels(torch, flash, gen, checks)
    check_bwd_heads_apart(torch, flash)
    check_autograd(torch, flash, gen)
    two_pass_checks = check_two_pass_kernels(torch, flash, gen)
    phase_done("2 kernels")
    timed = time_kernels(torch, flash, gen, checks)
    timed.update(time_train_kernels(torch, flash, gen, timed, bwd_checks))
    two_pass_rows, two_pass_times = time_two_pass(torch, flash, gen,
                                                  two_pass_checks)
    phase_done("3 timing")

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
        replies, direct_reply, counts = serve(
            torch, flash, base, prompts, direct)
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            fail(f"kernels never launched on the serving path: {missing}")
        phase_done("4 serve")
        check_replies(prompts, replies, direct, direct_reply)
        check_prefill_logits(torch, flash, base, gen)
        phase_done("5 check")
        breakdown(torch, base, gen)
        phase_done("6 breakdown")
        engine_tokens, engine_info = serve_engine(torch, flash, base,
                                                  prompts)
        engine_info["bf16_first_difference"] = engine_identity(
            torch, flash, base, prompts, engine_tokens)
        engine_info["round"] = engine_round(torch, base)
        phase_done("6b engine")
        spec_info = serve_spec(torch, flash, base)
        spec_info["identity"] = spec_identity(torch, flash, base)
        spec_info["verify_call"] = verify_call(torch, base)
        phase_done("6c speculation")
        tier_info = serve_tiers(torch, flash, base)
        tier_info["identity"] = tier_identity(torch, flash, base)
        phase_done("6d tiers")
        int8_base = workdir / "lm_int8"
        export_int8(base, int8_base)
        int8_info = serve_int8(torch, flash, base, int8_base)
        int8_identity(torch, flash, base)
        int8_info.update(int8_numbers(
            torch, flash, base,
            engine_info["round"]["captured"]["round_ms"]))
        phase_done("6e int8")
        spill_info = spill_tier(torch, flash, base, int8_base)
        phase_done("6f spill tier")
        launches_before = dict(flash.launch_counts)
        adir = workdir / "adapters"
        write_adapters(torch, adir)
        adapter_info = serve_adapters(torch, flash, base, adir)
        adapter_info["identity"] = adapter_identity(torch, flash, base,
                                                    adir)
        adapter_info.update(adapter_numbers(
            torch, base, adir, engine_info["round"]["captured"]["round_ms"]))
        launches = {k: flash.launch_counts[k] - launches_before.get(k, 0)
                    for k in flash.launch_counts}
        if any(launches.values()):
            fail(f"the adapter phase launched flash kernels: {launches}")
        adapter_info["flash_launches"] = launches
        log(f"flash launch counters over phase 6g: {launches}")
        phase_done("6g adapters")
        train_counts, train_info = train(torch, flash, workdir)
        two_pass_counts, two_pass_info = train_two_pass(torch, flash)
        phase_done("7 train")
        log(f"train, single pass + adamw against two-pass + adafactor: "
            f"median step {train_info['step_ms']:.1f} / "
            f"{two_pass_info['step_ms']:.1f} ms, MFU "
            f"{train_info['mfu']:.4f} / {two_pass_info['mfu']:.4f}, peak "
            f"memory {train_info['peak_gib']:.2f} / "
            f"{two_pass_info['peak_gib']:.2f} GiB (host clock, one call; "
            f"information only)")
        ckpt_info = checkpoint_and_data(torch, workdir)
        phase_done("10 checkpoints and data")
        grads = check_gradients(torch, flash)
        phase_done("8 gradients")
        learned = learn_and_breakdown(torch)
        phase_done("9 learning")
        cnn_serve_info = serve_cnn(torch, flash, workdir)
        phase_done("11 CNN serve")
        cnn_train_info = train_cnn_phase(torch, flash, workdir)
        phase_done("12 CNN train")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

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
    for name, row in two_pass_rows.items():
        # Their launches are the two-pass training phase's.
        row["launches"] = two_pass_counts[name]
        row["path"] = "train"
        row["launches_by_path"] = {"serve": counts.get(name, 0),
                                   "train": two_pass_counts[name]}
        kernels.append(row)
    log(json.dumps({"engine": engine_info,
                    "speculation": spec_info, "tiers": tier_info,
                    "int8": int8_info, "spill": spill_info,
                    "adapters": adapter_info,
                    "train": dict(train_info, gradients=grads,
                                  breakdown=learned),
                    "train_two_pass": dict(two_pass_info,
                                           forward=two_pass_times),
                    "checkpoint": ckpt_info,
                    "cnn_serve": cnn_serve_info,
                    "cnn_train": cnn_train_info}))
    log(f"phase times (s): {json.dumps(phase_s)}; total "
        f"{sum(phase_s.values()):.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
