#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (kubeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure (exit code 1, no result line):
  1. card: name and power limit from nvidia-smi; build the CUDA kernel
     of the serving path from the source in the checkout and time the
     build;
  2. kernels: each kernel against its plain PyTorch version on the card
     (causal / masked / non-causal, head_dim 64 and 128, lengths that are
     not tile multiples, key starts that fully mask the first tiles);
  3. timing: each kernel at the shape the serving path gives it, beside
     its plain version, its bound, and one PyTorch library call;
  4. serve: export a seeded 188M LM (bench.py's configuration, random
     weights), start the port's REST server in this process with bucketed
     static batching, send concurrent mixed-length :predict requests and
     one direct two-row request; the kernels' launch counters are zeroed
     just before and read just after, and every kernel must have run;
  5. check: every reply is prompt + max_new_tokens tokens in the
     vocabulary, and the prefill logits of one left-padded bf16 batch
     through the kernel are no further from a float32 run of the same
     weights than the same batch through the plain version is;
  6. breakdown (information only): prefill and decode time of one
     bucketed batch, and under torch.profiler the device's busy share
     and the kernels that take its time.

The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import http.client
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
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
JAX_LOADER = "kubeflow_tpu.serving.loaders:lm_generate"
KERNEL_SOURCE = "kubeflow_tpu_torch/ops/csrc/flash_fwd.cu"
TPU_KERNEL = "kubeflow_tpu/ops/flash.py:70"


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
        torch.cuda.synchronize()
        ro, rlse = flash.flash_fwd_reference(
            q.float(), k.float(), v.float(), causal=causal, kv_start=ks)
        err_o = (o.float() - ro).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        rel_o = ((o.float() - ro).norm() / ro.norm()).item()
        ok_o = torch.allclose(o.float(), ro, **O_TOL) and rel_o <= O_REL_TOL
        ok_lse = torch.allclose(lse, rlse, atol=LSE_ATOL, rtol=0)
        finite = bool(torch.isfinite(o).all())
        log(f"check {name}: bh={bh} sq={sq} sk={sk} d={d} causal={causal} "
            f"masked={starts is not None} max|o-ref|={err_o:.3e} "
            f"|o-ref|_F/|ref|_F={rel_o:.3e} max|lse-ref|={err_lse:.3e} "
            f"(bounds o atol/rtol {O_TOL['atol']}, o relative "
            f"{O_REL_TOL}, lse atol {LSE_ATOL})")
        if not (ok_o and ok_lse and finite):
            fail(f"kernel disagrees with its plain version on {name}")
        results.append({"variant": name, "masked": starts is not None,
                        "max_abs_err_o": err_o, "rel_err_o": rel_o,
                        "max_abs_err_lse": err_lse})
        del q, k, v, o, lse, ro, rlse
    return results


def time_kernels(torch, flash, gen, checks):
    """Phase 3: each kernel at the serving path's heaviest shape."""
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
        t_ops = ops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
        mine = [c for c in checks if c["masked"] == (ks is not None)]
        rows[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL,
            "shape": {"bh": bh, "sq": s, "sk": s, "d": d, "causal": True},
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "library_ms": library_ms,
            "max_abs_err": max(c["max_abs_err_o"] for c in mine),
            "checks": mine,
        }
        log(f"time {name}: bh={bh} s={s} d={d} kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{max(t_ops, t_bytes):.4f} ms ({rows[name]['bound_by']}; "
            f"operations {t_ops:.4f} ms for {ops:.4g}, bytes {t_bytes:.4f} "
            f"ms for {nbytes:.4g})")
        del q, k, v, ks
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
    counts = dict(flash.launch_counts)
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
    kernel_fn = flash._flash_fwd_cuda

    def plain(q, k, v, *, causal, kv_start=None):
        o, lse = flash.flash_fwd_reference(q, k, v, causal=causal,
                                           kv_start=kv_start)
        return o.to(q.dtype), lse

    flash._flash_fwd_cuda = plain
    try:
        through_plain = prefill(torch.bfloat16)
        reference = prefill(torch.float32)
    finally:
        flash._flash_fwd_cuda = kernel_fn
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
    _build.build("flash_fwd")
    log(f"built CUDA kernels in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("flash_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = check_kernels(torch, flash, gen)
    timed = time_kernels(torch, flash, gen, checks)

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
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels = []
    for name, row in timed.items():
        row["launches"] = counts[name]
        kernels.append(row)
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
