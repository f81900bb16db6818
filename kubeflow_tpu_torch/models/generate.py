"""Autoregressive decoding: the port of kubeflow_tpu/models/generate.py.

Two families of entry points share one per-layer step:

- ``generate()``, the contiguous-cache path: the prompt is prefilled in
  one batched forward, then tokens stream one position at a time
  against a preallocated ``[layers, b, max_len, hkv, d]`` KV cache,
  which this port updates in place.  A flash-configured model prefills
  through the flash forward (ops/flash.py) with the per-row key-start
  mask for left-padded prompts; decode steps take
  ``dot_product_attention`` over the cache's live columns.  Sampling
  draws from an explicit ``torch.Generator``.
- The slot programs that the continuous-batching engine
  (serving/engine.py) drives over a persistent PAGED KV pool:
  ``init_paged_state``, ``prefill_chunk_into_slot``, ``decode_step`` and
  ``decode_rounds``.  Each takes the host-owned per-slot block tables as
  an argument, and each slot ropes, writes and attends at its own
  length.  No program reads a device value on the host, so a caller can
  queue them back to back.  Their per-call scalars may be 0-d device
  tensors (JAX's traced operands), and each has an in-place form that
  writes into the state's own tensors, so a CUDA graph can capture it
  once and replay it with new scalars (serving/programs.py).

Where JAX drops a scatter (``mode="drop"``), this port redirects the
write: the pool carries one scratch block past the ``nb`` blocks the
state shows (``_pool_with_scratch``), and a write whose table entry is
the sentinel ``nb``, whose logical block lies past the table, or whose
column parks a retired slot lands there.  Reads of sentinel table
entries see the scratch block; the causal frontier masks them.  A write
to the ``[S]`` slot scalars at an index out of range matches no row.

Sampling in the slot programs is per slot: a slot's ``keys`` row is its
``(seed, step)`` counter, and its Gumbel noise is a hash of
``(seed, step, token id)`` computed on the device (``_slot_uniform``).
A request's stream therefore depends on its own seed and step only,
never on which requests share the batch.  It is the port's own stream:
JAX's threefry bits are not matched.  Greedy decoding matches JAX token
for token.

The engine's speculative verify (``verify_step``) and the KV-page
handoff pair (``gather_kv_pages``, ``import_kv_pages``) run over the
same pool.  With ``kv_cache_dtype="int8"`` every cache, contiguous or
paged, is a pair of int8 ``QTensor``s with one float32 scale per
(position, head) (ops/quantize.py), written through ``quantize_array``
and read by ``dot_product_attention`` with the scales folded into both
matmuls; a quantized cache never takes the flash prefill.  The model's
weights may be int8 too.

Adapter-array serving: the slot programs take an optional ``adapters``
stack, a dict ``{"attn": {...}, "mlp": {...}}`` of ``[rows, layers,
...]`` tensors in the model dtype (serving/adapters.py's factor shapes;
row 0 the all-zero base), which the engine owns on the device.  Each
slot's row index is ``state["adapter_ids"]``, armed by
``prefill_chunk_into_slot``; every forward gathers each row's factors
from the stack and adds its low-rank delta to the q, k, v (before
rope), attention-out and MLP projections in two rank-r hops
(``_lora``).  Without a stack every program runs the exact operations
it runs without adapters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.models.transformer import (
    Block,
    Transformer,
    TransformerConfig,
    rope,
)
from kubeflow_tpu_torch.ops.attention import dot_product_attention
from kubeflow_tpu_torch.ops.flash import flash_attention
from kubeflow_tpu_torch.ops.quantize import QTensor, quantize_array

CacheLen = Union[int, torch.Tensor]
Cache = Union[torch.Tensor, QTensor]
Adapters = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0   # 0 = greedy
    # Filters applied in this order when temperature > 0: top_k keeps the
    # k highest logits (0 = off), top_p the smallest set whose mass
    # reaches p (1.0 = off).
    top_k: int = 0
    top_p: float = 1.0
    eos_token: int = -1        # -1 = never stop early
    # "model" = the model's compute dtype; "int8" = a quantized cache with
    # per-(position, head) scales.
    kv_cache_dtype: str = "model"

    def __post_init__(self):
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p} "
                "(1.0 disables nucleus filtering)")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


def _zeros_cache(cfg: TransformerConfig, shape, kv_cache_dtype: str,
                 device: torch.device) -> Cache:
    """One zeroed cache side of ``shape`` ([..., hkv, d]): the compute
    dtype, or an int8 QTensor whose scale drops the head dim."""
    if kv_cache_dtype == "int8":
        return QTensor(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device), (-1,))
    if kv_cache_dtype != "model":
        raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}")
    return torch.zeros(shape, dtype=cfg.dtype, device=device)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: DeviceLike = None,
               kv_cache_dtype: str = "model") -> Tuple[Cache, Cache]:
    """Zeroed (k, v) caches, each [L, b, max_len, hkv, d] (int8 QTensors
    for ``kv_cache_dtype="int8"``), on ``device`` (CUDA when none is
    given)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (_zeros_cache(cfg, shape, kv_cache_dtype, device),
            _zeros_cache(cfg, shape, kv_cache_dtype, device))


def _pool_with_scratch(cache: Cache) -> Cache:
    """[L, nb, bt, ...] pool view -> [L, nb + 1, ...] over the same
    storage: block ``nb`` is the scratch block that ``init_paged_state``
    allocates past the view, where dropped writes land.  A QTensor pool
    gets the scratch block of its values and of its scales."""
    if isinstance(cache, QTensor):
        return QTensor(_pool_with_scratch(cache.values),
                       _pool_with_scratch(cache.scale), cache.axes)
    size = (cache.shape[0], cache.shape[1] + 1) + tuple(cache.shape[2:])
    end = cache.storage_offset() + sum(
        (n - 1) * st for n, st in zip(size, cache.stride())) + 1
    if cache.untyped_storage().nbytes() < end * cache.element_size():
        raise ValueError(
            "paged KV pool has no scratch block past its view; build it "
            "with init_paged_state")
    return cache.as_strided(size, cache.stride(), cache.storage_offset())


def _store(cache: Cache, new: torch.Tensor, write) -> None:
    """Write the fresh k or v ``new`` [b, t, hkv, d] into ``cache`` with
    ``write(tensor, values)``: cast to the cache's dtype, or, for an int8
    QTensor, quantized over the head dim (one scale per (position, head))
    with values and scales written alike."""
    if isinstance(cache, QTensor):
        values, scale = quantize_array(new, (-1,))
        write(cache.values, values)
        write(cache.scale, scale)
    else:
        write(cache, new.to(cache.dtype))


def _store_paged(pool: Cache, new: torch.Tensor, blk: torch.Tensor,
                 off: torch.Tensor) -> None:
    """pool [nb + 1, bt, hkv, d]: write new [b, t, hkv, d] at (blk, off),
    both [b, t]; blk == nb is the scratch block."""
    def write(dst, src):
        dst[blk, off] = src

    _store(pool, new, write)


def _store_columns(cache: Cache, new: torch.Tensor,
                   cols: torch.Tensor) -> None:
    """cache [b, max_len, hkv, d]: row r's new[r, j] goes to column
    cols[r, j]; a column past max_len is dropped.  One column of every
    row per write, so the clamped stand-in of a dropped column (which
    writes back what the cache holds) never shares an index with a kept
    write of the same call."""
    rows = torch.arange(new.shape[0], device=new.device)

    def write(dst, src):
        max_len = dst.shape[1]
        for j in range(src.shape[1]):
            col = cols[:, j]
            keep = (col >= 0) & (col < max_len)
            at = col.clamp(0, max_len - 1)
            keep = keep.view((-1,) + (1,) * (src.dim() - 2))
            dst[rows, at] = torch.where(keep, src[:, j], dst[rows, at])

    _store(cache, new, write)


def _store_slice(cache: Cache, new: torch.Tensor, at: int) -> None:
    """cache [b, max_len, hkv, d]: new [b, t, hkv, d] at columns
    [at, at + t)."""
    def write(dst, src):
        dst[:, at:at + src.shape[1]] = src

    _store(cache, new, write)


def _lora(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, spec_a: str,
          spec_b: str) -> torch.Tensor:
    """Per-row low-rank delta: contract ``x`` against PER-ROW factor
    slices ``a``/``b`` (leading batch axis: row i's slice is its own
    adapter's, gathered by ``_forward_with_cache`` from the stack) in two
    rank-r hops, so the full-rank delta never materializes.  Rows are
    independent, so a mixed-adapter batch gives each row what it gets
    alone."""
    mid = torch.einsum(spec_a, x, a)
    return torch.einsum(spec_b, mid, b).to(x.dtype)


def _adapted_qkv(cfg: TransformerConfig, block: Block, x: torch.Tensor,
                 positions: torch.Tensor, ad: Dict[str, torch.Tensor]):
    """``block.attn.qkv(block.attn_norm(x), positions)`` with each row's
    low-rank deltas added to q, k and v before rope, so the delta is part
    of the projection itself."""
    y = block.attn_norm(x)
    q, k, v = block.attn.project(y)
    q = q + _lora(y, ad["wq_a"], ad["wq_b"], "bse,ber->bsr",
                  "bsr,brhd->bshd")
    k = k + _lora(y, ad["wkv_a"][:, 0], ad["wkv_b"][:, 0], "bse,ber->bsr",
                  "bsr,brhd->bshd")
    v = v + _lora(y, ad["wkv_a"][:, 1], ad["wkv_b"][:, 1], "bse,ber->bsr",
                  "bsr,brhd->bshd")
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _adapted_out_and_mlp(block: Block, x: torch.Tensor, out: torch.Tensor,
                         adapters):
    """The block's attention-out projection and MLP with each row's
    low-rank deltas: ``wo`` from the attention output, the MLP's gate and
    up before silu, its ``wo`` from the hidden ``h``."""
    ad = adapters["attn"]
    y = block.attn.out(out) + _lora(out, ad["wo_a"], ad["wo_b"],
                                    "bshd,bhdr->bsr", "bsr,bre->bse")
    x = x + y
    y = block.mlp_norm(x)
    ad = adapters["mlp"]
    gate, up = block.mlp.gate_up(y)
    gate = gate + _lora(y, ad["wi_a"][:, 0], ad["wi_b"][:, 0],
                        "bse,ber->bsr", "bsr,brf->bsf")
    up = up + _lora(y, ad["wi_a"][:, 1], ad["wi_b"][:, 1], "bse,ber->bsr",
                    "bsr,brf->bsf")
    h = torch.nn.functional.silu(gate) * up
    y = block.mlp.down(h) + _lora(h, ad["wo_a"], ad["wo_b"], "bsf,bfr->bsr",
                                  "bsr,bre->bse")
    return x + y


def _layer_step(cfg: TransformerConfig, block: Block, x: torch.Tensor,
                cache_kv: Tuple[torch.Tensor, torch.Tensor],
                cache_len: CacheLen, positions: torch.Tensor,
                pad_amount: Optional[torch.Tensor] = None,
                write_cols: Optional[torch.Tensor] = None,
                tables: Optional[torch.Tensor] = None,
                adapters=None) -> torch.Tensor:
    """One decoder block against one layer's cache, which it updates in
    place.

    x: [b, t, e] new activations (t = prompt width at prefill, 1 at
    decode); cache_kv: (k, v) each [b, max_len, hkv, d], or, with
    ``tables``, the paged pool [nb + 1, bt, hkv, d] with its scratch
    block; cache_len: valid cache positions before this call, an int
    (the whole batch at one length) or a per-row [b] tensor (each row
    writes its t columns from its own frontier and attends under its
    own causal mask); pad_amount: per-row [b] left-pad width, whose
    cache columns are masked from every attention; write_cols: per-row
    [b] first column to write when cache_len is per-row (defaults to
    cache_len; a retired slot passes a column past the table, whose
    write is dropped); tables: [b, mb] block tables mapping each row's
    logical block (position // bt) to a pool block, the sentinel ``nb``
    for none.  Fresh k/v go straight into the pool, and attention runs
    over the row's gathered [mb * bt] view of it.  adapters: this layer's
    per-row factors ({"attn": {...}, "mlp": {...}}, each [b, ...]), whose
    low-rank deltas join every projection; None runs the block's own
    projections.
    """
    ck, cv = cache_kv
    b, t = x.shape[:2]
    per_row = isinstance(cache_len, torch.Tensor) and cache_len.ndim == 1
    if adapters is None:
        q, k, v = block.attn.qkv(block.attn_norm(x), positions)
    else:
        q, k, v = _adapted_qkv(cfg, block, x, positions, adapters["attn"])
    steps = torch.arange(t, device=x.device)
    quantized = isinstance(ck, QTensor)
    if tables is not None:
        nb, bt = ck.shape[0] - 1, ck.shape[1]
        mb = tables.shape[1]
        if per_row:
            base = cache_len if write_cols is None else write_cols
            pos = base.long()[:, None] + steps[None, :]
        else:
            pos = (cache_len + steps)[None, :].expand(b, t)
        blk_slot = pos // bt
        blk = torch.take_along_dim(tables, blk_slot.clamp(0, mb - 1), dim=1)
        # A logical block past the table, or a sentinel entry, sends the
        # write to the scratch block (JAX drops it).
        keep = (blk_slot < mb) & (blk >= 0) & (blk < nb)
        blk = torch.where(keep, blk, nb)
        off = pos % bt
        _store_paged(ck, k, blk, off)
        _store_paged(cv, v, blk, off)

        def paged_view(pool):
            if isinstance(pool, QTensor):
                return QTensor(paged_view(pool.values),
                               paged_view(pool.scale), pool.axes)
            return pool[tables].reshape((b, mb * bt) + tuple(pool.shape[2:]))

        out = dot_product_attention(
            q, paged_view(ck), paged_view(cv), causal=True,
            kv_offset=cache_len, kv_valid_start=pad_amount)
    else:
        if per_row:
            base = cache_len if write_cols is None else write_cols
            cols = base.long()[:, None] + steps[None, :]
            _store_columns(ck, k, cols)
            _store_columns(cv, v, cols)
        else:
            # dynamic_update_slice clamps a start that would run past the
            # cache's end; a torch slice would not.
            at = max(0, min(cache_len, ck.shape[1] - t))
            _store_slice(ck, k, at)
            _store_slice(cv, v, at)
        if (cfg.attention == "flash" and t > 1 and not per_row
                and cache_len == 0 and not quantized):
            # Prefill: the cache is empty, so causal attention over the
            # fresh q/k/v is the whole computation, and the flash forward
            # keeps the [b, h, t, t] scores out of device memory.  A
            # quantized cache attends over its own rounding instead, as
            # in JAX (its serving goldens pin that rounding).
            out = flash_attention(
                q, k, v, causal=True,
                block_q=cfg.flash_block_q, block_k=cfg.flash_block_k,
                kv_valid_start=pad_amount)
        elif per_row:
            out = dot_product_attention(
                q, ck, cv, causal=True, kv_offset=cache_len,
                kv_valid_start=pad_amount)
        else:
            # Columns past cache_len + t hold nothing yet and would get
            # zero weight under the causal mask; attending over the live
            # span only gives the same result.
            live = cache_len + t
            out = dot_product_attention(
                q, ck[:, :live], cv[:, :live], causal=True,
                kv_offset=cache_len, kv_valid_start=pad_amount)
    if adapters is not None:
        return _adapted_out_and_mlp(block, x, out, adapters)
    x = x + block.attn.out(out)
    return x + block.mlp(block.mlp_norm(x))


def _forward_with_cache(model: Transformer, tokens: torch.Tensor,
                        cache: Tuple[Cache, Cache],
                        cache_len: CacheLen,
                        pad_amount: Optional[torch.Tensor] = None,
                        write_cols: Optional[torch.Tensor] = None,
                        tables: Optional[torch.Tensor] = None,
                        adapter_ids: Optional[torch.Tensor] = None,
                        adapters: Optional[Adapters] = None
                        ) -> torch.Tensor:
    """tokens [b, t] -> float32 logits [b, t, v]; the cache is updated in
    place.

    cache_len int: the whole batch sits at one length (generate()), and
    writes columns [cache_len, cache_len + t).  cache_len [b]: per-row
    lengths (the slot programs); each row ropes its t tokens at
    [len, len + t), writes from write_cols (default cache_len) and
    attends under its own frontier.  tables: per-row block tables of the
    paged pool (``init_paged_state``'s ``cache_k``/``cache_v``); None
    keeps the contiguous layout.  adapter_ids ([b] int, optional): each
    row's index into the stacked ``adapters`` (``[rows, layers, ...]``
    tensors, row 0 the all-zero base); one gather a forward pulls each
    row's factors out of the stack.  Without a stack the ids are not
    read, as JAX ignores them without one.
    """
    t = tokens.shape[1]
    steps = torch.arange(t, device=tokens.device)
    if isinstance(cache_len, torch.Tensor) and cache_len.ndim == 1:
        positions = cache_len.long()[:, None] + steps[None, :]
    else:
        positions = (cache_len + steps)[None, :].expand(tokens.shape)
    if pad_amount is not None:
        # Real token i of a left-padded row sits at column pad + i but
        # takes rope position i; pad columns clamp to 0 (their keys are
        # masked anyway).
        positions = torch.clamp(positions - pad_amount[:, None], min=0)
    cache_k, cache_v = cache
    if tables is not None:
        cache_k = _pool_with_scratch(cache_k)
        cache_v = _pool_with_scratch(cache_v)
    stack = None
    if adapters is not None and adapter_ids is not None:
        # Per-row gather: [rows, L, ...] -> [b, L, ...]; layer i reads
        # [:, i].  One gather a forward, one program for every mix of
        # co-batched variants.
        ids = adapter_ids.reshape(-1).long()
        dt = model.cfg.dtype
        stack = {grp: {name: leaf.index_select(0, ids).to(dt)
                       for name, leaf in leaves.items()}
                 for grp, leaves in adapters.items()}
    x = model.embed_tokens(tokens)
    for i, block in enumerate(model.layers):
        ad = None if stack is None else {
            grp: {name: leaf[:, i] for name, leaf in leaves.items()}
            for grp, leaves in stack.items()}
        x = _layer_step(model.cfg, block, x, (cache_k[i], cache_v[i]),
                        cache_len, positions, pad_amount,
                        write_cols=write_cols, tables=tables, adapters=ad)
    return model.logits(x).to(torch.float32)


def _filter_logits(decode: DecodeConfig, logits: torch.Tensor) -> torch.Tensor:
    """Temperature, then top_k, then top_p filtering of [..., vocab]."""
    logits = logits / decode.temperature
    if decode.top_k > 0:
        k = min(decode.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, -torch.inf))
    if decode.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # Keep every token whose PRECEDING mass is < p, so the token that
        # crosses p stays in; threshold at the smallest kept logit.
        keep = torch.cumsum(probs, dim=-1) - probs < decode.top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, torch.inf)
                             ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= cutoff, logits,
                             torch.full_like(logits, -torch.inf))
    return logits


def _sample(decode: DecodeConfig, logits: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if decode.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filter_logits(decode, logits), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def refuse_moe(cfg: TransformerConfig) -> None:
    """Decoding runs the dense MLP of every layer (``block.mlp``, as the
    JAX package's ``_layer_step`` reads ``layer_params["mlp"]``): neither
    package decodes a mixture-of-experts model, so it is refused here
    rather than run wrong."""
    if cfg.moe_experts > 0:
        raise ValueError(
            f"decoding a mixture-of-experts model (moe_experts="
            f"{cfg.moe_experts}) is not supported: generate() and the "
            "DecodeEngine run the dense MLP only; serve its logits with "
            "the lm loader instead")


@torch.inference_mode()
def generate(
    model: Transformer,
    prompt: torch.Tensor,
    decode: DecodeConfig = DecodeConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    prompt_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """prompt [b, t] -> (tokens [b, t + max_new], logits_last [b, vocab]).

    Runs on the model's device.  With ``eos_token >= 0`` the step loop
    stops once every row is done; finished rows emit 0, so the tokens
    equal those of the full-length run.  Sampling (temperature > 0) draws
    from ``generator``, which must live on the model's device; the same
    seed gives the same tokens.

    prompt_len ([b], optional): real prompt lengths of LEFT-padded rows.
    Pad keys are masked from every attention and rope positions count
    from the first real token, so a padded row decodes as it would alone.
    """
    cfg = model.cfg
    refuse_moe(cfg)
    device = model.embed.device
    prompt = prompt.to(device)
    b, t = prompt.shape
    cache = init_cache(cfg, b, t + decode.max_new_tokens, device=device,
                       kv_cache_dtype=decode.kv_cache_dtype)
    pad_amount = None
    if prompt_len is not None:
        pad_amount = t - prompt_len.to(device, torch.int64)

    last = _forward_with_cache(model, prompt, cache, 0, pad_amount)[:, -1]
    new_tokens = torch.zeros((b, decode.max_new_tokens), dtype=prompt.dtype,
                             device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    for i in range(decode.max_new_tokens):
        nxt = _sample(decode, last, generator).to(prompt.dtype)
        nxt = torch.where(done, torch.zeros_like(nxt), nxt)
        new_tokens[:, i] = nxt
        last = _forward_with_cache(model, nxt[:, None], cache, t + i,
                                   pad_amount)[:, -1]
        done = done | (nxt == decode.eos_token)
        if decode.eos_token >= 0 and bool(done.all()):
            break
    return torch.cat([prompt, new_tokens], dim=1), last


# ---------------------------------------------------------------------------
# Continuous-batching slot programs over a persistent paged KV pool
# (serving/engine.py drives them).  The pool is [layers, nb, bt, hkv, d];
# which pool block backs which logical block of which slot is host
# bookkeeping (serving/prefix_cache.py BlockManager), passed into every
# call as the [S, mb] block tables, so sharing a cached prefix between
# slots is a table edit and no copy program exists.  Shapes are fixed
# per engine (slot count, chunk width, pool geometry, table span).
# Retirement is the device-side ``done`` flag: a done slot stops
# advancing and its writes go to the scratch block.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) on int64 lanes
    holding values below 2**32; the multipliers are below 2**31, so no
    product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def _slot_uniform(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """keys [n, 2] int64 (seed, step) -> uniforms [n, vocab] in (0, 1),
    a function of (seed, step, token id) alone."""
    seed = keys[:, :1] & _M32
    step = keys[:, 1:] & _M32
    ids = torch.arange(vocab, device=keys.device)[None, :]
    x = _mix32(_mix32((seed * 0x27D4EB2F) & _M32) ^ step)
    x = _mix32(_mix32(x ^ ids) ^ 0x165667B1)
    return ((x >> 8).to(torch.float32) + 0.5) / float(1 << 24)


def _sample_slots(decode: DecodeConfig, logits: torch.Tensor,
                  keys: torch.Tensor) -> torch.Tensor:
    """Per-slot categorical draw from filtered logits [n, V] by the
    Gumbel-max rule, with each row's noise from its own (seed, step)."""
    u = _slot_uniform(keys, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(_filter_logits(decode, logits) + gumbel, dim=-1)


def _next_keys(keys: torch.Tensor) -> torch.Tensor:
    return torch.stack([keys[:, 0], keys[:, 1] + 1], dim=1)


def init_paged_state(cfg: TransformerConfig, slots: int, num_blocks: int,
                     block_tokens: int, kv_cache_dtype: str = "model",
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Fresh paged engine state on ``device`` (CUDA when none is given):
    every slot retired, block pool zeroed.

    ``cache_k``/``cache_v`` are [layers, num_blocks, block_tokens, hkv,
    d] views of storage that holds one scratch block more (see
    ``_pool_with_scratch``), or, with ``kv_cache_dtype="int8"``, QTensors
    of such views: int8 values and float32 scales [layers, num_blocks,
    block_tokens, hkv], each with its scratch block; the per-slot
    scalars are int32 [S]
    ``lengths`` (valid cache positions), ``stop_len`` (the length at
    which the slot stops sampling), ``last_token`` (sampled, not yet in
    the cache) and ``adapter_ids``, bool [S] ``done`` and int64 [S, 2]
    ``keys``, each slot's (seed, step) sampling counter.  Block tables
    are not device state: the caller passes them into every program.
    """
    device = resolve_device(device)
    full = (cfg.n_layers, num_blocks + 1, block_tokens, cfg.n_kv_heads,
            cfg.head_dim)

    def pool():
        cache = _zeros_cache(cfg, full, kv_cache_dtype, device)
        return cache[:, :num_blocks]

    def scalars(dtype=torch.int32):
        return torch.zeros((slots,), dtype=dtype, device=device)

    return {
        "cache_k": pool(),
        "cache_v": pool(),
        "lengths": scalars(),
        "stop_len": scalars(),
        "last_token": scalars(),
        "done": torch.ones((slots,), dtype=torch.bool, device=device),
        "keys": torch.zeros((slots, 2), dtype=torch.int64, device=device),
        "adapter_ids": scalars(),
    }


def _pool_block_tokens(cache: Cache) -> int:
    """Static block width of a paged pool ([L, nb, bt, ...])."""
    return cache.shape[2]


def import_kv_pages(state: Dict[str, Cache], pages_k: Cache, pages_v: Cache,
                    ids) -> Dict[str, Cache]:
    """The disaggregated KV handoff, device side: scatter page stacks
    ``pages_k``/``pages_v`` ([layers, n, block_tokens, hkv, d]; QTensors
    of values and scales for an int8 pool) into the pool at physical
    blocks ``ids`` ([n]).  An id outside ``[0, nb)`` (the pool-size
    sentinel pads a span to its static width) sends its page, scales
    included, to the scratch block, where JAX drops it.  The pool is
    written in place and ``state`` returned; the pages are cast to the
    pool's dtypes.  After the scatter the pool holds the exporter's bytes,
    and the slot resumes through the ordinary cached-prefix path (chunked
    prefill from the covered offset)."""
    cache_k = state["cache_k"]
    nb = cache_k.shape[1]
    ids = _device_tables(ids, cache_k.device)
    ids = torch.where((ids >= 0) & (ids < nb), ids, nb)

    def scatter(pool, pages):
        pool.index_copy_(1, ids, pages.to(device=pool.device,
                                          dtype=pool.dtype))

    for name, pages in (("cache_k", pages_k), ("cache_v", pages_v)):
        pool = _pool_with_scratch(state[name])
        if isinstance(pool, QTensor):
            scatter(pool.values, pages.values)
            scatter(pool.scale, pages.scale)
        else:
            scatter(pool, pages)
    return state


def gather_kv_pages(state: Dict[str, Cache], ids):
    """The inverse of ``import_kv_pages``: physical blocks ``ids`` of the
    pool as HOST page stacks, one batched index per pool tensor
    ([layers, n, block_tokens, hkv, d] in one transfer).  Returns
    ``((k_values, k_scale), (v_values, v_scale))``, CPU tensors in the
    pool's dtypes; the scales ([layers, n, block_tokens, hkv] float32)
    are None for a pool of the compute dtype.  Not a program: ``n``
    varies per request; the engine runs it on its loop thread between
    program calls, while the pages are still held, on the stream its
    programs run on, so the copy follows every write queued before it."""
    device = state["done"].device
    ids = _device_tables(ids, device)

    def gather(pool):
        if isinstance(pool, QTensor):
            return (pool.values.index_select(1, ids).cpu(),
                    pool.scale.index_select(1, ids).cpu())
        return pool.index_select(1, ids).cpu(), None

    return gather(state["cache_k"]), gather(state["cache_v"])


def _device_tables(tables, device: torch.device) -> torch.Tensor:
    """Block tables as int64 indices on ``device`` (no copy when they
    already are)."""
    return torch.as_tensor(tables, device=device).long()


def _scalar(value, device: torch.device) -> torch.Tensor:
    """A program scalar as a 0-d int64 tensor on ``device``: a host int
    is copied up, a tensor (a view of a caller's device buffer) is
    read where it lies."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int64)
    return torch.tensor(int(value), dtype=torch.int64, device=device)


def _assign(state: Dict[str, torch.Tensor],
            new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Write a program's new slot scalars into ``state``'s own tensors
    (the in-place form: a CUDA graph reads and writes fixed addresses).
    Returns ``state``."""
    for name, value in new.items():
        if value is not state[name]:
            state[name].copy_(value)
    return state


def _advance_slots(model: Transformer, decode: DecodeConfig,
                   tables: torch.Tensor, park: int,
                   state: Dict[str, torch.Tensor],
                   adapters: Optional[Adapters] = None):
    """One batched decode step over every slot: the body of
    ``decode_step`` and ``decode_rounds``.  Returns (state, nxt [S]),
    the sampled token per slot (0 for frozen slots); the returned
    state's scalars are new tensors.  ``park`` is the column past the
    table span where retired slots aim their writes; with ``adapters``
    each slot adds its ``adapter_ids`` row's deltas."""
    lengths, done = state["lengths"], state["done"]
    advance = ~done
    write_cols = torch.where(advance, lengths, park)
    logits = _forward_with_cache(
        model, state["last_token"].long()[:, None],
        (state["cache_k"], state["cache_v"]), lengths,
        write_cols=write_cols, tables=tables,
        adapter_ids=state["adapter_ids"], adapters=adapters)
    last = logits[:, -1]
    keys = state["keys"]
    if decode.temperature <= 0.0:
        nxt = torch.argmax(last, dim=-1)
    else:
        nxt = _sample_slots(decode, last, keys)
        keys = _next_keys(keys)
    nxt = torch.where(advance, nxt.to(torch.int32), 0)
    new_lengths = lengths + advance.to(torch.int32)
    new_done = done | (new_lengths >= state["stop_len"])
    if decode.eos_token >= 0:
        new_done = new_done | (advance & (nxt == decode.eos_token))
    state = dict(state)
    state["lengths"] = new_lengths
    state["last_token"] = nxt
    state["done"] = new_done
    state["keys"] = keys
    return state, nxt


def decode_step(model: Transformer, state: Dict[str, torch.Tensor],
                decode: DecodeConfig, steps: int, tables, *,
                in_place: bool = False,
                adapters: Optional[Adapters] = None):
    """Advance every live slot ``steps`` times; returns (state, sampled
    [steps, S] int32).

    Each step is one batched forward at t=1: each slot ropes at its own
    length, attends under its own causal frontier over its
    table-gathered view of the pool, and writes its new k/v through
    ``tables`` ([S, mb], host-owned).  Retired slots ride along with
    their writes on the scratch block and emit 0.  The pool is updated
    in place; the returned state's scalars are new tensors, or, with
    ``in_place``, the given state's own tensors, overwritten.  The
    ``steps`` are unrolled, as JAX's ``scan`` runs them.  ``adapters``:
    the stacked adapter factors each slot's ``adapter_ids`` indexes.
    """
    tables = _device_tables(tables, state["done"].device)
    park = tables.shape[1] * _pool_block_tokens(state["cache_k"])
    out = state
    toks = []
    for _ in range(steps):
        out, nxt = _advance_slots(model, decode, tables, park, out,
                                  adapters)
        toks.append(nxt)
    if in_place:
        out = _assign(state, out)
    return out, torch.stack(toks)


class _DoneProbe:
    """A lagged, non-blocking read of the all-done flag on CUDA: after
    each step the flag is copied into pinned host memory behind an
    event; the newest copy whose event has completed says whether every
    slot was already done.  The host never waits for the device here.
    On the CPU the flag is read as it is computed."""

    def __init__(self, k: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.flags = torch.zeros((k,), dtype=torch.bool,
                                 pin_memory=self.cuda)
        self.events = []

    def record(self, i: int, all_done: torch.Tensor) -> None:
        self.flags[i].copy_(all_done, non_blocking=True)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        self.events.append(event)

    def all_done(self) -> bool:
        for i in range(len(self.events) - 1, -1, -1):
            if self.events[i] is None or self.events[i].query():
                return bool(self.flags[i])
        return False


def decode_round_step(model: Transformer, decode: DecodeConfig,
                      tables: torch.Tensor, park: int,
                      state: Dict[str, torch.Tensor], toks: torch.Tensor,
                      step: torch.Tensor, steps_run: torch.Tensor,
                      adapters: Optional[Adapters] = None) -> torch.Tensor:
    """One guarded step of ``decode_rounds``, entirely in place: the
    state's scalars, ``toks[:, step]``, ``steps_run`` and the 0-d int64
    device step index ``step`` (then advanced by one).  Returns the
    0-d all-done flag after the step.

    A step run with every slot already done changes no state and writes
    only the scratch block; its last tokens and keys are kept as they
    were, as JAX's loop, which never runs it, leaves them."""
    live = ~state["done"].all()
    new, nxt = _advance_slots(model, decode, tables, park, state, adapters)
    for name in ("last_token", "keys"):
        new[name] = torch.where(live, new[name], state[name])
    _assign(state, new)
    toks.index_copy_(1, step.reshape(1), nxt[:, None])
    steps_run.add_(live.to(torch.int32))
    step.add_(1)
    return state["done"].all()


def run_round(step_fn, k: int, max_steps, device: torch.device) -> None:
    """The host side of a fused round: issue ``step_fn`` (one guarded
    step returning the all-done flag) up to ``min(max_steps, k)`` times,
    and stop once a lagged read of the flag says every slot was done.
    ``max_steps`` is a host int (a 0-d tensor is read once)."""
    probe = _DoneProbe(k, device)
    for i in range(min(int(max_steps), int(k))):
        if probe.all_done():
            break
        probe.record(i, step_fn())


def decode_rounds(model: Transformer, state: Dict[str, torch.Tensor],
                  decode: DecodeConfig, k: int, tables, max_steps, *,
                  adapters: Optional[Adapters] = None):
    """Up to ``min(max_steps, k)`` decode steps in one call; returns
    ``(state, toks [S, k], counts [S], steps_run)`` with JAX's values:

    - ``toks``: slot s's tokens of this round in ``toks[s, :counts[s]]``
      (a live slot advances every step until it freezes);
    - ``counts``: tokens emitted per slot (EOS included);
    - ``steps_run``: 0-d int32, the steps in which some slot was live.

    JAX runs a ``while_loop`` that exits on the device when every slot
    is done.  Here the host issues the steps (``run_round``); a step in
    which every slot is already done changes no state, writes only the
    scratch block and emits 0, so it leaves the outputs as JAX's.  The
    loop stops issuing steps once a lagged non-blocking read of the
    all-done flag says every slot was done.  Each step writes its
    tokens at a device step index (``decode_round_step``), so one
    captured step serves every step of every round.  The step body is
    ``decode_step``'s, so greedy tokens equal k single-step calls.  The
    pool is updated in place; the returned state's scalars are new
    tensors (the engine's in-place round is ``decode_round_step``, see
    serving/programs.py).
    """
    device = state["done"].device
    tables = _device_tables(tables, device)
    park = tables.shape[1] * _pool_block_tokens(state["cache_k"])
    state = {name: value if name in ("cache_k", "cache_v")
             else value.clone() for name, value in state.items()}
    slots = state["done"].shape[0]
    toks = torch.zeros((slots, k), dtype=torch.int32, device=device)
    steps_run = torch.zeros((), dtype=torch.int32, device=device)
    step = torch.zeros((), dtype=torch.int64, device=device)
    len0 = state["lengths"].clone()
    run_round(lambda: decode_round_step(model, decode, tables, park, state,
                                        toks, step, steps_run, adapters),
              k, max_steps, device)
    counts = state["lengths"] - len0
    return state, toks, counts, steps_run


def verify_step(model: Transformer, state: Dict[str, torch.Tensor],
                decode: DecodeConfig, k: int, draft, draft_len, tables, *,
                in_place: bool = False,
                adapters: Optional[Adapters] = None):
    """Speculative verify: score up to ``k`` host-drafted tokens per slot
    in one forward; returns (state, tokens [S, k+1] int32, emit [S]
    int32).

    ``draft`` [S, k] is each slot's candidate continuation and
    ``draft_len`` [S] how many of its tokens are real (0: the slot rides
    along undrafted).  The window ``[last_token, draft]`` goes through
    the paged forward at t = k+1 with per-row rope positions, per-row
    causal frontiers and per-row writes through ``tables``: the
    decode step's math widened to the window, so position j's logits are
    the (j+1)-th decode step's whenever the first j drafts match.

    Acceptance is exact-match greedy: with ``a`` the longest draft prefix
    equal to the argmax targets, a slot emits a+1 tokens (the accepted
    drafts and one free token), clipped to ``stop_len - lengths`` and cut
    at EOS.  Rollback is a length: the k+1 columns were written, but
    ``lengths`` advances over the emitted prefix only, and the next call
    overwrites the rest before it attends to them.  Retired slots park
    their writes past the table span and emit 0 tokens.  The pool is
    updated in place; the slot scalars are new tensors, or, with
    ``in_place``, written into the state's own.  With ``adapters`` each
    slot's window carries its ``adapter_ids`` row's deltas, as its decode
    steps do.
    """
    device = state["done"].device
    tables = _device_tables(tables, device)
    lengths, done = state["lengths"], state["done"]
    park = tables.shape[1] * _pool_block_tokens(state["cache_k"])
    advance = ~done
    write_cols = torch.where(advance, lengths, park)
    draft = torch.as_tensor(draft, device=device).to(torch.int32)
    draft_len = torch.as_tensor(draft_len, device=device).to(torch.int32)
    tokens = torch.cat([state["last_token"][:, None], draft], dim=1)
    logits = _forward_with_cache(
        model, tokens.long(), (state["cache_k"], state["cache_v"]), lengths,
        write_cols=write_cols, tables=tables,
        adapter_ids=state["adapter_ids"], adapters=adapters)
    targets = torch.argmax(logits, dim=-1).to(torch.int32)   # [S, k+1]
    pos = torch.arange(k, device=device)[None, :]
    match = (draft == targets[:, :k]) & (pos < draft_len[:, None])
    accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    emit = torch.minimum(accepted + 1,
                         (state["stop_len"] - lengths).clamp(min=0))
    if decode.eos_token >= 0:
        is_eos = targets == decode.eos_token
        eos_cut = torch.where(is_eos.any(dim=1),
                              torch.argmax(is_eos.to(torch.int32), dim=1) + 1,
                              k + 2)
        done_eos = advance & (eos_cut <= emit)
        emit = torch.minimum(emit, eos_cut)
    else:
        done_eos = torch.zeros_like(done)
    emit = torch.where(advance, emit, 0).to(torch.int32)
    cols = torch.arange(k + 1, device=device)[None, :]
    out = torch.where(cols < emit[:, None], targets, 0)
    new_lengths = lengths + emit
    last = targets.gather(1, (emit - 1).clamp(min=0).long()[:, None])[:, 0]
    new = {
        "lengths": new_lengths,
        "last_token": torch.where(emit > 0, last, state["last_token"]),
        "done": done | done_eos | (advance
                                   & (new_lengths >= state["stop_len"])),
    }
    if in_place:
        return _assign(state, new), out, emit
    return dict(state, **new), out, emit


def prefill_chunk_into_slot(
    model: Transformer,
    state: Dict[str, torch.Tensor],
    decode: DecodeConfig,
    tokens: torch.Tensor,
    start,
    prompt_len,
    new_tokens,
    slot,
    seed,
    table_row,
    adapter_id=None,
    *,
    in_place: bool = False,
    adapters: Optional[Adapters] = None,
):
    """Extend slot ``slot``'s KV by one static-width chunk of prompt at
    cache offset ``start``; returns (state, first sampled token [1]).

    tokens [1, w]: the prompt's tokens [start, start + w), right-padded
    past ``prompt_len`` on the final chunk.  table_row [1, mb]: the
    slot's block table.  Fresh k/v go into the pool through it, and the
    chunk's queries attend over the slot's gathered view under the
    frontier ``start``, so earlier chunks' (or an aliased shared
    prefix's) k/v take part as if the prompt had prefilled in one call.
    Positions past the table's real pages land on the scratch block.

    adapter_id: the request's row of the stacked ``adapters`` (None or 0
    is the base row), applied to this chunk's forward (the prompt's k/v
    carry the tenant's delta too) and written to
    ``state["adapter_ids"][slot]`` on every chunk, so the step programs
    gather the same row; the freeze below parks the slot until its final
    chunk, so an interleaved step reads the new id from a frozen row.

    The scalars (start, prompt_len, new_tokens, slot, seed, adapter_id)
    are JAX's traced operands: 0-d int tensors on the state's device (views of a
    caller's buffer, which a CUDA graph reads at replay), or host ints,
    copied up.  Everything that depends on them is computed on the
    device, so the body is the same program for every call.

    On the final chunk (start + w >= prompt_len, decided on the device)
    the program samples the request's first token from the last real
    prompt position and arms the slot's scalars (lengths, stop_len,
    last_token, done, keys) by selects against ``final_slot``, which is
    out of range on other chunks, as JAX's dropped writes are.  Either
    way ``done[slot]`` is set True first: a slot freed mid-generation
    (deadline expiry) still has ``done`` False on the device, and
    without this freeze an interleaved decode step would advance the
    dead occupant and write through the new request's table.  The pool
    is updated in place; the slot scalars are new tensors, or, with
    ``in_place``, written into the state's own.
    """
    slots_n = state["done"].shape[0]
    device = state["done"].device
    w = tokens.shape[1]
    start, prompt_len, new_tokens, slot, seed, aid = (
        _scalar(v, device) for v in (start, prompt_len, new_tokens, slot,
                                     seed,
                                     0 if adapter_id is None else adapter_id))
    table_row = _device_tables(table_row, device)
    logits = _forward_with_cache(
        model, tokens.to(device).long(),
        (state["cache_k"], state["cache_v"]), start, tables=table_row,
        adapter_ids=aid.reshape(1), adapters=adapters)
    # First-token sampling from the last REAL prompt position of this
    # chunk (only meaningful on the final chunk; clamped otherwise).
    idx = (prompt_len - 1 - start).clamp(0, w - 1)
    last = logits.index_select(1, idx.reshape(1))[:, 0]      # [1, V]
    # The request's (seed, step) counter, built by selects.
    first = torch.arange(2, device=device) == 0
    if decode.temperature <= 0.0:
        tok = torch.argmax(last, dim=-1)
    else:
        tok = _sample_slots(decode, last, torch.where(first, seed, 0)[None])
    tok = tok.to(torch.int32)

    ids = torch.arange(slots_n, device=device)
    sel = ids == slot
    is_last = start + w >= prompt_len
    final = ids == torch.where(is_last, slot, slots_n)  # none mid-prefill
    stop = prompt_len + new_tokens.clamp(min=1) - 1
    done_final = new_tokens <= 1
    if decode.eos_token >= 0:
        done_final = done_final | (tok[0] == decode.eos_token)
    new = {
        "adapter_ids": torch.where(sel, aid.to(torch.int32),
                                   state["adapter_ids"]),
        "done": torch.where(final, done_final,
                            torch.where(sel, True, state["done"])),
        "lengths": torch.where(final, prompt_len.to(torch.int32),
                               state["lengths"]),
        "stop_len": torch.where(final, stop.to(torch.int32),
                                state["stop_len"]),
        "last_token": torch.where(final, tok[0], state["last_token"]),
        "keys": torch.where(final[:, None],
                            torch.where(first, seed, 1)[None],
                            state["keys"]),
    }
    if in_place:
        return _assign(state, new), tok
    return dict(state, **new), tok
