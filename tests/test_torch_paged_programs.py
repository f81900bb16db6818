"""The port's paged slot programs against the JAX package's.

The same numpy weights (``params_from_jax``) and the same block tables go
through both packages' ``init_paged_state``, ``prefill_chunk_into_slot``,
``decode_step`` and ``decode_rounds`` at float32 on the CPU.  The pool's
``[:, :nb]`` and the logits agree within 1e-5; lengths, stop lengths,
last tokens, done flags, sampled tokens, ``counts`` and ``steps_run`` are
equal.  The port's ``keys`` are its own (seed, step) counters, so they
are held to their own contract, not to JAX's threefry keys.  The prefill
and rounds cases run with the scalars as host ints, and again
(``test_tensor_scalars``) as 0-d tensors, JAX's traced operands, with
which every decision (a final chunk or not) is made on the device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models import generate as jgen
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.models.transformer import (
    TransformerConfig as JaxTransformerConfig,
)
from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

VOCAB = 256
SMALL = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, head_dim=8, max_seq_len=64)
TOL = dict(atol=1e-5, rtol=1e-5)
SLOTS, NB, BT, MB, W = 3, 12, 4, 6, 4
SCALARS = ("lengths", "stop_len", "last_token", "done")


@pytest.fixture(scope="module")
def models():
    jcfg = JaxTransformerConfig(dtype=jnp.float32, attention="dot", **SMALL)
    variables = JaxTransformer(jcfg).init(
        jax.random.key(11), np.zeros((1, 8), np.int32))
    tree = jax.tree.map(np.asarray, nn.unbox(variables)["params"])
    model = load_params(
        Transformer(TransformerConfig(dtype=torch.float32, attention="dot",
                                      **SMALL), device="meta"),
        params_from_jax(tree))
    return jcfg, tree, model


class Pair:
    """One JAX state and one port state, stepped side by side.  The
    port's scalars (prefill's start, prompt_len, new_tokens, slot and
    seed; the rounds' max_steps) go in as host ints, or as 0-d int64
    tensors when ``scalars`` is "tensor"."""

    scalars = "int"

    def __init__(self, models, decode=None, **decode_kw):
        self.jcfg, self.tree, self.model = models
        decode_kw.setdefault("max_new_tokens", 12)
        self.jdecode = jgen.DecodeConfig(**decode_kw)
        self.decode = pgen.DecodeConfig(**decode_kw)
        self.js = jgen.init_paged_state(self.jcfg, SLOTS, NB, BT)
        self.ps = pgen.init_paged_state(self.model.cfg, SLOTS, NB, BT,
                                        device="cpu")
        self.tables = np.full((SLOTS, MB), NB, np.int32)

    def prefill(self, slot, prompt, start, new, seed=0):
        chunk = np.zeros((1, W), np.int32)
        seg = np.asarray(prompt[start:start + W], np.int32)
        chunk[0, :seg.shape[0]] = seg
        row = self.tables[slot:slot + 1]
        self.js, jtok = jgen.prefill_chunk_into_slot(
            self.jcfg, self.tree, self.js, self.jdecode, jnp.asarray(chunk),
            np.int32(start), np.int32(len(prompt)), np.int32(new),
            np.int32(slot), np.int32(seed), jnp.asarray(row))
        args = self._scalars(start, len(prompt), new, slot, seed)
        with torch.inference_mode():
            self.ps, ptok = pgen.prefill_chunk_into_slot(
                self.model, self.ps, self.decode, torch.from_numpy(chunk),
                *args, torch.from_numpy(row))
        return np.asarray(jtok), ptok.numpy()

    def step(self, steps):
        self.js, jt = jgen.decode_step(
            self.jcfg, self.tree, self.js, self.jdecode, steps,
            jnp.asarray(self.tables))
        with torch.inference_mode():
            self.ps, pt = pgen.decode_step(
                self.model, self.ps, self.decode, steps,
                torch.from_numpy(self.tables))
        return np.asarray(jt), pt.numpy()

    def rounds(self, k, max_steps):
        self.js, jt, jc, jn = jgen.decode_rounds(
            self.jcfg, self.tree, self.js, self.jdecode, k,
            jnp.asarray(self.tables), np.int32(max_steps))
        with torch.inference_mode():
            self.ps, pt, pc, pn = pgen.decode_rounds(
                self.model, self.ps, self.decode, k,
                torch.from_numpy(self.tables), *self._scalars(max_steps))
        return ((np.asarray(jt), np.asarray(jc), int(jn)),
                (pt.numpy(), pc.numpy(), int(pn)))

    def _scalars(self, *values):
        if self.scalars == "int":
            return values
        return [torch.tensor(v, dtype=torch.int64) for v in values]

    def check(self, scalars=True):
        for name in ("cache_k", "cache_v"):
            np.testing.assert_allclose(
                self.ps[name].numpy(), np.asarray(self.js[name]),
                err_msg=name, **TOL)
        for name in SCALARS if scalars else ():
            np.testing.assert_array_equal(
                self.ps[name].numpy(), np.asarray(self.js[name]),
                err_msg=name)

    def logits(self, tokens, lengths):
        """Both packages' paged forward on copies of the pools."""
        tokens = np.asarray(tokens, np.int32)
        lengths = np.asarray(lengths, np.int32)
        jl, _ = jgen._forward_with_cache(
            self.jcfg, self.tree, jnp.asarray(tokens),
            (self.js["cache_k"], self.js["cache_v"]), jnp.asarray(lengths),
            tables=jnp.asarray(self.tables))
        scratch = pgen.init_paged_state(self.model.cfg, SLOTS, NB, BT,
                                        device="cpu")
        for name in ("cache_k", "cache_v"):
            scratch[name].copy_(self.ps[name])
        with torch.inference_mode():
            pl = pgen._forward_with_cache(
                self.model, torch.from_numpy(tokens).long(),
                (scratch["cache_k"], scratch["cache_v"]),
                torch.from_numpy(lengths), tables=torch.from_numpy(
                    self.tables))
        return np.asarray(jl), pl.numpy()


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, n).tolist()


def _cover(pair, slot, blocks):
    pair.tables[slot, :len(blocks)] = blocks


def test_init_paged_state_matches_jax_layout(models):
    pair = Pair(models)
    assert set(pair.ps) == set(pair.js)
    for name, want in pair.js.items():
        got = pair.ps[name]
        assert tuple(got.shape) == tuple(want.shape), name
        if name != "keys":
            assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    assert pair.ps["keys"].dtype == torch.int64
    pair.check()
    # The pool's scratch block lies past the state's view.
    full = pgen._pool_with_scratch(pair.ps["cache_k"])
    assert full.shape[1] == NB + 1
    assert full.data_ptr() == pair.ps["cache_k"].data_ptr()
    # An int8 state's pool sides are QTensors laid out as JAX's.
    js = jgen.init_paged_state(pair.jcfg, SLOTS, NB, BT, "int8")
    ps = pgen.init_paged_state(models[2].cfg, SLOTS, NB, BT, "int8",
                               device="cpu")
    for name in ("cache_k", "cache_v"):
        for part in ("values", "scale"):
            got, want = getattr(ps[name], part), getattr(js[name], part)
            assert tuple(got.shape) == tuple(want.shape), (name, part)
            assert str(got.dtype).split(".")[-1] == str(want.dtype)


def test_prefill_chunks_resume_and_aliased_prefix(models):
    """Slot 0 prefills 13 tokens in four chunks; slot 2 shares its first
    two blocks (an aliased 8-token prefix) and resumes at offset 8."""
    pair = Pair(models)
    prompt = _prompt(13, 1)
    _cover(pair, 0, [3, 7, 1, 9])
    for start in range(0, 13, W):
        jtok, ptok = pair.prefill(0, prompt, start, new=5)
        pair.check()
    np.testing.assert_array_equal(ptok, jtok)
    assert pair.ps["lengths"][0] == 13 and not pair.ps["done"][0]
    assert pair.ps["keys"][0].tolist() == [0, 1]
    shared = prompt[:8] + _prompt(6, 2)
    _cover(pair, 2, [3, 7, 4, 10])
    for start in (8, 12):
        jtok, ptok = pair.prefill(2, shared, start, new=3, seed=9)
        pair.check()
    np.testing.assert_array_equal(ptok, jtok)
    assert pair.ps["keys"][2].tolist() == [9, 1]
    jl, pl = pair.logits([[5], [0], [6]], [13, 0, 14])
    np.testing.assert_allclose(pl[[0, 2]], jl[[0, 2]], **TOL)


def test_sentinel_and_overhang_writes_leave_the_pool(models):
    """A final chunk whose window runs past the covered blocks (sentinel
    table entries) and past the table's span writes nothing into the
    pool's real blocks."""
    pair = Pair(models)
    prompt = _prompt(22, 3)
    _cover(pair, 1, [0, 5, 2, 8, 6])       # 20 positions covered
    for start in range(0, 20, W):
        pair.prefill(1, prompt, start, new=2)
    before = pair.ps["cache_k"].clone()
    pair.tables[1, 5] = NB                 # block 5 left at the sentinel
    jtok, ptok = pair.prefill(1, prompt, 20, new=2)
    pair.check()
    np.testing.assert_array_equal(ptok, jtok)
    assert torch.equal(pair.ps["cache_k"], before)
    # A chunk window wholly past the table's span (mb * bt = 24
    # positions) of an uncovered slot: its reads see no real page, so
    # only the pool is compared.
    before = pair.ps["cache_v"].clone()
    pair.prefill(0, _prompt(26, 4), 24, new=1)
    pair.check(scalars=False)
    assert torch.equal(pair.ps["cache_v"], before)


@pytest.mark.parametrize("steps", [1, 3])
def test_decode_step(models, steps):
    pair = Pair(models)
    for slot, (n, blocks) in enumerate(((6, [0, 1, 2, 3]),
                                        (9, [4, 5, 6, 7]))):
        _cover(pair, slot, blocks)
        prompt = _prompt(n, 10 + slot)
        for start in range(0, n, W):
            pair.prefill(slot, prompt, start, new=8)
    for _ in range(2):
        jt, pt = pair.step(steps)
        np.testing.assert_array_equal(pt, jt)
        pair.check()
    jl, pl = pair.logits([[3], [4], [0]], [6 + 2 * steps, 9 + 2 * steps, 0])
    np.testing.assert_allclose(pl[:2], jl[:2], **TOL)


def _two_slots(pair, news=(12, 12)):
    """Prefill slots 0 and 1; returns their first tokens."""
    firsts = []
    for slot, (n, blocks) in enumerate(((5, [0, 1, 2, 3, 8]),
                                        (7, [4, 5, 6, 7, 9]))):
        _cover(pair, slot, blocks)
        prompt = _prompt(n, 20 + slot)
        for start in range(0, n, W):
            _, tok = pair.prefill(slot, prompt, start, new=news[slot])
        firsts.append(int(tok[0]))
    return firsts


def test_decode_rounds_k8_and_max_steps_below_k(models):
    pair = Pair(models)
    _two_slots(pair, news=(12, 5))
    for k, max_steps in ((8, 8), (8, 3), (8, 8)):
        (jt, jc, jn), (pt, pc, pn) = pair.rounds(k, max_steps)
        np.testing.assert_array_equal(pt, jt)
        np.testing.assert_array_equal(pc, jc)
        assert pn == jn
        pair.check()
    # Slot 1's budget ran out in the first round; the last round ended
    # early once every slot was done.
    assert pn < 8


def test_decode_rounds_eos_inside_round(models):
    probe = Pair(models)
    firsts = _two_slots(probe)
    jt, _ = probe.step(6)
    # EOS: a token that a slot emits at step j >= 1 of the round and not
    # before (nor as its first token), and the other slot not before j.
    slot, j = next(
        (s, j) for j in range(1, 6) for s in (0, 1)
        if jt[j, s] not in jt[:j].ravel().tolist() + firsts)
    eos = int(jt[j, slot])
    pair = Pair(models, eos_token=eos)
    _two_slots(pair)
    (jt, jc, jn), (pt, pc, pn) = pair.rounds(8, 8)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pc, jc)
    assert pn == jn
    pair.check()
    assert pc[slot] == j + 1 and pt[slot, j] == eos
    assert not pt[slot, j + 1:].any()


@pytest.mark.parametrize("case", [
    test_prefill_chunks_resume_and_aliased_prefix,
    test_sentinel_and_overhang_writes_leave_the_pool,
    test_decode_rounds_k8_and_max_steps_below_k,
    test_decode_rounds_eos_inside_round,
], ids=lambda case: case.__name__[len("test_"):])
def test_tensor_scalars(models, case, monkeypatch):
    """The prefill and rounds cases above with 0-d tensor scalars."""
    monkeypatch.setattr(Pair, "scalars", "tensor")
    case(models)


def test_sampled_slots_repeat_alone_or_co_batched(models):
    """Temperature sampling: the same seed gives the same stream run to
    run, and a slot's stream does not depend on its neighbours."""
    def run(co_batched):
        pair = Pair(models, temperature=1.0, top_k=20)
        prompt = _prompt(6, 30)
        _cover(pair, 1, [0, 1, 2, 3])
        for start in range(0, 6, W):
            _, first = pair.prefill(1, prompt, start, new=10, seed=77)
        if co_batched:
            _cover(pair, 0, [4, 5, 6, 7])
            other = _prompt(5, 31)
            for start in range(0, 5, W):
                pair.prefill(0, other, start, new=10, seed=5)
        with torch.inference_mode():
            pair.ps, toks, counts, _ = pgen.decode_rounds(
                pair.model, pair.ps, pair.decode, 8,
                torch.from_numpy(pair.tables), 8)
        return first.tolist() + toks[1, :int(counts[1])].tolist()

    alone = run(False)
    assert alone == run(False)
    assert alone == run(True)
    assert len(set(alone)) > 1


def test_adapters_are_not_ported(models):
    """Adapters are ported: ``_layer_step`` with a row's factors adds its
    low-rank deltas, and with the all-zero base row it gives exactly what
    it gives without adapters (the base programs keep their math)."""
    from kubeflow_tpu_torch.serving.adapters import (
        init_adapter_stack,
        random_adapter_factors,
    )

    _, _, model = models
    cfg = model.cfg
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (2, 3, SMALL["d_model"])).astype(np.float32))
    positions = torch.arange(3)[None].expand(2, 3)
    stack = init_adapter_stack(cfg, 2, 4)
    factors = random_adapter_factors(cfg, 4, 5, scale=0.5)
    for grp, leaves in factors.items():
        for k, arr in leaves.items():
            stack[grp][k][1] = arr
    layer0 = {grp: {k: torch.from_numpy(arr[[0, 1], 0])
                    for k, arr in leaves.items()}
              for grp, leaves in stack.items()}

    def run(adapters):
        cache = pgen.init_cache(cfg, 2, 4, device="cpu")
        with torch.no_grad():
            return pgen._layer_step(cfg, model.layers[0], x,
                                    (cache[0][0], cache[1][0]), 0,
                                    positions, adapters=adapters)

    base, adapted = run(None), run(layer0)
    assert torch.equal(adapted[0], base[0])
    assert not torch.allclose(adapted[1], base[1], atol=1e-3)


def test_per_row_contiguous_columns(models):
    """The per-row path over a contiguous cache (no tables): each row
    writes at its own column, and a column past the cache is dropped."""
    jcfg, tree, model = models
    rng = np.random.default_rng(40)
    tokens = rng.integers(1, VOCAB, (3, 2)).astype(np.int32)
    lengths = np.asarray([2, 5, 7], np.int32)
    write = np.asarray([2, 5, 7], np.int32)    # row 2 overhangs max_len 8
    jcache = jgen.init_cache(jcfg, 3, 8)
    pcache = pgen.init_cache(model.cfg, 3, 8, device="cpu")
    jl, (jk, jv) = jgen._forward_with_cache(
        jcfg, tree, jnp.asarray(tokens), jcache, jnp.asarray(lengths),
        write_cols=jnp.asarray(write))
    with torch.inference_mode():
        pl = pgen._forward_with_cache(
            model, torch.from_numpy(tokens).long(), pcache,
            torch.from_numpy(lengths), write_cols=torch.from_numpy(write))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pcache[0].numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(pcache[1].numpy(), np.asarray(jv), **TOL)
