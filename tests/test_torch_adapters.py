"""The port's adapter-array serving against the JAX package's.

The twins of tests/test_adapters.py's registry and engine classes at its
toy size (vocab 96, d_model 32, 2 layers, 4 heads, 2 kv heads, float32,
rank 4), fed the same seeded numpy weights and factors, minus the
tensor-mesh cases (ROADMAP queue 1 item 6):

  - REGISTRY: ``kubeflow_tpu_torch.serving.adapters`` gives JAX's factor
    arrays and digests, reads JAX's artifacts and writes ones JAX reads,
    and keeps JAX's slot, pin, LRU and breaker behaviour;
  - DEVICE: ``_forward_with_cache`` with mixed per-row adapter ids gives
    JAX's logits within 1e-4, and one adapter's logits and tokens equal
    a model whose weights have that adapter's ``a @ b`` merged in;
  - ENGINE: mixed base/adapter traffic through one port engine gives
    each request JAX's engine tokens and its own sequential run, through
    plain decode, the adapter-scoped prefix cache, speculation, int8
    weights, hot load/evict and a load fault, while the engine runs the
    programs a base-only engine runs.

Every wait has its own timeout and every engine is closed in
``finally``."""

import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

import kubeflow_tpu.serving.engine as jax_engine_mod
import kubeflow_tpu_torch.serving.engine as engine_mod
from kubeflow_tpu.models import generate as jgen
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.ops import quantize as jq
from kubeflow_tpu.serving import adapters as jad
from kubeflow_tpu.serving import model_server as jms
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.ops import quantize as pq
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.serving import adapters as pad
from kubeflow_tpu_torch.serving import model_server as pms
from kubeflow_tpu_torch.serving.engine import DecodeEngine
from kubeflow_tpu_torch.serving.errors import Overloaded
from kubeflow_tpu_torch.testing import faults

SEED = 20260807
VOCAB, NEW_TOKENS = 96, 10
RANK = 4
OVERRIDES = {"vocab_size": VOCAB, "d_model": 32, "n_layers": 2,
             "n_heads": 4, "n_kv_heads": 2, "d_ff": 64, "head_dim": 8,
             "max_seq_len": 64}
# tests/test_adapters.py's engine geometry.
GEOMETRY = dict(slots=3, prefill_len=16, prefill_chunk_tokens=4,
                kv_block_tokens=4)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
WAIT_S = 60


@pytest.fixture(scope="module")
def lm():
    """One seeded weight tree in both packages (float32), its int8-weight
    twins, and both packages' configs."""
    jcfg = jax_model_config(dict(OVERRIDES, dtype="float32"))
    variables = JaxTransformer(jcfg).init(
        jax.random.key(SEED), np.zeros((1, 8), np.int32))
    tree = jax.tree.map(np.asarray, nn.unbox(variables)["params"])
    cfg = TransformerConfig(dtype=torch.float32, **OVERRIDES)

    def port(params):
        return load_params(Transformer(cfg, device="meta"), params)

    return SimpleNamespace(
        jcfg=jcfg, cfg=cfg, tree=tree, params=jax.device_put(tree),
        jtree_q=jq.quantize_params(tree),
        model=port(params_from_jax(tree)),
        model_q=port(pq.quantize_params(params_from_jax(tree))),
        port=port,
        jdecode=jgen.DecodeConfig(max_new_tokens=NEW_TOKENS),
        decode=pgen.DecodeConfig(max_new_tokens=NEW_TOKENS))


def _factors(cfg, seed):
    # tests/test_adapters.py's scale: large enough that the delta flips
    # greedy argmax on the toy model, so no identity check is vacuous.
    return pad.random_adapter_factors(cfg, RANK, seed, scale=0.5)


def _registry(cfg, names=("alpha", "beta"), module=pad, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("rank", RANK)
    reg = module.AdapterRegistry(cfg, **kw)
    for i, name in enumerate(names):
        reg.put(name, module.random_adapter_factors(
            cfg, RANK, SEED + 100 + i, scale=0.5))
    return reg


def _engine(lm, **kw):
    kw.setdefault("name", "ad-port")
    for key, value in GEOMETRY.items():
        kw.setdefault(key, value)
    return DecodeEngine(kw.pop("model", lm.model), kw.pop("decode", lm.decode),
                        **kw)


def _jax_engine(lm, **kw):
    kw.setdefault("name", "ad-jax")
    for key, value in GEOMETRY.items():
        kw.setdefault(key, value)
    params = kw.pop("params", lm.params)
    return jax_engine_mod.DecodeEngine(lm.jcfg, dict(params),
                                       kw.pop("decode", lm.jdecode), **kw)


def _prompts(n=4, seed_off=0):
    rng = np.random.RandomState(SEED + seed_off)
    return [rng.randint(1, VOCAB, size=(k,)).astype(np.int32)
            for k in (8, 5, 11, 16, 3, 9)[:n]]


def _mixed_workload(n_each=2):
    prompts = _prompts(6, seed_off=3)
    return [(adapter, prompts[i % len(prompts)], 3 + (i % 3) * 3)
            for i, adapter in enumerate((None, "alpha", "beta") * n_each)]


def _request(adapter, prompt, new):
    req = {"tokens": prompt, "max_new_tokens": new}
    if adapter:
        req["adapter"] = adapter
    return req


def _submit(engine, req):
    """engine.submit() from a thread joined with a timeout: the token
    row, or the exception the submit raised, re-raised here."""
    box = {}

    def call():
        try:
            box["out"] = np.asarray(engine.submit(req)["tokens"])[0].tolist()
        except Exception as exc:  # noqa: BLE001 -- re-raised below
            box["err"] = exc

    thread = threading.Thread(target=call)
    thread.start()
    thread.join(timeout=WAIT_S)
    assert not thread.is_alive(), "submit hung"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _sequential(engine, workload):
    """One request in flight at a time; the engine is closed after."""
    try:
        return [_submit(engine, _request(*w)) for w in workload]
    finally:
        engine.close()


def _run_concurrent(engine, workload):
    outs = [None] * len(workload)

    def client(i):
        try:
            outs[i] = np.asarray(engine.submit(
                _request(*workload[i]))["tokens"])[0].tolist()
        except Exception as exc:  # noqa: BLE001 -- surfaced by assert
            outs[i] = exc

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(workload))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a client hung"
    return outs


def _generate(lm, prompt, model=None):
    out, _ = pgen.generate(model or lm.model,
                           torch.from_numpy(np.asarray(prompt)[None]),
                           lm.decode)
    return out[0].tolist()


# ---------------------------------------------------------------------------
# host side: the registry, artifacts and the breaker


class TestAdapterRegistry:
    @pytest.mark.parametrize("name", ["lm", "lm@t1", "lm@", "a@b@c", "@x"])
    def test_split_model_adapter(self, name):
        assert pad.split_model_adapter(name) == jad.split_model_adapter(name)

    def test_stack_shapes_base_row_zero(self, lm):
        stack = pad.init_adapter_stack(lm.cfg, rows=3, rank=RANK)
        jstack = jad.init_adapter_stack(lm.jcfg, rows=3, rank=RANK)
        assert {g: {k: a.shape for k, a in leaves.items()}
                for g, leaves in stack.items()} == \
            {g: {k: a.shape for k, a in leaves.items()}
             for g, leaves in jstack.items()}
        assert stack["attn"]["wq_a"].shape == (3, 2, 32, RANK)
        assert stack["attn"]["wq_a"].dtype == np.float32
        reg = _registry(lm.cfg, names=("alpha",))
        stack, version = reg.stack_snapshot()
        assert version >= 1
        for leaves in stack.values():
            for arr in leaves.values():
                assert not np.any(arr[0])      # base row stays zero
        assert any(np.any(arr[1]) for leaves in stack.values()
                   for arr in leaves.values())

    def test_factors_and_digest_match_jax(self, lm):
        ours = _factors(lm.cfg, SEED + 1)
        theirs = jad.random_adapter_factors(lm.jcfg, RANK, SEED + 1,
                                            scale=0.5)
        for grp, leaves in theirs.items():
            for k, arr in leaves.items():
                np.testing.assert_array_equal(ours[grp][k], arr)
        assert pad.factors_digest(ours) == jad.factors_digest(theirs)

    def test_save_load_roundtrip_digest_verified(self, lm, tmp_path):
        import json

        factors = _factors(lm.cfg, SEED + 1)
        path = str(tmp_path / "t1.npz")
        digest = pad.save_adapter(path, factors)
        assert digest == pad.factors_digest(factors)
        loaded, got = pad.load_adapter(path, lm.cfg, RANK)
        assert got == digest
        np.testing.assert_array_equal(loaded["attn"]["wq_a"],
                                      factors["attn"]["wq_a"])
        (tmp_path / "t1.npz.json").write_text(
            json.dumps({"digest": "0" * 64}))
        with pytest.raises(ValueError, match="digest mismatch"):
            pad.load_adapter(path, lm.cfg, RANK)
        bad = str(tmp_path / "t2.npz")
        with open(bad, "wb") as f:
            np.savez(f, **{"attn/wq_a": np.zeros((1, 2), np.float32)})
        with pytest.raises(ValueError, match="missing/misshaped"):
            pad.load_adapter(bad, lm.cfg, RANK)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_artifacts_cross_both_ways(self, lm, tmp_path, writer):
        """An artifact either package writes, the other reads, with the
        same digest and the same leaves."""
        factors = _factors(lm.cfg, SEED + 5)
        path = str(tmp_path / "x.npz")
        save, load, cfg = ((jad.save_adapter, pad.load_adapter, lm.cfg)
                           if writer == "jax" else
                           (pad.save_adapter, jad.load_adapter, lm.jcfg))
        digest = save(path, factors)
        loaded, got = load(path, cfg, RANK)
        assert got == digest == pad.factors_digest(factors)
        for grp, leaves in factors.items():
            for k, arr in leaves.items():
                np.testing.assert_array_equal(loaded[grp][k], arr)

    def test_acquire_pins_release_unpins(self, lm, tmp_path):
        pad.save_adapter(str(tmp_path / "a.npz"), _factors(lm.cfg, SEED + 2))
        reg = pad.AdapterRegistry(lm.cfg, slots=2, rank=RANK,
                                  directory=str(tmp_path), name="pins")
        idx, digest = reg.acquire("a")
        assert idx == 1 and len(digest) == 64
        assert reg.salt(idx) == bytes.fromhex(digest)
        assert reg.salt(0) == b""
        assert reg.loaded()[0]["pins"] == 1
        idx2, _ = reg.acquire("a")
        assert idx2 == idx
        assert reg.loaded()[0]["pins"] == 2
        reg.release(idx)
        reg.release(idx)
        assert reg.loaded()[0]["pins"] == 0
        assert reg.stats()["adapters_resident"] == 1
        with pytest.raises(pad.AdapterNotFound):
            reg.acquire("ghost")
        with pytest.raises(pad.AdapterNotFound):
            reg.acquire("../a")

    def test_lru_evicts_idle_only_all_pinned_sheds(self, lm, tmp_path):
        for i, name in enumerate(("a", "b", "c", "d")):
            pad.save_adapter(str(tmp_path / f"{name}.npz"),
                             _factors(lm.cfg, SEED + 10 + i))
        reg = pad.AdapterRegistry(lm.cfg, slots=2, rank=RANK,
                                  directory=str(tmp_path), name="lru")
        evictions = REGISTRY.counter(pad.ADAPTER_EVICTIONS_TOTAL)
        before = evictions.value(engine="lru")
        ia, _ = reg.acquire("a")            # pinned (in-flight)
        ib, _ = reg.acquire("b")
        reg.release(ib)                     # b idle: the LRU victim
        ic, _ = reg.acquire("c")
        assert {r["name"] for r in reg.loaded()} == {"a", "c"}
        assert evictions.value(engine="lru") == before + 1
        with pytest.raises(Overloaded) as exc:
            reg.acquire("d")                # a and c both pinned
        assert exc.value.retry_after_s > 0
        reg.release(ia)
        reg.release(ic)
        idd, _ = reg.acquire("d")
        assert idd in (ia, ic)
        assert REGISTRY.gauge(pad.ADAPTER_RESIDENT_GAUGE).value(
            engine="lru") == 2

    def test_corrupt_artifact_breaker_last_good_serves(self, lm, tmp_path):
        pad.save_adapter(str(tmp_path / "a.npz"), _factors(lm.cfg, SEED + 20))
        reg = pad.AdapterRegistry(lm.cfg, slots=2, rank=RANK,
                                  directory=str(tmp_path), name="breaker")
        with faults.injected("seed=0") as inj:
            idx, digest = reg.acquire("a")
            reg.release(idx)
            assert inj.fired("adapter.load") == 1
            (tmp_path / "a.npz").write_bytes(b"not an npz")
            (tmp_path / "a.npz.json").unlink()
            idx2, digest2 = reg.acquire("a")
            assert (idx2, digest2) == (idx, digest)
            reg.release(idx2)
            assert inj.fired("adapter.load") == 2
            idx3, _ = reg.acquire("a")      # breaker open: no load
            reg.release(idx3)
            assert inj.fired("adapter.load") == 2
            (tmp_path / "b.npz").write_bytes(b"garbage")
            with pytest.raises(Overloaded):
                reg.acquire("b")
            fired = inj.fired("adapter.load")
            with pytest.raises(Overloaded):
                reg.acquire("b")
            assert inj.fired("adapter.load") == fired
            pad.save_adapter(str(tmp_path / "b.npz"),
                             _factors(lm.cfg, SEED + 21))
            inj.advance_clock(600)
            ib, _ = reg.acquire("b")
            reg.release(ib)
            assert {r["name"] for r in reg.loaded()} >= {"b"}

    def test_put_reloads_in_place(self, lm):
        reg = _registry(lm.cfg, names=("alpha",))
        idx = reg.put("alpha", _factors(lm.cfg, SEED + 30))
        assert idx == 1
        _, version = reg.stack_snapshot()
        assert reg.put("alpha", _factors(lm.cfg, SEED + 31)) == idx
        assert reg.stack_snapshot()[1] > version

    def test_reload_breaker_walk_matches_jax(self):
        """The copied ``_ReloadBreaker`` walks open -> half-open -> closed
        as JAX's does under the same jitter and the same clock skips."""
        import random

        walks = []
        for module in (pms, jms):
            breaker = module._ReloadBreaker(0.5, 60.0,
                                            rng=random.Random(7))
            walk = []
            with faults.injected("seed=0") as inj:
                from kubeflow_tpu.testing import faults as jfaults

                with jfaults.injected("seed=0") as jinj:
                    for step in range(6):
                        walk.append(breaker.allow(3))
                        if step % 2 == 0:
                            breaker.record_failure(3)
                        inj.advance_clock(0.8)
                        jinj.advance_clock(0.8)
                    walk += [breaker.allow(4), breaker.open]
            walks.append(walk)
        assert walks[0] == walks[1]
        assert True in walks[0] and False in walks[0]


# ---------------------------------------------------------------------------
# device side: the per-row delta against JAX and against merged weights


def _jax_stack(reg):
    stack, _ = reg.stack_snapshot()
    return {grp: dict(leaves) for grp, leaves in stack.items()}


def _port_stack(reg, dtype=torch.float32):
    stack, _ = reg.stack_snapshot()
    return {grp: {k: torch.from_numpy(np.array(a)).to(dtype)
                  for k, a in leaves.items()}
            for grp, leaves in stack.items()}


def test_forward_with_cache_mixed_adapters_matches_jax(lm):
    """A 3-row batch with adapter ids (base, alpha, beta): the prompt's
    forward at cache length 0, then one decode step; logits within
    1e-4 of JAX's at each, and the rows differ from base."""
    reg = _registry(lm.cfg)
    jparams = dict(lm.params, adapters=_jax_stack(reg))
    stack = _port_stack(reg)
    ids = np.array([0, 1, 2], np.int32)
    tokens = np.random.RandomState(SEED).randint(
        1, VOCAB, size=(3, 6)).astype(np.int32)
    jcache = jgen.init_cache(lm.jcfg, 3, 12)
    pcache = pgen.init_cache(lm.cfg, 3, 12, device="cpu")
    jlog, jcache = jgen._forward_with_cache(
        lm.jcfg, jparams, tokens, jcache, 0, adapter_ids=ids)
    plog = _forward(
        lm.model, torch.from_numpy(tokens).long(), pcache, 0,
        adapter_ids=torch.from_numpy(ids), adapters=stack)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **LOGITS_TOL)
    nxt = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)[:, None]
    jlog2, _ = jgen._forward_with_cache(
        lm.jcfg, jparams, nxt, jcache, 6, adapter_ids=ids)
    plog2 = _forward(
        lm.model, torch.from_numpy(nxt).long(), pcache, 6,
        adapter_ids=torch.from_numpy(ids), adapters=stack)
    np.testing.assert_allclose(plog2.numpy(), np.asarray(jlog2),
                               **LOGITS_TOL)
    base = _forward(
        lm.model, torch.from_numpy(tokens).long(),
        pgen.init_cache(lm.cfg, 3, 12, device="cpu"), 0)
    assert torch.equal(base[0], plog[0])        # row 0 is the base row
    assert not torch.allclose(base[1:], plog[1:], atol=1e-2)


def _forward(*args, **kw):
    with torch.no_grad():
        return pgen._forward_with_cache(*args, **kw)


def test_paged_programs_with_adapters_match_jax(lm):
    """The engine's slot programs over a paged pool with three slots of
    mixed adapter rows (alpha, base, beta): chunked prefill, decode
    steps and a verify window give JAX's integer state and tokens, and
    pools within 1e-5."""
    reg = _registry(lm.cfg)
    jparams = dict(lm.params, adapters=_jax_stack(reg))
    stack = _port_stack(reg)
    slots, nb, bt, mb, w = 3, 24, 4, 8, 4
    tables = np.full((slots, mb), nb, np.int32)
    jstate = jgen.init_paged_state(lm.jcfg, slots, nb, bt)
    pstate = pgen.init_paged_state(lm.cfg, slots, nb, bt, device="cpu")
    prompts = _prompts(3, seed_off=23)
    for slot, (prompt, row) in enumerate(zip(prompts, (1, 0, 2))):
        tables[slot, :6] = np.arange(slot * 6, slot * 6 + 6)
        n = len(prompt)
        for start in range(0, n, w):
            seg = np.zeros((1, w), np.int32)
            seg[0, :len(prompt[start:start + w])] = prompt[start:start + w]
            jstate, jtok = jgen.prefill_chunk_into_slot(
                lm.jcfg, jparams, jstate, lm.jdecode, seg, np.int32(start),
                np.int32(n), np.int32(NEW_TOKENS), np.int32(slot),
                np.int32(0), tables[slot:slot + 1], np.int32(row))
            with torch.no_grad():
                pstate, ptok = pgen.prefill_chunk_into_slot(
                    lm.model, pstate, lm.decode, torch.from_numpy(seg),
                    start, n, NEW_TOKENS, slot, 0,
                    torch.from_numpy(tables[slot:slot + 1]), row,
                    adapters=stack)
        assert ptok.tolist() == np.asarray(jtok).tolist()

    def same(label):
        for name in ("lengths", "stop_len", "last_token", "done",
                     "adapter_ids"):
            np.testing.assert_array_equal(
                pstate[name].numpy(), np.asarray(jstate[name]),
                err_msg=f"{label}: {name}")
        for name in ("cache_k", "cache_v"):
            np.testing.assert_allclose(
                pstate[name].numpy(), np.asarray(jstate[name]),
                atol=1e-5, rtol=1e-5, err_msg=f"{label}: {name}")

    same("prefill")
    assert pstate["adapter_ids"].tolist() == [1, 0, 2]
    jstate, jtoks = jgen.decode_step(lm.jcfg, jparams, jstate, lm.jdecode,
                                     3, tables)
    with torch.no_grad():
        pstate, ptoks = pgen.decode_step(lm.model, pstate, lm.decode, 3,
                                         torch.from_numpy(tables),
                                         adapters=stack)
    assert ptoks.tolist() == np.asarray(jtoks).tolist()
    same("decode_step")
    draft = np.random.RandomState(SEED).randint(
        1, VOCAB, size=(slots, 3)).astype(np.int32)
    draft[0] = np.asarray(ptoks)[:, 0]      # slot 0 re-drafts its own
    draft_len = np.array([3, 2, 0], np.int32)
    jstate, jout, jemit = jgen.verify_step(lm.jcfg, jparams, jstate,
                                           lm.jdecode, 3, draft, draft_len,
                                           tables)
    with torch.no_grad():
        pstate, pout, pemit = pgen.verify_step(
            lm.model, pstate, lm.decode, 3, draft, draft_len,
            torch.from_numpy(tables), adapters=stack)
    assert pout.tolist() == np.asarray(jout).tolist()
    assert pemit.tolist() == np.asarray(jemit).tolist()
    same("verify_step")


def _merged(lm, factors):
    """The weight tree with one adapter's ``a @ b`` added to each
    projection: the independent reference for the factored delta."""
    tree = jax.tree.map(np.array, lm.tree)
    attn, mlp = tree["layers"]["attn"], tree["layers"]["mlp"]
    fa, fm = factors["attn"], factors["mlp"]
    attn["wq"] += np.einsum("ler,lrhd->lehd", fa["wq_a"], fa["wq_b"])
    attn["wkv"] += np.einsum("lker,lkrhd->lkehd", fa["wkv_a"], fa["wkv_b"])
    attn["wo"] += np.einsum("lhdr,lre->lhde", fa["wo_a"], fa["wo_b"])
    mlp["wi"] += np.einsum("lker,lkrf->lkef", fm["wi_a"], fm["wi_b"])
    mlp["wo"] += np.einsum("lfr,lre->lfe", fm["wo_a"], fm["wo_b"])
    return lm.port(params_from_jax(tree))


def test_adapter_equals_merged_weights(lm):
    """Independent of JAX: alpha's engine tokens equal generate() on a
    model whose weights have alpha's ``a @ b`` merged in, and the
    factored forward's logits are within 1e-4 of the merged model's."""
    factors = _factors(lm.cfg, SEED + 100)
    merged = _merged(lm, factors)
    reg = _registry(lm.cfg, names=("alpha",))
    tokens = torch.from_numpy(_prompts(2, seed_off=7)[0][None]).long()
    got = _forward(
        lm.model, tokens, pgen.init_cache(lm.cfg, 1, 12, device="cpu"), 0,
        adapter_ids=torch.tensor([1]), adapters=_port_stack(reg))
    want = _forward(
        merged, tokens, pgen.init_cache(lm.cfg, 1, 12, device="cpu"), 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS_TOL)
    prompts = _prompts(3, seed_off=7)
    outs = _sequential(_engine(lm, adapters=reg, name="ad-merged"),
                       [("alpha", p, NEW_TOKENS) for p in prompts])
    for prompt, out in zip(prompts, outs):
        assert out == _generate(lm, prompt, merged)
        assert out != _generate(lm, prompt)


# ---------------------------------------------------------------------------
# the engine: co-batched identity, one set of programs


class TestAdapterEngineIdentity:
    def test_mixed_batch_matches_sequential_no_new_programs(self, lm):
        """Base + alpha + beta co-batched through 3 slots: each request's
        tokens equal its run alone on the port's engine and on JAX's, base
        rows equal generate(), variants differ from base, and the engine
        runs the programs a base-only engine runs."""
        workload = _mixed_workload()
        want = _sequential(_jax_engine(
            lm, adapters=_registry(lm.jcfg, module=jad), name="ad-jax-seq"),
            workload)
        alone = _sequential(_engine(lm, adapters=_registry(lm.cfg),
                                    name="ad-seq"), workload)
        base_only = _engine(lm, name="ad-base-only")
        _sequential(base_only, [w for w in workload if w[0] is None])
        eng = _engine(lm, adapters=_registry(lm.cfg), name="ad-mixed")
        try:
            outs = _run_concurrent(eng, workload)
            stats = eng.stats()
            programs = eng.compiled_programs()
            progs = [type(p).__name__ for p in eng._programs()]
        finally:
            eng.close()
        for i, (adapter, prompt, new) in enumerate(workload):
            assert outs[i] == want[i] == alone[i], (
                f"request {i} (adapter={adapter}) diverged")
            if adapter is None:
                assert outs[i] == _generate(lm, prompt)[:len(prompt) + new]
        by_key = {(a, p.tobytes()): o for (a, p, _), o in zip(workload, outs)}
        for (adapter, pkey), out in by_key.items():
            if adapter is not None and (None, pkey) in by_key:
                assert out != by_key[(None, pkey)]
        assert stats["requests"] == len(workload)
        assert stats["adapters"]["adapters_resident"] == 2
        assert programs == base_only.compiled_programs() == {
            "chunked_prefill": 1, "step": 1, "verify": 0}
        assert progs == [type(p).__name__ for p in base_only._programs()]

    def test_prefix_cache_is_adapter_scoped(self, lm):
        """One prompt under base/alpha/beta, twice each, prefix cache ON:
        every rerun hits its own adapter's chain and emits the cache-off
        tokens, which equal JAX's."""
        prompt = _prompts(1, seed_off=9)[0]
        workload = [(a, prompt, NEW_TOKENS)
                    for a in (None, "alpha", "beta")] * 2
        want = _sequential(_jax_engine(
            lm, adapters=_registry(lm.jcfg, module=jad),
            prefix_caching=False, name="ad-jax-nocache"), workload)
        eng = _engine(lm, adapters=_registry(lm.cfg), prefix_caching=True,
                      name="ad-scoped")
        try:
            for i, w in enumerate(workload):
                assert _submit(eng, _request(*w)) == want[i], (
                    f"round {i} adapter={w[0]}: cached pages leaked "
                    "across adapter scopes")
            assert eng.stats()["prefix_hits"] >= 3
        finally:
            eng.close()

    def test_speculative_identity(self, lm, monkeypatch):
        """Speculation over a mixed-adapter batch: the tokens equal the
        non-speculative sequential runs, and the verify program ran (the
        tiled prompts make the drafter propose).  The reference's own
        ``compiled_programs()["verify"] == 1`` depends on whether a draft
        survives its schedule, so this holds that verify calls happened
        on prompts that draft."""
        monkeypatch.setattr(engine_mod, "_SPEC_RATE_MARGIN", 0.0)
        rng = np.random.RandomState(SEED + 21)
        prompts = [np.tile(rng.randint(1, VOCAB, size=(4,)), 3).astype(
            np.int32) for _ in range(3)]
        workload = [(a, p, NEW_TOKENS)
                    for a, p in zip((None, "alpha", "beta"), prompts)]
        want = _sequential(_engine(lm, adapters=_registry(lm.cfg),
                                   name="ad-spec-ref"), workload)
        eng = _engine(lm, adapters=_registry(lm.cfg), speculative_tokens=3,
                      name="ad-spec")
        try:
            outs = _run_concurrent(eng, workload)
            stats = eng.stats()
            programs = eng.compiled_programs()
        finally:
            eng.close()
        assert outs == want
        assert stats["spec_steps"] > 0 and programs["verify"] == 1
        jwant = _sequential(_jax_engine(
            lm, adapters=_registry(lm.jcfg, module=jad),
            name="ad-jax-spec-ref"), workload)
        assert want == jwant

    def test_hot_load_evict_under_pinned_traffic(self, lm, tmp_path):
        """A third adapter into a 2-slot registry while one is pinned
        evicts only the idle one; every request decodes its tokens,
        including the reload of the evicted adapter."""
        for i, name in enumerate(("alpha", "beta", "gamma")):
            pad.save_adapter(str(tmp_path / f"{name}.npz"),
                             _factors(lm.cfg, SEED + 100 + i))
        prompt = _prompts(1, seed_off=11)[0]
        workload = [(a, prompt, 6)
                    for a in ("alpha", "beta", "gamma", "beta")]
        want = _sequential(_jax_engine(
            lm, adapters=_registry(lm.jcfg, ("alpha", "beta", "gamma"),
                                   module=jad), name="ad-jax-hot"),
            workload)
        reg = pad.AdapterRegistry(lm.cfg, slots=2, rank=RANK,
                                  directory=str(tmp_path), name="ad-hot")
        eng = _engine(lm, adapters=reg, name="ad-hot")
        try:
            assert _submit(eng, _request(*workload[0])) == want[0]
            assert _submit(eng, _request(*workload[1])) == want[1]
            pin, _ = reg.acquire("alpha")
            assert _submit(eng, _request(*workload[2])) == want[2]
            assert {r["name"] for r in reg.loaded()} == {"alpha", "gamma"}
            reg.release(pin)
            assert _submit(eng, _request(*workload[3])) == want[3]
        finally:
            eng.close()

    def test_hot_update_reaches_the_programs_in_place(self, lm):
        """A new revision of a resident adapter is copied INTO the
        engine's device stack: the tensors the programs read keep their
        storage, and the next request decodes the new revision."""
        prompt = _prompts(1, seed_off=12)[0]
        reg = _registry(lm.cfg, names=("alpha",))
        eng = _engine(lm, adapters=reg, name="ad-inplace")
        try:
            ptrs = {k: t.data_ptr()
                    for g in eng._adapter_stack.values()
                    for k, t in g.items()}
            first = _submit(eng, _request("alpha", prompt, NEW_TOKENS))
            reg.put("alpha", _factors(lm.cfg, SEED + 102))
            second = _submit(eng, _request("alpha", prompt, NEW_TOKENS))
            assert {k: t.data_ptr() for g in eng._adapter_stack.values()
                    for k, t in g.items()} == ptrs
            assert eng._chunk_prog.adapters is eng._adapter_stack
        finally:
            eng.close()
        fresh = _sequential(_engine(
            lm, adapters=_registry(lm.cfg, names=("x",)), name="ad-fresh"),
            [("x", prompt, NEW_TOKENS)])
        other = pad.AdapterRegistry(lm.cfg, slots=4, rank=RANK)
        other.put("x", _factors(lm.cfg, SEED + 102))
        new = _sequential(_engine(lm, adapters=other, name="ad-new"),
                          [("x", prompt, NEW_TOKENS)])
        assert first == fresh[0] and second == new[0] and first != second

    def test_load_fault_mid_traffic(self, lm, tmp_path):
        """adapter.load raising mid-traffic: the request sheds typed 429,
        the breaker keeps the loader cold on the retry, the resident
        adapter keeps serving, and after the backoff the load goes
        through."""
        for i, name in enumerate(("alpha", "beta")):
            pad.save_adapter(str(tmp_path / f"{name}.npz"),
                             _factors(lm.cfg, SEED + 100 + i))
        prompt = _prompts(1, seed_off=13)[0]
        workload = [("alpha", prompt, 6), ("beta", prompt, 6)]
        want = _sequential(_engine(lm, adapters=_registry(lm.cfg),
                                   name="ad-fault-ref"), workload)
        reg = pad.AdapterRegistry(lm.cfg, slots=2, rank=RANK,
                                  directory=str(tmp_path), name="ad-fault")
        eng = _engine(lm, adapters=reg, name="ad-fault")
        try:
            assert _submit(eng, _request(*workload[0])) == want[0]
            with faults.injected("adapter.load:raise*1") as inj:
                with pytest.raises(Overloaded):
                    _submit(eng, _request(*workload[1]))
                assert inj.fired("adapter.load") == 1
                with pytest.raises(Overloaded):
                    _submit(eng, _request(*workload[1]))
                assert inj.fired("adapter.load") == 1
                assert _submit(eng, _request(*workload[0])) == want[0]
                inj.advance_clock(600)
                assert _submit(eng, _request(*workload[1])) == want[1]
            assert eng.stats()["adapters"]["adapters_pinned"] == 0
        finally:
            eng.close()

    def test_unknown_adapter_and_no_registry_shed_404(self, lm):
        prompt = _prompts(1)[0]
        bare = _engine(lm, name="ad-bare")
        try:
            with pytest.raises(pad.AdapterNotFound):
                _submit(bare, {"tokens": prompt, "adapter": "alpha"})
            assert "adapters" not in bare.stats()
            assert bare.adapter_info() == []
        finally:
            bare.close()
        eng = _engine(lm, adapters=_registry(lm.cfg), name="ad-404")
        try:
            with pytest.raises(pad.AdapterNotFound):
                _submit(eng, {"tokens": prompt, "adapter": "ghost"})
            stats = eng.stats()
            assert stats["in_flight_requests"] == 0
            assert stats["adapters"]["adapters_pinned"] == 0
            assert {a["name"] for a in eng.adapter_info()} == \
                {"alpha", "beta"}
        finally:
            eng.close()

    def test_int8_weights_with_adapter_match_jax(self, lm):
        """int8 weights (the base dot through qeinsum) plus adapters (the
        delta in the model dtype): tokens equal JAX's engine on the same
        quantized tree and factors."""
        workload = _mixed_workload(n_each=1)
        want = _sequential(_jax_engine(
            lm, params=jax.device_put(lm.jtree_q),
            adapters=_registry(lm.jcfg, module=jad), name="ad-jax-int8"),
            workload)
        eng = _engine(lm, model=lm.model_q, adapters=_registry(lm.cfg),
                      name="ad-int8")
        try:
            outs = _run_concurrent(eng, workload)
        finally:
            eng.close()
        assert outs == want

    def test_stats_keys_and_request_counter_match_jax(self, lm):
        prompt = _prompts(1, seed_off=15)[0]
        counter = REGISTRY.counter(engine_mod.ADAPTER_REQUESTS_TOTAL)
        before = counter.value(engine="ad-stats", adapter="alpha")
        eng = _engine(lm, adapters=_registry(lm.cfg), name="ad-stats")
        jeng = _jax_engine(lm, adapters=_registry(lm.jcfg, module=jad),
                           name="ad-jax-stats")
        try:
            _submit(eng, _request("alpha", prompt, 4))
            jeng.submit(_request("alpha", prompt, 4))
            ours, theirs = eng.stats(), jeng.stats()
        finally:
            eng.close()
            jeng.close()
        assert set(ours) == set(theirs)
        assert ours["adapters"] == theirs["adapters"]
        assert counter.value(engine="ad-stats", adapter="alpha") == \
            before + 1


@pytest.mark.parametrize("queue,last", [
    ([None, None, None], {}),
    (["a", "a", "b", None], {"a": 3, "b": 1}),
    (["a", "a", "a"], {"a": 1}),
    (["a", None, "b", "a", None], {"": 5, "a": 2, "b": 7}),
    (["b", "c", "a"], {"b": 2, "c": 2}),
], ids=["fifo", "least-recent", "one-tenant", "base-newest", "never-seen"])
def test_fair_pick_matches_jax(queue, last):
    """``_fair_pick_locked`` picks the queue index JAX's picks, walking the
    queue to empty with the same admission bookkeeping."""
    picks = []
    for impl in (engine_mod.DecodeEngine, jax_engine_mod.DecodeEngine):
        fake = SimpleNamespace(
            _registry=object(), _fair_last=dict(last), _fair_seq=10,
            _queue=[{"adapter_name": a} for a in queue])
        order = []
        while fake._queue:
            i = impl._fair_pick_locked(fake)
            entry = fake._queue.pop(i)
            fake._fair_seq += 1
            fake._fair_last[entry["adapter_name"] or ""] = fake._fair_seq
            order.append(i)
        picks.append(order)
    assert picks[0] == picks[1]
