"""One rank of the tensor-parallel engine jobs of
tests/test_torch_serving_mesh.py.

JAX-free: the test writes the tiny LM's converted weights, the prompts
and the adapter factors to ``WORKDIR/inputs.pt``, starts the ranks with
``kubeflow_tpu_torch.testing.ranks.run_ranks`` (the ``KFT_*`` variables
name each) and reads what they write:

    python tests/torch_serving_mesh_worker.py cases WORKDIR      # 2 ranks
    python tests/torch_serving_mesh_worker.py gqa WORKDIR        # 4 ranks
    python tests/torch_serving_mesh_worker.py sweep WORKDIR      # 2 ranks
    python tests/torch_serving_mesh_worker.py cuda WORKDIR       # 2 ranks
    python tests/torch_serving_mesh_worker.py probe WORKDIR      # 2 or 4
    python tests/torch_serving_mesh_worker.py dies WORKDIR       # 2 ranks

``cases`` runs, one engine after another over a ``tensor`` mesh of the
job's ranks, the greedy prompts with a prefix hit, an int8 KV pool,
speculation, two adapters co-batched, a single-device export imported
into the mesh engine and fused rounds; ``gqa`` the greedy prompts on a
model with fewer kv heads than ranks; ``sweep`` speculation, the prefix
cache and adapters together, a hot swap of the engine and its gauge;
``cuda`` the greedy prompts and fused rounds on the GPU (the ranks share
it over gloo: ``KFT_DIST_BACKEND=gloo``); ``probe`` bench.py's multi-chip
probe (a concurrent burst, then the first prompt alone) on rank 0 without
a mesh and then over the job's ranks; ``dies`` rank 1 exits at once, and
rank 0's engine must fail with an error, not hang.
Rank 0 writes each case's tokens and stats to ``WORKDIR/<job>.pt``;
after each case every rank records its engine's per-slot scalars
(through a probe that rank 0 drives over the lockstep channel) in
``WORKDIR/<job>-rank<r>.pt``.
"""

import gc
import sys
import weakref
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    load_params,
    params_to_device,
)
from kubeflow_tpu_torch.models.generate import (  # noqa: E402
    DecodeConfig,
    _forward_with_cache,
    init_paged_state,
)
from kubeflow_tpu_torch.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from kubeflow_tpu_torch.ops.quantize import quantize_params  # noqa: E402
from kubeflow_tpu_torch.runtime import bootstrap  # noqa: E402
from kubeflow_tpu_torch.serving import engine as engine_mod  # noqa: E402
from kubeflow_tpu_torch.serving import lockstep, sharding  # noqa: E402
from kubeflow_tpu_torch.serving.adapters import (  # noqa: E402
    AdapterRegistry,
)
from kubeflow_tpu_torch.serving.engine import (  # noqa: E402
    DecodeEngine,
    follow,
)

TIMEOUT_S = 60.0
SCALARS = ("lengths", "done", "last_token", "keys", "stop_len",
           "adapter_ids")
GEOMETRY = dict(slots=2, prefill_len=16, prefill_chunk_tokens=4,
                kv_block_tokens=4)


class Probe:
    """Every rank's record of its engines' replicated slot scalars, taken
    when rank 0 calls ``dump`` over the lockstep channel, and a weak
    reference to each engine it saw (``alive``: the cases whose engine
    outlived its close)."""

    def __init__(self, chan):
        self.chan = chan
        self.seen = {}
        self.engines = {}

    def dump(self, uid, case):
        engine = self.chan.target(uid)
        state = engine._state
        self.seen[case] = {k: state[k].cpu().clone() for k in SCALARS}
        self.engines[case] = weakref.ref(engine)

    def logits(self, uid, tokens, ids, stack):
        """The forward of engine ``uid``'s served model (this rank's
        slices) over ``tokens`` [b, t] from an empty paged pool of this
        rank's kv heads, with adapter rows ``ids`` of the whole host
        ``stack`` when given: float32 logits over the whole vocab."""
        engine = self.chan.target(uid)
        model, dev = engine.model, engine.device
        tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
        b, t = tokens.shape
        bt = engine.kv_block_tokens
        mb = -(-t // bt)
        state = init_paged_state(
            model.cfg, b, b * mb, bt, device=dev,
            kv_heads=sharding.local_kv_heads(model.cfg.n_kv_heads,
                                             engine.mesh))
        adapters = None
        if stack is not None:
            adapters = {g: {k: torch.as_tensor(v).to(dev, model.cfg.dtype)
                            for k, v in leaves.items()}
                        for g, leaves in engine._shard_stack(stack).items()}
            ids = torch.as_tensor(np.asarray(ids), device=dev)
        with torch.inference_mode():
            return _forward_with_cache(
                model, tokens, (state["cache_k"], state["cache_v"]),
                torch.zeros(b, dtype=torch.int32, device=dev),
                tables=torch.arange(b * mb, device=dev).view(b, mb),
                adapter_ids=ids, adapters=adapters).cpu()

    def alive(self):
        gc.collect()
        return sorted(case for case, ref in self.engines.items()
                      if ref() is not None)


def _model(inputs, source):
    """The whole model an engine of ``source`` serves: the float32 tiny
    LM, its int8-weight form, or the GQA model."""
    key = "gqa" if source == "gqa" else "base"
    cfg = TransformerConfig(dtype=torch.float32, **inputs["cfg"][key])
    params = inputs["params"][key]
    if source == "int8":
        params = quantize_params(params)
    return load_params(Transformer(cfg, device="meta"),
                       params_to_device(params, inputs["device"]))


def _close(chan, engine, case):
    chan.call("probe", "dump", engine._uid, case)
    engine.close()


def _submit_all(engine, prompts, **extra):
    return [engine.submit(dict({"tokens": np.asarray(p, np.int32)}, **extra))
            ["tokens"][0].tolist() for p in prompts]


def _registry(inputs, cfg):
    reg = AdapterRegistry(cfg, slots=4, rank=inputs["adapter_rank"])
    for name, factors in inputs["adapters"].items():
        reg.put(name, factors)
    return reg


def _mixed(engine, workload):
    """Each (adapter, prompt) of ``workload`` submitted from its own
    thread at once: the rows co-batch."""
    import concurrent.futures

    def one(item):
        adapter, prompt = item
        req = {"tokens": np.asarray(prompt, np.int32)}
        if adapter:
            req["adapter"] = adapter
        return engine.submit(req)["tokens"][0].tolist()

    with concurrent.futures.ThreadPoolExecutor(len(workload)) as pool:
        return list(pool.map(one, workload))


def run_cases(mesh, chan, probe, inputs, out):
    decode = DecodeConfig(max_new_tokens=inputs["new_tokens"])
    base = _model(inputs, "base")
    prompts = inputs["prompts"]

    eng = DecodeEngine(base, decode, mesh=mesh, name="mesh-greedy",
                       **GEOMETRY)
    try:
        out["greedy"] = _submit_all(eng, prompts)
        hit = eng.submit({"tokens": np.asarray(prompts[2], np.int32),
                          "return_timing": True})
        out["hit"] = (hit["tokens"][0].tolist(), hit["cached_tokens"])
        out["greedy_stats"] = eng.stats()
        tokens = np.asarray(prompts[3:], np.int32)
        out["logits_base"] = (tokens, None, chan.call(
            "probe", "logits", eng._uid, tokens, None, None))
    finally:
        _close(chan, eng, "greedy")

    decode8 = DecodeConfig(max_new_tokens=inputs["new_tokens"],
                           kv_cache_dtype="int8")
    eng = DecodeEngine(base, decode8, mesh=mesh, name="mesh-int8",
                       **GEOMETRY)
    try:
        out["int8"] = _submit_all(eng, prompts)
    finally:
        _close(chan, eng, "int8")

    # Identity is under test, not the throughput gate: verify runs
    # whenever a slot drafts.
    engine_mod._SPEC_RATE_MARGIN = 0.0
    eng = DecodeEngine(base, decode, mesh=mesh, speculative_tokens=4,
                       name="mesh-spec", **GEOMETRY)
    try:
        out["spec"] = _submit_all(eng, inputs["spec_prompts"])
        out["spec_stats"] = eng.stats()
    finally:
        _close(chan, eng, "spec")

    reg = _registry(inputs, base.cfg)
    eng = DecodeEngine(base, decode, mesh=mesh, adapters=reg,
                       name="mesh-adapters", **GEOMETRY)
    try:
        out["adapters"] = _mixed(eng, inputs["adapter_workload"])
        # The base row and each adapter's row over one prompt.
        rows = [0]
        for name in ("alpha", "beta"):
            row, _ = reg.acquire(name)
            reg.release(row)
            rows.append(row)
        stack, _ = reg.stack_snapshot()
        stack = {g: {k: np.array(v) for k, v in leaves.items()}
                 for g, leaves in stack.items()}
        tokens = np.asarray([prompts[2]] * 3, np.int32)
        ids = np.asarray(rows, np.int32)
        out["logits_adapters"] = (tokens, ids, chan.call(
            "probe", "logits", eng._uid, tokens, ids, stack))
        out["logits_stack"] = stack
    finally:
        _close(chan, eng, "adapters")

    pre = DecodeEngine(base, decode, name="single-prefill", **GEOMETRY)
    eng = DecodeEngine(base, decode, mesh=mesh, name="mesh-import",
                       **GEOMETRY)
    try:
        handoff = pre.prefill_export(
            {"tokens": np.asarray(prompts[2], np.int32)})["kv_handoff"]
        got = eng.submit({"tokens": np.asarray(prompts[2], np.int32),
                          "kv_handoff": handoff})
        out["import"] = got["tokens"][0].tolist()
        out["import_stats"] = eng.stats()
        # The mesh engine's own export gathers every rank's heads.
        mine = eng.prefill_export(
            {"tokens": np.asarray(prompts[3], np.int32)})["kv_handoff"]
        theirs = pre.prefill_export(
            {"tokens": np.asarray(prompts[3], np.int32)})["kv_handoff"]
        out["export_max_err"] = float(max(
            (mine[s] - theirs[s]).abs().max() for s in ("k", "v")))
    finally:
        pre.close()
        _close(chan, eng, "import")

    eng = DecodeEngine(base, decode, mesh=mesh, decode_rounds=8,
                       name="mesh-fused", **GEOMETRY)
    try:
        out["fused"] = _submit_all(eng, prompts[:3])
        out["fused_stats"] = eng.stats()
        out["fused_programs"] = eng.compiled_programs()
    finally:
        _close(chan, eng, "fused")


def run_gqa(mesh, chan, probe, inputs, out):
    decode = DecodeConfig(max_new_tokens=inputs["new_tokens"])
    eng = DecodeEngine(_model(inputs, "gqa"), decode, mesh=mesh,
                       name="mesh-gqa", source="gqa", **GEOMETRY)
    try:
        out["gqa"] = _submit_all(eng, inputs["prompts"])
        out["gqa_stats"] = eng.stats()
    finally:
        _close(chan, eng, "gqa")


def run_sweep(mesh, chan, probe, inputs, out):
    from kubeflow_tpu_torch.runtime.prom import REGISTRY, parse_metrics

    engine_mod._SPEC_RATE_MARGIN = 0.0
    decode = DecodeConfig(max_new_tokens=inputs["new_tokens"])
    base = _model(inputs, "base")
    eng = DecodeEngine(base, decode, mesh=mesh, speculative_tokens=3,
                       adapters=_registry(inputs, base.cfg),
                       name="mesh-sweep", **dict(GEOMETRY, slots=3))
    try:
        out["sweep"] = _mixed(eng, inputs["sweep_workload"])
        gauge = parse_metrics(REGISTRY.render())
    finally:
        _close(chan, eng, "sweep")
    out["gauge_open"] = gauge
    out["gauge_closed"] = parse_metrics(REGISTRY.render())
    # A hot swap: the next engine (int8 weights) is built while the
    # first is still serving, and the first closed after it.
    first = DecodeEngine(base, decode, mesh=mesh, name="swap-a",
                         **GEOMETRY)
    try:
        out["swap_a"] = _submit_all(first, inputs["prompts"][:2])
        second = DecodeEngine(_model(inputs, "int8"), decode, mesh=mesh,
                              name="swap-b", source="int8", **GEOMETRY)
    finally:
        _close(chan, first, "swap_a")
    try:
        out["swap_b"] = _submit_all(second, inputs["prompts"][:2])
    finally:
        _close(chan, second, "swap_b")


def run_cuda(mesh, chan, probe, inputs, out):
    decode = DecodeConfig(max_new_tokens=inputs["new_tokens"])
    base = _model(inputs, "base")
    for name, rounds in (("greedy", 1), ("fused", 8)):
        eng = DecodeEngine(base, decode, mesh=mesh, decode_rounds=rounds,
                           name=f"mesh-cuda-{name}", **GEOMETRY)
        try:
            out[name] = _submit_all(eng, inputs["prompts"])
            out[f"{name}_stats"] = eng.stats()
        finally:
            _close(chan, eng, name)


def run_probe(mesh, chan, probe, inputs, out):
    """bench.py's multi-chip probe: one engine without a mesh, then one
    over the job's ranks, each serving a warm request, a concurrent
    burst and the first prompt alone."""
    decode = DecodeConfig(max_new_tokens=inputs["new_tokens"])
    base = _model(inputs, "base")
    prompts = inputs["probe_prompts"]
    for m, eng_mesh in ((1, None), (sharding.mesh_devices(mesh), mesh)):
        eng = DecodeEngine(base, decode, mesh=eng_mesh, slots=2,
                           prefill_len=16, kv_block_tokens=4,
                           prefill_chunk_tokens=8, name=f"mc-mesh{m}")
        try:
            _submit_all(eng, prompts[:1])
            burst = _mixed(eng, [(None, p) for p in prompts])
            out[f"mesh{m}"] = {"burst": burst,
                               "first": _submit_all(eng, prompts[:1])[0],
                               "stats": eng.stats()}
        finally:
            if eng_mesh is None:
                eng.close()
            else:
                _close(chan, eng, "probe")


def run_dies(mesh, chan, probe, inputs, out):
    """Rank 1 is gone (it exited after the mesh was built): building an
    engine, or the first request to one, must raise within the channel's
    timeout."""
    import time

    decode = DecodeConfig(max_new_tokens=inputs["new_tokens"])
    t0 = time.monotonic()
    try:
        eng = DecodeEngine(_model(inputs, "base"), decode, mesh=mesh,
                           name="mesh-dies", **GEOMETRY)
        try:
            _submit_all(eng, inputs["prompts"][:1])
        finally:
            eng.close()
        out["error"] = None
    except Exception as exc:  # noqa: BLE001 -- the error is the result
        out["error"] = repr(exc)
    out["seconds"] = time.monotonic() - t0


JOBS = {"cases": run_cases, "gqa": run_gqa, "sweep": run_sweep,
        "cuda": run_cuda, "probe": run_probe, "dies": run_dies}


def main(job: str, workdir: str) -> None:
    torch.set_num_threads(1)
    work = Path(workdir)
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    inputs.setdefault("device", "cpu")
    env = bootstrap.initialize(device=inputs["device"], timeout_s=TIMEOUT_S)
    mesh = sharding.build_mesh({"tensor": env.num_processes},
                               device=inputs["device"], timeout_s=TIMEOUT_S)
    chan = lockstep.channel(mesh)
    probe = Probe(chan)
    chan.register("probe", probe)
    if job == "dies" and not chan.leader:
        return  # this rank is gone
    if chan.leader:
        out = {}
        try:
            JOBS[job](mesh, chan, probe, inputs, out)
        finally:
            chan.close()
        torch.save(out, work / f"{job}.pt")
    else:
        follow(mesh, lambda source: _model(inputs, source or "base"))
    torch.save(dict(probe.seen, alive=probe.alive()),
               work / f"{job}-rank{env.process_id}.pt")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
