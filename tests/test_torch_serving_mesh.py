"""The port's tensor-parallel decode engine against the JAX package.

The twins of tests/test_sharding.py's TestShardedEngineIdentity and
TestKVHandoff's sharded import, tests/test_adapters.py's mesh cases and
tests/test_fused_decode.py's mesh rounds, at test_sharding.py's tiny LM
(vocab 96, d_model 32, 2 layers, 4 heads, 4 kv heads, d_ff 64, float32,
divisible by 4) from the same seed.  The port's engine runs as a job of
JAX-free processes (tests/torch_serving_mesh_worker.py, started through
``testing/ranks.run_ranks`` over gloo, one intra-op thread a rank),
while the references are computed here: JAX ``generate()`` for greedy,
int8-KV and speculating traffic and for a single-device export imported
into the mesh engine, and the JAX engine's unsharded sequential runs
for mixed adapter traffic.  Tokens must be identical, ``mesh_devices``
2, and every rank's replicated slot scalars equal after every case.

``serving.main --mesh tensor=2 --device cpu`` runs as two processes:
one REST answer equal to JAX ``generate()``, rank 0 alone binds the
REST port, and both ranks exit cleanly on SIGTERM.

Slow (with the cheap siblings above in tier 1): a GQA model at
``tensor=4`` (2 kv heads: replicated, each rank's q head reading its kv
head); the full sweep (speculation, prefix cache, adapters) at mesh 2,
a hot swap and the mesh gauge; gRPC against the mesh server.
"""

import concurrent.futures
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models.generate import DecodeConfig as JaxDecode
from kubeflow_tpu.models.generate import _forward_with_cache as jax_forward
from kubeflow_tpu.models.generate import init_cache as jax_init_cache
from kubeflow_tpu.models.generate import generate as jax_generate
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving import adapters as jax_adapters
from kubeflow_tpu.serving.engine import DecodeEngine as JaxDecodeEngine
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.serving import adapters as port_adapters
from kubeflow_tpu_torch.serving.export import export
from kubeflow_tpu_torch.testing.ranks import (
    check_ranks,
    free_port,
    run_ranks,
)

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_serving_mesh_worker.py")
SEED = 20260804
VOCAB, NEW_TOKENS, RANK = 96, 10, 4
BASE = {"vocab_size": VOCAB, "d_model": 32, "n_layers": 2, "n_heads": 4,
        "n_kv_heads": 4, "d_ff": 64, "head_dim": 8, "max_seq_len": 64}
GQA = dict(BASE, n_kv_heads=2)
JOB_TIMEOUT_S = 150
SERVER_TIMEOUT_S = 90
LOADER = "kubeflow_tpu.serving.loaders:lm_generate"


def _prompts():
    rng = np.random.RandomState(SEED)
    return [rng.randint(1, VOCAB, size=(n,)).astype(np.int32)
            for n in (8, 5, 11, 16)]


def _spec_prompts():
    rep = np.asarray([7, 9, 7, 9, 7, 9, 7, 9], np.int32)
    return [rep, _prompts()[0], rep]


def _probe_prompts():
    """bench.py's probe: prompts of cycling lengths from a seeded rng."""
    rng = np.random.RandomState(SEED + 7)
    return [rng.randint(1, VOCAB, size=(n,)).astype(np.int32)
            for n in (3, 9, 14, 6, 12, 16)]


def _factors(cfg, seed):
    # tests/test_adapters.py's scale: large enough that the delta flips
    # greedy argmax on the toy model, so no identity check is vacuous.
    return jax_adapters.random_adapter_factors(cfg, RANK, seed, scale=0.5)


def _workload(n_each):
    rng = np.random.RandomState(SEED + 3)
    prompts = [rng.randint(1, VOCAB, size=(k,)).astype(np.int32)
               for k in (8, 5, 11, 16, 3, 9)]
    return [(adapter, prompts[i % len(prompts)])
            for i, adapter in enumerate((None, "alpha", "beta") * n_each)]


def _jax_lm(overrides):
    """The JAX LM's config and param tree: its init's structure and
    shapes (``eval_shape``, nothing compiled), filled from a seeded numpy
    draw at lecun-normal scale (unit norm scales)."""
    cfg = jax_model_config(dict(overrides, dtype="float32"))
    shapes = jax.eval_shape(lambda: nn.unbox(JaxTransformer(cfg).init(
        jax.random.key(SEED), np.zeros((1, 8), np.int32)))["params"])
    rng = np.random.RandomState(SEED)

    def draw(path, s):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return np.ones(s.shape, np.float32)
        fan_in = s.shape[-1] if "embed" in jax.tree_util.keystr(path) \
            else s.shape[-2]
        return (rng.standard_normal(s.shape)
                / np.sqrt(fan_in)).astype(np.float32)

    return cfg, jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_tokens(cfg, params, prompts, **decode):
    dc = JaxDecode(max_new_tokens=NEW_TOKENS, temperature=0.0, **decode)
    return [np.asarray(jax_generate(cfg, params, np.asarray(p)[None],
                                    dc)[0])[0].tolist() for p in prompts]


def _jax_adapter_refs(cfg, params, workload, **kw):
    """JAX's unsharded engine, one request at a time (tests/
    test_adapters.py's ``_sequential_refs``)."""
    reg = jax_adapters.AdapterRegistry(cfg, slots=4, rank=RANK)
    for i, name in enumerate(("alpha", "beta")):
        reg.put(name, _factors(cfg, SEED + 100 + i))
    eng = JaxDecodeEngine(cfg, dict(params),
                          JaxDecode(max_new_tokens=NEW_TOKENS),
                          slots=2, prefill_len=16, prefill_chunk_tokens=4,
                          kv_block_tokens=4, adapters=reg,
                          name="mesh-ad-ref", **kw)
    try:
        out = []
        for adapter, prompt in workload:
            req = {"tokens": prompt}
            if adapter:
                req["adapter"] = adapter
            out.append(np.asarray(eng.submit(req)["tokens"])[0].tolist())
        return out
    finally:
        eng.close()


def _write_inputs(work, base, gqa, n_each):
    cfg = base[0]
    torch.save({
        "cfg": {"base": BASE, "gqa": GQA},
        "params": {"base": params_from_jax(base[1]),
                   "gqa": params_from_jax(gqa[1])},
        "new_tokens": NEW_TOKENS,
        "prompts": [p.tolist() for p in _prompts()],
        "spec_prompts": [p.tolist() for p in _spec_prompts()],
        "adapter_rank": RANK,
        "adapters": {name: port_adapters.random_adapter_factors(
            cfg, RANK, SEED + 100 + i, scale=0.5)
            for i, name in enumerate(("alpha", "beta"))},
        "adapter_workload": [(a, p.tolist()) for a, p in _workload(1)],
        "sweep_workload": [(a, p.tolist()) for a, p in _workload(n_each)],
        "probe_prompts": [p.tolist() for p in _probe_prompts()],
    }, work / "inputs.pt")


def _job(work, name, ranks, pool):
    return pool.submit(run_ranks, [WORKER, name, str(work)], ranks,
                       timeout_s=JOB_TIMEOUT_S, cwd=str(REPO), threads=1)


def _results(work, name, ranks, future):
    check_ranks(future.result())
    return (torch.load(work / f"{name}.pt", weights_only=False),
            [torch.load(work / f"{name}-rank{r}.pt", weights_only=False)
             for r in range(ranks)])


@pytest.fixture(scope="module")
def lm():
    return _jax_lm(BASE)


@pytest.fixture(scope="module")
def cases(tmp_path_factory, lm):
    """The 2-rank job's outputs and the JAX references, computed while
    the ranks run."""
    work = tmp_path_factory.mktemp("mesh_cases")
    _write_inputs(work, lm, lm, 1)
    cfg, params = lm
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = _job(work, "cases", 2, pool)
        refs = {
            "greedy": _jax_tokens(cfg, params, _prompts()),
            "int8": _jax_tokens(cfg, params, _prompts(),
                                kv_cache_dtype="int8"),
            "spec": _jax_tokens(cfg, params, _spec_prompts()),
            "adapters": _jax_adapter_refs(cfg, params, _workload(1)),
        }
        out, ranks = _results(work, "cases", 2, future)
    return out, ranks, refs


def test_greedy_identity_and_prefix_hits(cases):
    """Mesh 2 == generate() for mixed-length prompts with slot reuse; a
    shared-prefix admission aliases 8 cached tokens and stays
    identical (the twin of test_greedy_identity_and_prefix_hits[2])."""
    out, _, refs = cases
    assert out["greedy"] == refs["greedy"]
    tokens, cached = out["hit"]
    assert tokens == refs["greedy"][2]
    assert cached == 8
    assert out["greedy_stats"]["mesh_devices"] == 2
    assert out["greedy_stats"]["prefix_hits"] >= 1


def test_int8_kv_identity(cases):
    out, _, refs = cases
    assert out["int8"] == refs["int8"]


def test_speculative_identity(cases):
    out, _, refs = cases
    assert out["spec"] == refs["spec"]
    assert out["spec_stats"]["spec_steps"] > 0


def test_adapters_mesh2_identity(cases):
    """Mixed base/alpha/beta traffic co-batched at mesh 2 equals JAX's
    unsharded engine run one request at a time."""
    out, _, refs = cases
    assert out["adapters"] == refs["adapters"]


def test_import_into_sharded_engine(cases):
    """A single-device prefill replica's pages import into the mesh-2
    engine (each rank its kv heads), and the mesh engine's own export
    gathers every rank's heads into the single-device engine's bytes."""
    out, _, refs = cases
    assert out["import"] == refs["greedy"][2]
    assert out["import_stats"]["handoff_pages_in"] == 2
    assert out["export_max_err"] <= 1e-5


def test_mesh_fused_identity(cases):
    out, _, refs = cases
    assert out["fused"] == refs["greedy"][:3]
    assert out["fused_stats"]["fused_rounds"] > 0
    assert out["fused_stats"]["mesh_devices"] == 2
    assert out["fused_programs"]["decode_rounds"] == 1


@pytest.mark.parametrize("case", ["greedy", "int8", "spec", "adapters",
                                  "import", "fused"])
def test_ranks_replicated_scalars_equal(cases, case):
    _, ranks, _ = cases
    mine, theirs = ranks[0][case], ranks[1][case]
    assert set(mine) == set(theirs)
    for name in mine:
        assert torch.equal(mine[name], theirs[name]), (case, name)


@pytest.mark.parametrize("case", ["base", "adapters"])
def test_prefill_logits_match_jax(cases, lm, case):
    """The mesh-2 engine's served model (each rank its slices, the
    row-parallel partials and adapter deltas reduced, the vocab
    gathered) gives JAX's unsharded forward's logits within 1e-5: a
    16-token prompt on the base model, and one prompt on the base row
    and on each adapter's row."""
    out, _, _ = cases
    cfg, params = lm
    tokens, ids, got = out[f"logits_{case}"]
    if ids is not None:
        params = dict(params, adapters=out["logits_stack"])
    want, _ = jax_forward(cfg, params, tokens,
                          jax_init_cache(cfg, *tokens.shape), 0,
                          adapter_ids=ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("rank", [0, 1])
def test_closed_mesh_engines_are_collected(cases, rank):
    """No rank keeps a closed engine (its sliced model and pool) alive:
    the lockstep channel lets go of it at close on rank 0 as on the
    followers."""
    _, ranks, _ = cases
    assert ranks[rank]["alive"] == []


# ---------------------------------------------------------------------------
# serving.main --mesh tensor=2 as two processes


def _export_lm(base, params, version=1):
    export(base, version, {"params": params}, loader=LOADER,
           config={"model": dict(BASE, dtype="float32"),
                   "max_new_tokens": NEW_TOKENS})


def _listening_inodes(pid):
    inodes = set()
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            target = os.readlink(fd)
        except OSError:
            continue
        if target.startswith("socket:["):
            inodes.add(target[8:-1])
    return inodes


def _port_inode(port):
    """The inode of the socket listening on TCP ``port``."""
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        for line in Path(table).read_text().splitlines()[1:]:
            fields = line.split()
            if fields[3] == "0A" and int(fields[1].split(":")[1],
                                         16) == port:
                return fields[9]
    return None


def _start_server(base, *flags):
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(2):
        env = dict(os.environ, KFT_NUM_PROCESSES="2",
                   KFT_PROCESS_ID=str(rank),
                   KFT_COORDINATOR_ADDRESS=coordinator,
                   OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.serving.main",
             "--model_name", "lm", "--model_base_path", str(base),
             "--port", "0", "--host", "127.0.0.1", "--device", "cpu",
             "--mesh", "tensor=2", "--poll_interval_s", "60", *flags],
            cwd=str(REPO), env=env, stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    lines = {0: [], 1: []}

    def pump(rank):
        for line in procs[rank].stderr:
            lines[rank].append(line)

    pumps = [threading.Thread(target=pump, args=(r,), daemon=True)
             for r in range(2)]
    for t in pumps:
        t.start()
    return procs, lines, pumps


def _wait_marker(lines, rank, prefix, procs):
    deadline = time.monotonic() + SERVER_TIMEOUT_S
    while time.monotonic() < deadline:
        for line in list(lines[rank]):
            if line.startswith(prefix):
                return line.strip()
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.05)
    raise AssertionError(
        f"rank {rank} printed no {prefix}: " + "".join(lines[rank])[-3000:])


def _stop(procs, pumps):
    if procs[0].poll() is None:
        procs[0].send_signal(signal.SIGTERM)
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(SERVER_TIMEOUT_S))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(None)
    for t in pumps:
        t.join(timeout=5)
    return codes


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=SERVER_TIMEOUT_S) as resp:
        return json.loads(resp.read())


def test_main_mesh_two_processes_serve(tmp_path, lm):
    """One REST answer equal to JAX generate(); only rank 0 listens on
    the REST port; both ranks exit 0 when rank 0 is stopped."""
    cfg, params = lm
    _export_lm(tmp_path / "lm", params)
    prompt = _prompts()[2]
    want = _jax_tokens(cfg, params, [prompt])[0]
    procs, lines, pumps = _start_server(tmp_path / "lm", "--grpc_port",
                                        "-1")
    try:
        ready = _wait_marker(lines, 0, "KFT_SERVING_READY", procs)
        _wait_marker(lines, 1, "KFT_SERVING_FOLLOWER rank=1", procs)
        port = int(ready.split("rest=")[1].split()[0])
        got = _post(port, "/model/lm:predict",
                    {"instances": [{"tokens": prompt.tolist()}]})
        assert got["predictions"][0]["tokens"] == want
        inode = _port_inode(port)
        assert inode in _listening_inodes(procs[0].pid)
        assert inode not in _listening_inodes(procs[1].pid)
        assert not any(line.startswith("KFT_SERVING_READY")
                       for line in lines[1])
    finally:
        codes = _stop(procs, pumps)
    assert codes == [0, 0], "".join(lines[0] + lines[1])[-4000:]


# ---------------------------------------------------------------------------
# slow: mesh 4 with GQA, the full sweep, a hot swap, the gauge, gRPC


@pytest.mark.slow
def test_gqa_mesh4_identity(tmp_path):
    """4 q heads and 2 kv heads at tensor=4: the kv heads stay whole
    (with a warning) and each rank's q head reads its own kv head."""
    gqa = _jax_lm(GQA)
    _write_inputs(tmp_path, gqa, gqa, 1)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = _job(tmp_path, "gqa", 4, pool)
        want = _jax_tokens(*gqa, _prompts())
        out, ranks = _results(tmp_path, "gqa", 4, future)
    assert out["gqa"] == want
    assert out["gqa_stats"]["mesh_devices"] == 4
    for rank in ranks[1:]:
        for name, value in ranks[0]["gqa"].items():
            assert torch.equal(value, rank["gqa"][name]), name


@pytest.mark.slow
def test_full_sweep_spec_prefix_mesh_swap_gauge(tmp_path, lm):
    """Speculation, the prefix cache and adapters at mesh 2 over 12
    mixed requests equal JAX's unsharded sequential engine; a hot swap
    to int8 weights serves int8 generate()'s tokens; the mesh gauge
    reads 2 while an engine is open and 0 after close."""
    from kubeflow_tpu.ops.quantize import quantize_params
    from kubeflow_tpu_torch.runtime.prom import sample_value

    _write_inputs(tmp_path, lm, lm, 4)
    cfg, params = lm
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = _job(tmp_path, "sweep", 2, pool)
        want = _jax_adapter_refs(cfg, params, _workload(4),
                                 speculative_tokens=3)
        base = _jax_tokens(cfg, params, _prompts()[:2])
        int8 = _jax_tokens(cfg, quantize_params(params), _prompts()[:2])
        out, ranks = _results(tmp_path, "sweep", 2, future)
    assert out["sweep"] == want
    assert out["swap_a"] == base
    assert out["swap_b"] == int8
    name = "kft_engine_mesh_devices"
    assert sample_value(out["gauge_open"], name, engine="mesh-sweep") == 2
    assert sample_value(out["gauge_closed"], name, engine="mesh-sweep") == 0
    for case in ("sweep", "swap_a", "swap_b"):
        for key, value in ranks[0][case].items():
            assert torch.equal(value, ranks[1][case][key]), (case, key)
    # The swapped-out engine is freed on every rank.
    assert [r["alive"] for r in ranks] == [[], []]


@pytest.mark.slow
@pytest.mark.parametrize("ranks", [2, 4])
def test_multichip_probe_tokens_identical_across_meshes(tmp_path, lm,
                                                        ranks):
    """bench.py's multi-chip probe (``bench.py:1553-1656``) at meshes 1
    and ``ranks``: the burst's and the first prompt's tokens identical
    across meshes, and equal to JAX generate()."""
    cfg, params = lm
    _write_inputs(tmp_path, lm, lm, 1)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = _job(tmp_path, "probe", ranks, pool)
        want = _jax_tokens(cfg, params, _probe_prompts())
        out, _ = _results(tmp_path, "probe", ranks, future)
    one, many = out["mesh1"], out[f"mesh{ranks}"]
    assert one["burst"] == many["burst"] == want
    assert one["first"] == many["first"] == want[0]
    assert many["stats"]["mesh_devices"] == ranks


@pytest.mark.slow
def test_dead_rank_fails_rank_0_with_an_error(tmp_path, lm):
    """A follower that is gone makes rank 0's engine raise (the lockstep
    broadcast fails), well inside the channel's timeout: no hang."""
    _write_inputs(tmp_path, lm, lm, 1)
    results = run_ranks([WORKER, "dies", str(tmp_path)], 2,
                        timeout_s=JOB_TIMEOUT_S, cwd=str(REPO), threads=1)
    check_ranks(results)
    out = torch.load(tmp_path / "dies.pt", weights_only=False)
    assert out["error"] is not None and "lockstep" in out["error"]
    assert out["seconds"] < 60


@pytest.mark.slow
def test_main_mesh_grpc(tmp_path, lm):
    """gRPC Predict on the mesh server answers what REST answers."""
    from kubeflow_tpu_torch.serving.grpc_server import PredictionClient

    cfg, params = lm
    _export_lm(tmp_path / "lm", params)
    prompt = _prompts()[0]
    want = _jax_tokens(cfg, params, [prompt])[0]
    procs, lines, pumps = _start_server(tmp_path / "lm", "--grpc_port",
                                        "0")
    try:
        ready = _wait_marker(lines, 0, "KFT_SERVING_READY", procs)
        grpc_port = int(ready.split("grpc=")[1].split()[0])
        client = PredictionClient(f"127.0.0.1:{grpc_port}")
        got = client.predict("lm", {"tokens": prompt[None]})
        assert np.asarray(got["tokens"])[0].tolist() == want
    finally:
        codes = _stop(procs, pumps)
    assert codes == [0, 0], "".join(lines[0] + lines[1])[-4000:]

