"""The port's router-fronted e2e scenarios (kubeflow_tpu_torch/testing/
e2e.py), twins of the JAX package's ``fleet``, ``survivable``,
``kv_spill``, ``multichip_serving`` and ``adapter_serving``, on the CPU
at the JAX scenarios' tiny float32 configurations.  The weights are made
with JAX and carried across by the port's loader (``models/convert.py``),
and every greedy token list a scenario served through the router equals
JAX ``generate()`` on the same weights; each scenario asserts its own
guarantees (no accepted request lost through the rolling restart,
streams after a kill equal to the uninterrupted control, replay and
fetch counters, the router -> engine trace, a typed 404 for an unknown
adapter).  The decode replica of ``multichip_serving`` runs on one
device in process here; its ``--mesh tensor=2`` twin, two
``serving.main`` processes over gloo, is ``slow``."""

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models.generate import DecodeConfig as JaxDecode
from kubeflow_tpu.models.generate import generate as jax_generate
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.testing import e2e

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

SEED = 20260818


class _Reference:
    """JAX weights of one scenario configuration and JAX generate()'s
    greedy continuation of a prompt on them (emitted tokens only)."""

    def __init__(self, overrides, max_new, params=None):
        self.cfg = jax_model_config(overrides)
        self.params = params if params is not None else jax.tree.map(
            np.asarray, nn.unbox(JaxTransformer(self.cfg).init(
                jax.random.key(SEED), np.zeros((1, 8), np.int32)))["params"])
        self.decode = JaxDecode(max_new_tokens=max_new, temperature=0.0)
        self._cache = {}

    def __call__(self, prompt):
        key = tuple(int(t) for t in prompt)
        if key not in self._cache:
            out, _ = jax_generate(self.cfg, self.params,
                                  np.asarray(key, np.int32)[None],
                                  self.decode)
            self._cache[key] = np.asarray(out)[0, len(key):].tolist()
        return self._cache[key]


@pytest.fixture(scope="module")
def tiny():
    """The fleet (8 new tokens) and survivable / kv_spill (12) references,
    on one set of weights."""
    ref = _Reference(e2e.OVERRIDES, 8)
    return {8: ref, 12: _Reference(e2e.OVERRIDES, 12, params=ref.params)}


@pytest.fixture(scope="module")
def multichip():
    return _Reference(e2e.MULTICHIP_OVERRIDES, 10)


def test_fleet_twin_matches_jax(tiny):
    """Discovery through the fake apiserver, the autoscaler's scale-out,
    the kill -> eject -> readmit walk, the zero-loss rolling restart and
    the end-to-end trace; every routed answer is prompt + JAX's
    tokens."""
    ref = tiny[8]
    out = e2e.fleet_smoke(device="cpu", params=ref.params)
    want = out["prompt"] + ref(out["prompt"])
    assert len(out["tokens"]) == 15
    assert all(tokens == want for tokens in out["tokens"])


def test_survivable_twin_matches_jax(tiny):
    """A replica killed at a client's third token: every stream the
    router spliced equals the uninterrupted control, which is JAX's."""
    ref = tiny[12]
    out = e2e.survivable_smoke(device="cpu", params=ref.params)
    assert out["control"] == ref(out["prompt"])
    assert len(out["streams"]) == 5
    assert all(stream == out["control"] for stream in out["streams"])


def test_kv_spill_twin_matches_jax(tiny):
    """Parked sessions spill to the host tier and re-import; a turn-2
    stream killed mid-generation resumes by fetching its pages from a
    peer; turn 1 and turn 2 equal JAX's on the whole contexts."""
    ref = tiny[12]
    out = e2e.kv_spill_smoke(device="cpu", params=ref.params)
    for prompt, control in zip(out["prompts"], out["controls"]):
        assert control == ref(prompt)
    for i in (0, 1):
        context = out["prompts"][i] + out["controls"][i] + out["extra"]
        assert out["control2"][i] == ref(context)
    assert out["fetched"] == out["control2"][1]


def test_multichip_serving_twin_one_device_decode(multichip):
    """The tiered pipeline through the router with a one-device decode
    replica: streams equal to the unified control and to JAX, the
    handoff counters moved, and the dead decode pool sheds a typed
    429."""
    out = e2e.multichip_serving_smoke(device="cpu",
                                      params=multichip.params)
    assert len(out["tiered"]) == 3
    for prompt, tokens in zip(out["prompts"], out["tiered"]):
        assert tokens == multichip(prompt)


@pytest.mark.slow
def test_multichip_serving_twin_mesh_decode(multichip):
    """As the one-device sibling, with the decode replica tensor-parallel
    over two ``serving.main --mesh tensor=2 --role decode`` processes;
    both exit 0 when stopped."""
    out = e2e.multichip_serving_smoke(device="cpu",
                                      params=multichip.params,
                                      mesh="tensor=2")
    for prompt, tokens in zip(out["prompts"], out["tiered"]):
        assert tokens == multichip(prompt)


def test_adapter_serving_twin_matches_jax():
    """Hot loads under traffic, the co-batched burst, eviction with a
    live pin, affinity and the typed 404; the base model's answers equal
    JAX's."""
    ref = _Reference(e2e.ADAPTER_OVERRIDES, 8)
    out = e2e.adapter_serving_smoke(device="cpu", params=ref.params)
    for prompt in out["prompts"]:
        key = "lm|" + ",".join(map(str, prompt))
        assert out["want"][key] == prompt + ref(prompt)
    variants = [k for k in out["want"] if not k.startswith("lm|")]
    assert len(variants) == 12


def test_main_runs_scenarios_by_name(capsys, monkeypatch, tmp_path):
    """``main`` runs the named scenarios in order with ``--device`` (and
    ``--mesh`` for multichip_serving only), reports each, exits 1 when
    one failed and refuses an unknown name."""
    calls = []

    def scenario(name, fails=False):
        def run(**kw):
            calls.append((name, kw))
            if fails:
                raise AssertionError("scripted failure")
        return run

    monkeypatch.setitem(e2e.COMMANDS, "fleet", scenario("fleet"))
    monkeypatch.setitem(e2e.COMMANDS, "multichip_serving",
                        scenario("multichip_serving"))
    monkeypatch.setitem(e2e.COMMANDS, "kv_spill",
                        scenario("kv_spill", fails=True))
    art = ["--artifacts-dir", str(tmp_path)]
    assert e2e.main(["multichip_serving", "fleet", "--device", "cpu",
                     "--mesh", "tensor=2"] + art) == 0
    assert calls == [
        ("multichip_serving", {"namespace": "kubeflow-test",
                               "device": "cpu", "mesh": "tensor=2"}),
        ("fleet", {"namespace": "kubeflow-test", "device": "cpu"})]
    out = capsys.readouterr().out
    assert "PASS multichip_serving" in out and "PASS fleet" in out
    assert e2e.main(["kv_spill", "fleet", "--device", "cpu"] + art) == 1
    assert "FAIL kv_spill: AssertionError: scripted failure" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit):
        e2e.main(["no_such_scenario", "--device", "cpu"])
    assert set(e2e.SCENARIOS) == {"fleet", "survivable", "kv_spill",
                                  "multichip_serving", "adapter_serving",
                                  "tpujob", "scheduler",
                                  "train_resilience", "hfta",
                                  "colocation", "serving", "engine",
                                  "faults", "train"}


def test_make_http_server_takes_a_server_class_like_jax():
    """The replicas' REST front takes the chaos harness's server class,
    as the JAX package's does (the twins kill replicas through it): the
    same parameters, and the listener is that class."""
    import inspect

    from kubeflow_tpu.serving.http import make_http_server as jax_make
    from kubeflow_tpu_torch.serving.http import make_http_server
    from kubeflow_tpu_torch.serving.model_server import ModelServer

    assert list(inspect.signature(make_http_server).parameters) == \
        list(inspect.signature(jax_make).parameters)
    httpd, thread = make_http_server(ModelServer(device="cpu"), port=0,
                                     host="127.0.0.1",
                                     server_cls=e2e.KillableServer)
    try:
        assert isinstance(httpd, e2e.KillableServer)
    finally:
        httpd.kill()
        thread.join(timeout=5)
    assert not thread.is_alive()
