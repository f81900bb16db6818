"""The port's control-plane e2e scenarios (kubeflow_tpu_torch/testing/
e2e.py), twins of the JAX package's ``tpujob``, ``scheduler``,
``train_resilience``, ``hfta`` and ``colocation``, on the CPU.  Each twin
asserts its JAX scenario's guarantees on the port.  The ``tpujob``,
``scheduler`` and ``colocation`` twins also run beside the JAX scenario
under ``torch_control_parity``'s recorder, and the two must plan, place,
evict, requeue, grant claims, stamp statuses and events, fire the
``scheduler.*``, ``autoscaler.claim`` and ``kube.request`` fault sites
and count metrics alike; the same comparison of ``train_resilience``
(its quarantine decisions) and ``hfta`` is ``slow``, since the JAX
scenarios train there (about 25 and 30 s)."""

import random
import types

import pytest
import torch

import kubeflow_tpu.runtime.supervisor as jax_supervisor
import kubeflow_tpu.testing.e2e as jax_e2e
import kubeflow_tpu_torch.runtime.supervisor as port_supervisor
from kubeflow_tpu_torch.testing import e2e
from torch_control_parity import SLICE_MAP, assert_same, differential_calls

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

SCENARIOS = ["tpujob", "scheduler", "train_resilience", "hfta",
             "colocation"]


def _run_both(name, monkeypatch):
    def run(pkg, mp):
        # The supervisors' restart-backoff jitter draws from an unseeded
        # RNG in both packages: seed it alike, so the backoff moves the
        # recorder's virtual policy clock alike.
        mp.setattr({"jax": jax_supervisor, "port": port_supervisor}[pkg],
                   "random", types.SimpleNamespace(
                       Random=lambda *a: random.Random(0)))
        if pkg == "jax":
            getattr(jax_e2e, f"{name}_smoke")()
        else:
            e2e.SCENARIOS[name](device="cpu")
    return differential_calls(run, monkeypatch)


def test_twins_are_registered_with_the_slice_map():
    assert all(name in e2e.SCENARIOS for name in SCENARIOS)
    assert e2e.SLICE_MAP == {k: SLICE_MAP[k] for k in e2e.SLICE_MAP}
    assert e2e.SLICE_MAP == {"v5e-8": "h100-8", "v5p-32": "h100-32"}


@pytest.mark.parametrize("name", ["tpujob", "scheduler", "colocation"])
def test_control_plane_twin_decides_as_jax(name, monkeypatch):
    """Quota holds, backfill, preemption through the grace window with
    a resumed victim, the claim's grant, prepull and release: the same
    plans, pods (up to the GPU request and selector), statuses, events,
    fault-site counts and metric deltas as the JAX scenario."""
    out = _run_both(name, monkeypatch)
    assert_same(out)
    assert out["port"]["log"]


def test_hfta_twin_folds_preempts_and_completes_members(monkeypatch):
    """The fold fires ``scheduler.fuse`` under the scenario's seed (its
    count against JAX's is the slow comparison's)."""
    from kubeflow_tpu_torch.testing import faults

    injectors = []
    parse = faults.parse
    monkeypatch.setattr(faults, "parse", lambda spec: injectors.append(
        parse(spec)) or injectors[-1])
    e2e.hfta_smoke(device="cpu")
    assert [inj.fired("scheduler.fuse") >= 1 for inj in injectors] == [True]


def test_train_resilience_twin_resumes_bit_identical():
    """The supervised restart resumes from a verified step and ends on
    parameters equal, bit for bit, to the uninterrupted control's; the
    walk-back and the quarantine hold as in the JAX scenario."""
    out = e2e.train_resilience_smoke(device="cpu")
    assert out["final"].keys() == out["control"].keys()
    assert all(torch.equal(out["final"][k], out["control"][k])
               for k in out["final"])


@pytest.mark.slow
@pytest.mark.parametrize("name", ["train_resilience", "hfta"])
def test_training_twin_decides_as_jax(name, monkeypatch):
    """The quarantine of a flapping node (train_resilience) and the
    fused gang's fold, eviction, per-member resume and completion
    (hfta) decide as in the JAX scenario, run beside it."""
    assert_same(_run_both(name, monkeypatch))
