"""The port's CI harness: the twins of tests/test_testing_harness.py's
JUnit, smoke and real-cluster driver tests, on
``kubeflow_tpu_torch.testing``.

The ``serving``, ``engine`` and ``faults`` smokes run in process on the
CPU (``device="cpu"``); ``train`` runs through ``e2e.main``, which
writes the JUnit report.  The real-cluster commands (``deploy``,
``deploy-crds``, ``tpujob-real``, ``teardown``) run against a scripted
``kubectl`` at the subprocess boundary: nothing reaches a cluster.
"""

import json
import subprocess
import types
import xml.etree.ElementTree as ET

import pytest
import torch

from kubeflow_tpu.testing import e2e as jax_e2e
from kubeflow_tpu_torch.testing import e2e
from kubeflow_tpu_torch.testing.junit import JUnitSuite

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)


class TestJUnit:
    def test_pass_fail_error_classification(self, tmp_path):
        suite = JUnitSuite("demo")
        suite.run("ok", lambda: None)
        suite.run("fails", lambda: (_ for _ in ()).throw(AssertionError("x")))
        suite.run("errors", lambda: (_ for _ in ()).throw(RuntimeError("y")))
        path = suite.write(tmp_path)
        root = ET.parse(path).getroot()
        assert root.get("tests") == "3"
        assert root.get("failures") == "1"
        assert root.get("errors") == "1"
        assert not suite.ok

    def test_xml_escaping(self, tmp_path):
        suite = JUnitSuite("esc")
        suite.run("bad<name>", lambda: None)
        root = ET.parse(suite.write(tmp_path)).getroot()
        assert root[0].get("name") == "bad<name>"


class TestE2EDrivers:
    def test_serving_smoke(self):
        e2e.serving_smoke(device="cpu")

    def test_engine_smoke(self):
        # Mixed lengths through 2 slots drain to zero occupancy; a
        # shared-prefix burst hits the prefix cache within the
        # inter-token bound; a speculative rebuild accepts drafts with
        # three programs and equals spec-off; an 8-page pool sheds 429s
        # with its counter deltas; decode_rounds 8 equals decode_rounds 1.
        e2e.engine_smoke(device="cpu")

    def test_fault_injection_smoke(self):
        # The seeded KFT_FAULTS scenario: overload shed (429 +
        # Retry-After), mid-generation deadline expiry (504) with slot
        # reuse, the loader breaker with last-good serving, graceful
        # drain, and every outcome on /metrics.
        e2e.fault_injection_smoke(device="cpu")

    def test_main_runs_train_and_writes_one_junit_case_each(
            self, tmp_path, monkeypatch, capsys):
        """``main`` runs the ``train`` smoke (two ResNet-18 steps in a
        subprocess) and a scripted failure, writes one JUnit suite with a
        case each, and exits 1 because one failed."""
        def fails(**kw):
            raise AssertionError("scripted failure")

        monkeypatch.setitem(e2e.COMMANDS, "faults", fails)
        rc = e2e.main(["train", "faults", "--device", "cpu",
                       "--artifacts-dir", str(tmp_path)])
        assert rc == 1
        out = capsys.readouterr().out
        assert "PASS train" in out
        assert "FAIL faults: AssertionError: scripted failure" in out
        root = ET.parse(tmp_path / "junit_e2e.xml").getroot()
        assert (root.get("tests"), root.get("failures"),
                root.get("errors")) == ("2", "1", "0")
        assert [c.get("name") for c in root] == ["train", "faults"]

    def test_commands_are_the_jax_harness_commands(self):
        assert set(e2e.COMMANDS) == set(jax_e2e.COMMANDS)
        assert set(e2e.SCENARIOS) == \
            set(e2e.COMMANDS) - e2e.CLUSTER_COMMANDS


class _FakeKubectl:
    """Records kubectl invocations; scripted stdout per verb."""

    def __init__(self):
        self.calls = []
        self.job_phase = "Succeeded"

    def __call__(self, cmd, input=None, text=None, capture_output=None,
                 timeout=None):
        assert cmd[0] == "kubectl"
        self.calls.append((cmd[1:], input))
        stdout = ""
        if cmd[1] == "get" and "-o" in cmd:
            stdout = ('{"status": {"phase": "%s"}}' % self.job_phase)
        return types.SimpleNamespace(returncode=0, stdout=stdout,
                                     stderr="")


class TestRealClusterDrivers:
    """The deploy-then-verify path against a scripted kubectl: the real
    code path short of a live apiserver, rendering through the port's
    registry."""

    def test_deploy_applies_and_waits(self, monkeypatch):
        fake = _FakeKubectl()
        monkeypatch.setattr(subprocess, "run", fake)
        e2e.deploy_real("kf-e2e")
        verbs = [c[0][0] for c in fake.calls]
        assert "apply" in verbs
        applied = [c for c in fake.calls if c[0][0] == "apply"][0]
        assert "kind: Deployment" in applied[1]
        assert "kubeflow_tpu_torch.operator.main" in applied[1]
        assert "google.com/tpu" not in applied[1]
        rollouts = [c[0] for c in fake.calls if c[0][0] == "rollout"]
        assert len(rollouts) >= 3
        assert all("--timeout=600s" in r for r in rollouts)

    def test_tpujob_real_polls_to_success(self, monkeypatch):
        fake = _FakeKubectl()
        monkeypatch.setattr(subprocess, "run", fake)
        e2e.tpujob_real("kf-e2e")
        applied = [c for c in fake.calls if c[0][0] == "apply"][0]
        assert "TPUJob" in applied[1]
        assert "sliceType: h100-1" in applied[1]
        assert any(c[0][0] == "get" for c in fake.calls)

    def test_tpujob_real_fails_on_failed_phase(self, monkeypatch):
        fake = _FakeKubectl()
        fake.job_phase = "Failed"
        monkeypatch.setattr(subprocess, "run", fake)
        with pytest.raises(AssertionError, match="Failed"):
            e2e.tpujob_real("kf-e2e")

    def test_deploy_crds_applies_only_the_crd(self, monkeypatch):
        fake = _FakeKubectl()
        monkeypatch.setattr(subprocess, "run", fake)
        e2e.deploy_crds("kf-e2e")
        applied = [c for c in fake.calls if c[0][0] == "apply"]
        assert len(applied) == 1
        assert "kind: CustomResourceDefinition" in applied[0][1]
        assert "kind: Deployment" not in applied[0][1]

    def test_teardown_deletes_the_namespace_and_needs_no_cluster(
            self, monkeypatch):
        fake = _FakeKubectl()
        monkeypatch.setattr(subprocess, "run", fake)
        e2e.teardown("kf-e2e")
        assert fake.calls[0][0][:3] == ["delete", "namespace", "kf-e2e"]

        def no_kubectl(*a, **kw):
            raise FileNotFoundError("kubectl")

        monkeypatch.setattr(subprocess, "run", no_kubectl)
        e2e.teardown("kf-e2e")

    def test_main_runs_cluster_commands_without_a_device(
            self, monkeypatch, tmp_path):
        fake = _FakeKubectl()
        monkeypatch.setattr(subprocess, "run", fake)
        assert e2e.main(["deploy-crds", "teardown", "--namespace", "kf",
                         "--artifacts-dir", str(tmp_path)]) == 0
        root = ET.parse(tmp_path / "junit_e2e.xml").getroot()
        assert root.get("tests") == "2" and root.get("failures") == "0"
        assert json.dumps([c[0] for c in fake.calls]).count('"kf"') >= 2
