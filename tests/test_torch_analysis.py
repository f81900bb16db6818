"""The port's analyzer (``kubeflow_tpu_torch/analysis``) over the port.

``python -m kubeflow_tpu_torch.analysis`` must find nothing in
``kubeflow_tpu_torch/`` with its empty baseline, each checker must fire
on the port's own paths (the fixtures mirror tests/test_analysis.py's,
rescoped), the port's fault-site registry must equal the set of sites
its code fires, and the JAX analyzer's verdict on the same fixtures
must agree where the checker is shared."""

import ast
import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from kubeflow_tpu_torch.analysis import analyze_source, core
from kubeflow_tpu_torch.analysis import faultsites

REPO = Path(__file__).resolve().parents[1]
POLICY = "kubeflow_tpu_torch/serving/mod.py"
PROGRAMS = "kubeflow_tpu_torch/serving/programs.py"
CKPT = "kubeflow_tpu_torch/runtime/checkpoint.py"
ENGINE = "kubeflow_tpu_torch/serving/engine.py"


def _src(s: str) -> str:
    return '"""mod."""\n' + textwrap.dedent(s)


def _checks(found):
    return [f.check for f in found]


def test_port_runs_clean_with_an_empty_baseline():
    baseline_path = REPO / "kubeflow_tpu_torch" / "analysis" / \
        "baseline.json"
    baseline = core.load_baseline(baseline_path)
    assert baseline == []
    report = core.run(REPO, baseline=baseline)
    assert report.ok, [f.render() for f in report.findings] + report.stale
    # The whole port is analyzed, and only the port.
    files = {p.relative_to(REPO).parts[0] for p in core.py_files(REPO)}
    assert files == {"kubeflow_tpu_torch"}
    assert report.files > 50


def test_cli_exits_zero_over_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.analysis", "--json"],
        capture_output=True, text=True, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["findings"] == [] and payload["stale_baseline"] == []
    assert payload["baselined"] == []


def test_every_suppression_carries_a_reason():
    """Each ``# kft: allow=`` directive in the port sits under or beside
    a comment that says why."""
    bare = []
    for path in core.py_files(REPO):
        lines = path.read_text(encoding="utf-8").splitlines()
        for i, line in enumerate(lines):
            if "kft: allow=" not in line or "analysis/" in str(path):
                continue
            before = lines[i - 1].strip() if i else ""
            if not before.startswith("#") and \
                    line.strip().startswith("#"):
                bare.append(f"{path}:{i + 1}")
    assert not bare, bare


class TestRescopedPaths:
    def test_clock_fires_on_port_policy_module(self):
        found = analyze_source(_src("""
            import time


            def drain():
                return time.monotonic() + 5
        """), rel=POLICY)
        assert _checks(found) == ["clock-discipline"]
        assert found[0].symbol == "time.monotonic@drain"

    @pytest.mark.parametrize("rel", [
        "kubeflow_tpu_torch/runtime/tracing.py",
        "kubeflow_tpu_torch/runtime/supervisor.py",
        "kubeflow_tpu_torch/serving/http.py"])
    def test_clock_policy_modules_of_the_port(self, rel):
        found = analyze_source(_src("""
            import time

            T = time.time()
        """), rel=rel)
        assert _checks(found) == ["clock-discipline"]

    @pytest.mark.parametrize("rel", [
        "kubeflow_tpu_torch/runtime/train.py",
        "kubeflow_tpu/serving/http.py"])
    def test_clock_ignores_non_policy_and_jax_paths(self, rel):
        found = analyze_source(_src("""
            import time

            T = time.monotonic()
        """), rel=rel)
        assert found == []

    def test_hot_loop_is_the_ports_engine(self):
        found = analyze_source(_src("""
            from kubeflow_tpu_torch.runtime import tracing


            def _drain(self):
                span = tracing.start_span("engine.decode")
                span.end()
        """), rel=ENGINE)
        assert [f.symbol for f in found] == ["hot-start-span"]

    def test_atomic_write_binds_the_ports_checkpoints(self):
        src = _src("""
            import json


            def write_manifest(path, payload):
                with open(path, "w") as f:
                    json.dump(payload, f)
        """)
        found = analyze_source(src, rel=CKPT)
        assert [f.symbol for f in found] == [
            "bare-write:path@write_manifest"]
        assert analyze_source(src, rel=POLICY) == []

    def test_directory_rename_commit_suppressed_with_reason(self):
        """The port's checkpoint step commit (files fsynced inside a
        temporary directory that is then renamed) is the one
        atomic-write suppression, and it says so."""
        text = (REPO / CKPT).read_text()
        i = text.index("# kft: allow=atomic-write")
        context = text[max(0, i - 300):i]
        assert "DIRECTORY rename" in context
        assert "_fsync_dir(tmp)" in text[i:i + 400]

    def test_lock_guard_and_blocking_under_lock(self):
        found = analyze_source(_src("""
            import threading
            import time


            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.x = 0

                def bump(self):
                    with self._lock:
                        self.x += 1
                        time.sleep(1)

                def reset(self):
                    self.x = 0
        """), rel=POLICY)
        assert sorted(_checks(found)) == ["blocking-under-lock",
                                          "lock-guard"]

    def test_metric_hygiene_on_port_names(self):
        found = analyze_source(_src("""
            from kubeflow_tpu_torch.runtime.prom import REGISTRY

            REGISTRY.counter("kft_serving_requests", "x").inc()
        """), rel=POLICY)
        assert _checks(found) == ["metric-hygiene"]


BODY_CLEAN = """
    import os
    import random
    import time

    import torch


    class Step:
        def _body(self):
            out = torch.zeros(4)
            return out + 1
"""


class TestCapturePurity:
    def test_real_programs_module_is_clean(self):
        text = (REPO / PROGRAMS).read_text()
        assert "def _body" in text
        assert analyze_source(text, rel=PROGRAMS) == []

    def test_clean_body(self):
        assert analyze_source(_src(BODY_CLEAN), rel=PROGRAMS) == []

    @pytest.mark.parametrize("call,symbol", [
        ("time.time()", "time.time@Step._body"),
        ("random.random()", "random.random@Step._body"),
        ("print(out)", "print@Step._body"),
        ("os.getpid()", "os.getpid@Step._body")])
    def test_host_effect_in_body_fires(self, call, symbol):
        mutated = BODY_CLEAN.replace(
            "            return out + 1",
            f"            {call}\n            return out + 1")
        found = [f for f in analyze_source(_src(mutated), rel=PROGRAMS)
                 if f.check == "capture-purity"]
        assert [f.symbol for f in found] == [symbol]

    def test_nested_function_in_body_counts(self):
        found = analyze_source(_src("""
            import random


            class P:
                def _body(self):
                    def inner():
                        return random.random()
                    return inner()
        """), rel=PROGRAMS)
        assert [f.symbol for f in found] == [
            "random.random@P._body.inner"]

    def test_host_code_outside_bodies_and_modules_is_legal(self):
        src = _src("""
            import random
            import time


            class P:
                def run(self):
                    return time.perf_counter()

                def _body(self):
                    return 1
        """)
        assert analyze_source(src, rel=PROGRAMS) == []
        mutated = src.replace("return 1", "return random.random()")
        assert analyze_source(mutated, rel=POLICY) == []

    def test_suppression_honored(self):
        found = analyze_source(_src("""
            import random


            class P:
                def _body(self):
                    # capture-time constant, documented as such
                    # kft: allow=capture-purity
                    return random.random()
        """), rel=PROGRAMS)
        assert found == []


FAULTS_REL = "kubeflow_tpu_torch/testing/faults.py"
FAULTS_DOC = '''"""Fault harness.

Hook sites the port fires:

    engine.step       before each step-program call
    loader.load       before each load attempt

Not ported yet: the JAX package also fires ``router.forward`` and
``kube.request``.
"""
'''
PRODUCER = '''"""m."""
from kubeflow_tpu_torch.testing import faults


def go():
    faults.fire("engine.step")
    faults.fire("loader.load")
'''


class TestFaultSiteRegistry:
    def _finish(self, faults_text, producer_text, root=None):
        checker = faultsites.FaultSiteRegistry(root)
        checker.visit_module(FAULTS_REL, ast.parse(faults_text),
                             faults_text)
        checker.visit_module(POLICY, ast.parse(producer_text),
                             producer_text)
        return checker.finish()

    def test_not_ported_paragraph_is_not_a_registry(self):
        assert self._finish(FAULTS_DOC, PRODUCER) == []

    def test_unregistered_and_phantom_sites_fire(self):
        found = self._finish(FAULTS_DOC,
                             PRODUCER + '    faults.fire("engine.warp")\n')
        assert [f.symbol for f in found] == ["unregistered:engine.warp"]
        found = self._finish(FAULTS_DOC, PRODUCER.replace(
            '    faults.fire("loader.load")\n', ""))
        assert [f.symbol for f in found] == ["phantom:loader.load"]

    def test_readme_side_checked_when_root_given(self, tmp_path):
        (tmp_path / "README.md").write_text(
            "## PyTorch / H100 port\n\n"
            f"{faultsites.DOCS_MARKER} The port fires `engine.step`\n"
            "and `engine.vanished`.\n\n```bash\nKFT_FAULTS=...\n```\n")
        found = self._finish(FAULTS_DOC, PRODUCER, root=tmp_path)
        assert sorted(f.symbol for f in found) == [
            "phantom-doc:engine.vanished", "undocumented:loader.load"]

    def test_registry_equals_fired_sites(self):
        """The port's registry rows are exactly the sites its code fires
        (loader.load and batcher.dispatch among them), README lists the
        same, and the not-ported paragraph names only sites the JAX
        package fires and the port does not (none, once every JAX site
        is ported, and then the paragraph is gone)."""
        fired = set()
        for path in core.py_files(REPO):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.Call) and getattr(
                        node.func, "attr", "") == "fire" and node.args \
                        and isinstance(node.args[0], ast.Constant):
                    fired.add(node.args[0].value)
        doc = ast.get_docstring(ast.parse((REPO / FAULTS_REL).read_text()),
                                clean=False)
        rows = set(faultsites._DOCSTRING_ROW.findall(doc))
        assert rows == fired
        assert {"loader.load", "batcher.dispatch"} <= fired
        readme = (REPO / "README.md").read_text()
        para = readme[readme.index(faultsites.DOCS_MARKER):]
        para = para[:para.index("```")]
        assert set(faultsites._BACKTICKED.findall(para)) == fired
        not_ported = doc[doc.index("Not ported yet"):
                         doc.index("Clock skips")] \
            if "Not ported yet" in doc else ""
        not_ported = set(re.findall(r"``([a-z_]+\.[a-z_]+)``",
                                    not_ported))
        jax_doc = ast.get_docstring(ast.parse(
            (REPO / "kubeflow_tpu/testing/faults.py").read_text()),
            clean=False)
        jax_rows = set(faultsites._DOCSTRING_ROW.findall(jax_doc))
        assert not_ported == jax_rows - fired


def test_shared_checkers_agree_with_the_jax_analyzer():
    """A fixture that the JAX analyzer flags on a JAX policy path is
    flagged alike by the port's analyzer on the port's path."""
    from kubeflow_tpu.analysis import analyze_source as jax_analyze

    src = _src("""
        import threading
        import time


        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0

            def bump(self):
                with self._lock:
                    self.x += 1

            def poke(self):
                self.x = time.monotonic()
    """)
    want = jax_analyze(src, rel="kubeflow_tpu/serving/mod.py")
    got = analyze_source(src, rel=POLICY)
    assert sorted((f.check, f.symbol, f.line) for f in got) == \
        sorted((f.check, f.symbol, f.line) for f in want)
    assert {f.check for f in got} == {"clock-discipline", "lock-guard"}
