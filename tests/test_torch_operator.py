"""The port's operator (gang scheduler, node quarantine, TPUJob
reconciler, entry point) against the JAX package's: every test of
``tests/test_operator.py`` and the reconciler and scheduler cases of
``tests/test_prom.py`` and ``tests/test_tracing.py`` run on both packages
with their own assertions, and the two runs must admit, materialize,
restart, quarantine, stamp statuses, events and job traces, and count
metrics alike (``torch_control_parity`` says how the runs are recorded
and compared).  A worker pod differs only in what it asks of a node:
``nvidia.com/gpu`` and the port topology's selector."""

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

import kubeflow_tpu.operator.crd as jax_crd
import kubeflow_tpu.operator.main as jax_main
import kubeflow_tpu.operator.reconciler as jax_reconciler
import kubeflow_tpu_torch.operator.crd as port_crd
import kubeflow_tpu_torch.operator.main as port_main
import kubeflow_tpu_torch.operator.reconciler as port_reconciler
from kubeflow_tpu_torch.runtime import bootstrap
from torch_control_parity import (
    REPO,
    SLICE_MAP,
    assert_same,
    differential,
    jax_test_names,
    load_variants,
    map_slices,
)

# The port's pods ask for the H100 shape's GPUs a host (v5e-16's four
# chips a host map to h100-4x8's eight) and select GKE's H100 nodes.
PORT_REWRITES = [
    ('''        assert container["resources"]["limits"] == {"google.com/tpu": "4"}''',
     '''        assert container["resources"]["limits"] == {"nvidia.com/gpu": "8"}'''),
    ('''        assert sel["cloud.google.com/gke-tpu-accelerator"] == \\
            "tpu-v5-lite-podslice"''',
     '''        assert sel["cloud.google.com/gke-accelerator"] == \\
            "nvidia-h100-80gb"'''),
    ('''        assert "google.com/tpu" not in str(container["resources"])''',
     '''        assert "nvidia.com/gpu" not in str(container["resources"])'''),
]

OPERATOR = load_variants("test_operator.py", PORT_REWRITES)
OPERATOR_CASES = jax_test_names(OPERATOR["jax"])
PROM = load_variants("test_prom.py")
PROM_CASES = ["TestOperatorMetrics::test_fake_kube_run_exports_job_gauges",
              "TestLabelEscaping::test_gang_latency_histogram_recorded"]
TRACING = load_variants("test_tracing.py")
TRACING_CASES = [
    "TestJobLifecycleTraces::test_phase_spans_and_terminal_root",
    "TestJobLifecycleTraces::test_failed_job_always_retained",
    "TestJobLifecycleTraces::test_scheduler_plan_span_recorded"]


def test_every_jax_operator_test_is_a_case():
    assert len(OPERATOR_CASES) == 24
    assert OPERATOR_CASES == jax_test_names(OPERATOR["port"])
    names = set(jax_test_names(PROM["jax"])) | set(
        jax_test_names(TRACING["jax"]))
    assert set(PROM_CASES + TRACING_CASES) <= names


@pytest.mark.parametrize("case", OPERATOR_CASES)
def test_port_operates_as_jax(case, tmp_path, monkeypatch):
    assert_same(differential(OPERATOR, case, tmp_path, monkeypatch))


@pytest.mark.parametrize("case", PROM_CASES)
def test_port_exports_operator_metrics_as_jax(case, tmp_path, monkeypatch):
    assert_same(differential(PROM, case, tmp_path, monkeypatch))


@pytest.mark.parametrize("case", TRACING_CASES)
def test_port_traces_jobs_and_plans_as_jax(case, tmp_path, monkeypatch):
    """The job-lifecycle spans, the always-retained Failed trace and the
    ``scheduler.plan`` span, with the same names, tree and attributes."""
    assert_same(differential(TRACING, case, tmp_path, monkeypatch))


@pytest.mark.parametrize("jax_slice,num_slices", [
    ("v5e-16", 1), ("v5e-16", 2), ("v5p-32", 2), ("v5e-8", 3)])
def test_worker_pod_differs_from_jax_in_resources_and_selector_alone(
        jax_slice, num_slices):
    """A worker pod of the mapped shape asks for ``nvidia.com/gpu`` (the
    shape's GPUs a host) where the JAX pod asks for ``google.com/tpu``,
    selects GKE's H100 nodes, and keeps JAX's ``MEGASCALE_NUM_SLICES``
    and ``MEGASCALE_SLICE_ID`` on a multi-slice job (NCCL ignores them);
    everything else, the ``KFT_*`` env the port's bootstrap parses
    among it, is the JAX pod's."""
    port_slice = SLICE_MAP[jax_slice]
    jax_job = jax_crd.TPUJobSpec(name="j", slice_type=jax_slice,
                                 num_slices=num_slices)
    port_job = port_crd.TPUJobSpec(name="j", slice_type=port_slice,
                                   num_slices=num_slices)
    assert port_job.num_workers == jax_job.num_workers
    last = port_job.num_workers - 1
    jax_pod = jax_reconciler.build_worker_pod(jax_job, last, ["node-x"])
    pod = port_reconciler.build_worker_pod(port_job, last, ["node-x"])
    gpus = str(port_job.topology.chips_per_host)
    container = pod["spec"]["containers"][0]
    assert container["resources"] == {
        "limits": {"nvidia.com/gpu": gpus},
        "requests": {"nvidia.com/gpu": gpus}}
    assert pod["spec"]["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    env = {e["name"]: e["value"] for e in container["env"]}
    if num_slices > 1:
        assert env["MEGASCALE_NUM_SLICES"] == str(num_slices)
        assert env["MEGASCALE_SLICE_ID"] == str(num_slices - 1)
    else:
        assert "MEGASCALE_NUM_SLICES" not in env
    wenv = bootstrap.worker_env(env)
    assert (wenv.process_id, wenv.num_processes, wenv.slice_type) == (
        last, port_job.num_workers, port_slice)
    for p in (pod, jax_pod):
        del p["spec"]["containers"][0]["resources"]
        del p["spec"]["nodeSelector"]
    assert pod == json.loads(map_slices(json.dumps(jax_pod)))


def _parsed_flags(main_mod, argv, monkeypatch):
    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen.update(vars(argparse.ArgumentParser.parse_known_args(
            self, args, namespace)[0]))
        raise SystemExit(0)
    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(SystemExit):
            main_mod.main(argv)
    return seen


def test_operator_main_flags_match_jax(monkeypatch):
    """The entry point takes JAX's flags with JAX's defaults, but for
    the default inventory: the port's GPU shapes."""
    jax_flags = _parsed_flags(jax_main, [], monkeypatch)
    port_flags = _parsed_flags(port_main, [], monkeypatch)
    assert set(port_flags) == set(jax_flags)
    assert {k for k in jax_flags if port_flags[k] != jax_flags[k]} == {
        "inventory"}
    assert port_flags["inventory"] == ["h100-8=4", "cpu-1=4"]
    assert port_main.parse_inventory(port_flags["inventory"]) == {
        "h100-8": 4, "cpu-1": 4}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env.pop("KFT_FAULTS", None)
    return env


def test_operator_main_runs_as_a_process():
    """``python -m kubeflow_tpu_torch.operator.main --fake-kube
    --max-iterations 2`` reconciles twice against the in-memory cluster
    with the default GPU inventory and the scheduler on, and exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.operator.main",
         "--fake-kube", "--max-iterations", "2", "--poll-interval-s", "0"],
        cwd=str(REPO), env=_env(), stdin=subprocess.DEVNULL,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "operator up; inventory={'h100-8': 4, 'cpu-1': 4} " \
        "scheduler=on" in proc.stderr


def test_operator_main_serves_queue_and_traces_from_its_config(tmp_path):
    """``--controller-config-file`` (JAX's keys ``inventory`` and
    ``scheduler``) sets the inventory and the policy; ``--metrics-port``
    serves /metrics, the scheduler's /queue and /debug/traces while the
    loop runs."""
    cfg = tmp_path / "controller.json"
    cfg.write_text(json.dumps({
        "inventory": {"h100-8": 2, "cpu-2": 1},
        "scheduler": {"quotas": {"team-a": {"h100-8": 8}},
                      "preemption": {"grace_period_s": 12.5}}}))
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.operator.main",
         "--fake-kube", "--controller-config-file", str(cfg),
         "--metrics-port", str(port), "--trace-sample-rate", "1",
         "--poll-interval-s", "0.05", "--max-iterations", "2000"],
        cwd=str(REPO), env=_env(), stdin=subprocess.DEVNULL,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.read().decode()
        deadline = time.monotonic() + 60
        while True:
            try:
                queue = json.loads(get("/queue"))
                break
            except OSError:
                assert time.monotonic() < deadline, "no /queue answer"
                assert proc.poll() is None, proc.stderr.read()
                time.sleep(0.1)
        assert queue["quotas"] == [{"tenant": "team-a",
                                    "slice_type": "h100-8",
                                    "used_chips": 0, "quota_chips": 8}]
        assert queue["pool"]["capacity_chips"] == 2 * 8 + 2
        assert "kft_operator_reconcile_passes_total" in get("/metrics")
        traces = json.loads(get("/debug/traces"))
        assert traces["enabled"] is True
        assert "scheduler.plan" in {t["root"] for t in traces["traces"]}
    finally:
        proc.kill()
        proc.wait(30)
        proc.stderr.close()
