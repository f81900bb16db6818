"""The port's CLI (kubeflow_tpu_torch.tools.cli): the twins of
tests/test_cli.py, the full ks-heir verb flow, including teardown.

The reference lifecycle was ``ks init/generate/param set/show/apply``
ending with ``ks delete`` (user_guide.md:366-410); every verb here runs
against a real app-state file in a tmpdir, with kubectl faked at the
subprocess boundary for the apply/delete hops.
"""

import json

import pytest
import torch
import yaml

from kubeflow_tpu_torch.tools import cli

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)


@pytest.fixture()
def app_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "tpuflow.json")
    assert cli.main(["--app-file", path, "init",
                     "--namespace", "kubeflow"]) == 0
    assert cli.main(["--app-file", path, "generate",
                     "kubeflow-core", "core"]) == 0
    return path


def _fake_kubectl(monkeypatch, calls):
    class Proc:
        returncode = 0

    def run(cmd, input=None, **kw):
        calls.append((cmd, input))
        return Proc()

    monkeypatch.setattr(cli.subprocess, "run", run)


def test_workflow_state_is_inspectable(app_file):
    state = json.load(open(app_file))
    assert state["namespace"] == "kubeflow"
    assert state["components"][0]["prototype"] == "kubeflow-core"


def test_show_renders_yaml(app_file, capsys):
    assert cli.main(["--app-file", app_file, "show"]) == 0
    docs = list(yaml.safe_load_all(capsys.readouterr().out))
    assert any(d.get("kind") == "Deployment" for d in docs if d)


def test_delete_dry_run_prints_what_would_go(app_file, capsys):
    assert cli.main(["--app-file", app_file, "delete", "--dry-run"]) == 0
    docs = [d for d in yaml.safe_load_all(capsys.readouterr().out) if d]
    assert docs, "delete --dry-run must render the teardown set"
    # The app state survives teardown (delete is a cluster op, not an
    # app edit — the ks contract).
    assert json.load(open(app_file))["components"]


def test_delete_pipes_manifests_to_kubectl_delete(
        app_file, monkeypatch):
    calls = []
    _fake_kubectl(monkeypatch, calls)
    assert cli.main(["--app-file", app_file, "delete"]) == 0
    (cmd, manifest), = calls
    assert cmd[:3] == ["kubectl", "delete", "--ignore-not-found"]
    docs = [d for d in yaml.safe_load_all(manifest.decode()) if d]
    assert any(d.get("kind") == "Deployment" for d in docs)


def test_delete_single_component_only(app_file, monkeypatch):
    assert cli.main(["--app-file", app_file, "generate",
                     "tensorboard", "tb"]) == 0
    calls = []
    _fake_kubectl(monkeypatch, calls)
    assert cli.main(["--app-file", app_file, "delete", "tb"]) == 0
    (_, manifest), = calls
    # Only tb's manifests in the teardown set: core's gateway must not
    # be swept away by deleting an unrelated component.
    assert b"tensorboard" in manifest
    # (tb's Service still carries a getambassador.io route annotation;
    # what must be absent is core's ambassador Deployment itself.)
    assert b"name: ambassador" not in manifest


def test_delete_unknown_component_errors(app_file, capsys):
    assert cli.main(["--app-file", app_file, "delete", "nope"]) == 2
    assert "no component named" in capsys.readouterr().err


def test_apply_then_delete_round_trip(app_file, monkeypatch):
    """The full lifecycle: what apply ships, delete tears down —
    byte-identical manifest sets on both hops."""
    calls = []
    _fake_kubectl(monkeypatch, calls)
    assert cli.main(["--app-file", app_file, "apply"]) == 0
    assert cli.main(["--app-file", app_file, "delete"]) == 0
    (apply_cmd, applied), (delete_cmd, deleted) = calls
    assert apply_cmd[:2] == ["kubectl", "apply"]
    assert applied == deleted


def test_queue_status_renders_scheduler_table(capsys):
    """`kubeflow-tpu-torch queue status` prints the operator scheduler's
    live queue/quota view (GET /queue on the metrics port)."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    payload = {
        "jobs": [
            {"job": "kubeflow/train-a", "tenant": "prod",
             "priority": "high", "slices": "2xh100-8", "chips": 16,
             "state": "Admitted", "detail": "", "position": None,
             "wait_s": None, "resumable": False, "preemptions": 0},
            {"job": "kubeflow/batch-7", "tenant": "batch",
             "priority": "low", "slices": "1xh100-8", "chips": 8,
             "state": "QuotaExceeded",
             "detail": "tenant 'batch' at 16/16 chips of h100-8",
             "position": 0, "wait_s": 12.5, "resumable": True,
             "preemptions": 1},
            {"job": "kubeflow/sweep-3", "tenant": "batch",
             "priority": "low", "slices": "1xh100-8", "chips": 2.0,
             "state": "Admitted", "detail": "", "position": None,
             "wait_s": None, "resumable": False, "preemptions": 0,
             "members": 4},
            {"job": "kubeflow/serving-lm", "kind": "serving-claim",
             "tenant": "fleet", "priority": "high",
             "slices": "2xh100-8", "chips": 16, "state": "Admitted",
             "detail": "", "position": None, "wait_s": None,
             "resumable": False, "preemptions": 0},
        ],
        "quotas": [{"tenant": "batch", "slice_type": "h100-8",
                    "used_chips": 16, "quota_chips": 16}],
        "queue_wait": {"p50": 3.2, "p99": 41.0},
        "counters": {"admitted": 9, "backfilled": 2, "preempted": 1,
                     "resumed": 1},
        "preemptions_in_window": 1,
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            assert self.path == "/queue"
            data = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        rc = cli.main([
            "queue", "status", "--operator",
            f"http://127.0.0.1:{httpd.server_address[1]}"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "kubeflow/train-a" in out and "Admitted" in out
        assert "MEMBERS" in out
        # KIND column (§5.13): rows without a kind are training jobs
        # from pre-colocation operators; serving claims are labeled.
        assert "KIND" in out
        # The fused member row bills its SHARE of the gang slice and
        # shows the gang width; singletons render "-".
        sweep = next(ln for ln in out.splitlines()
                     if "kubeflow/sweep-3" in ln)
        assert sweep.split()[1] == "train"
        assert sweep.split()[5:7] == ["2", "4"]
        solo = next(ln for ln in out.splitlines()
                    if "kubeflow/train-a" in ln)
        assert solo.split()[5:7] == ["16", "-"]
        claim = next(ln for ln in out.splitlines()
                     if "kubeflow/serving-lm" in ln)
        assert claim.split()[1:4] == ["serving-claim", "fleet", "high"]
        # The resumable queued job is marked: it restarts from its
        # checkpoint, not step 0.
        assert "QuotaExceeded*" in out
        assert "quota batch/h100-8: 16/16 chips" in out
        assert "preempted=1" in out and "backfilled=2" in out
    finally:
        httpd.shutdown()


def test_fleet_status_renders_endpoint_table(capsys):
    """`kubeflow-tpu-torch fleet status` prints the router's live replica
    table (GET /fleet/endpoints)."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    rows = [{"name": "srv-0", "url": "http://10.0.0.5:8000",
             "state": "routable", "tier": "prefill",
             "inflight": 3.0, "queue_depth": 1.0,
             "local_inflight": 0, "breaker_failures": 0,
             "breaker_state": "closed"},
            {"name": "srv-1", "url": "http://10.0.0.6:8000",
             "state": "ejected", "tier": "decode",
             "inflight": 0.0, "queue_depth": 0.0,
             "local_inflight": 0, "breaker_failures": 4,
             "breaker_state": "half_open"}]
    payload = {"endpoints": rows,
               "retry_budget": {"tokens": 7.4, "cap": 10.0},
               "max_replays": 2,
               "pool": {"capacity_chips": 32, "used_chips": 24,
                        "free_chips": 8, "serving_chips": 8,
                        "training_chips": 16}}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            data = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        rc = cli.main([
            "fleet", "status", "--router",
            f"http://127.0.0.1:{httpd.server_address[1]}"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "BREAKER" in out
        # Disaggregation tier column (§5.9): the role each replica
        # advertises on /readyz, probed by the router's registry.
        assert "TIER" in out
        assert "srv-0" in out and "routable" in out and "closed" in out
        assert "prefill" in out and "decode" in out
        assert "srv-1" in out and "ejected" in out \
            and "half_open" in out
        # Router-wide failover budget footer.
        assert "retry budget: 7.4/10 tokens" in out
        assert "replay cap 2" in out
        # Combined train/serve pool footer (§5.13) — only reported by
        # colocation-mode routers.
        assert "pool: 24/32 chips used" in out
        assert "(8 serving, 16 training, 8 free)" in out
    finally:
        httpd.shutdown()


def test_fleet_status_accepts_legacy_list_payload(capsys):
    """Routers predating the budget wrapper answer a bare endpoint
    list; the CLI renders it without the footer."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    rows = [{"name": "srv-0", "url": "http://10.0.0.5:8000",
             "state": "routable", "inflight": 0.0, "queue_depth": 0.0,
             "local_inflight": 0, "breaker_failures": 0}]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            data = json.dumps(rows).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        rc = cli.main([
            "fleet", "status", "--router",
            f"http://127.0.0.1:{httpd.server_address[1]}"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "srv-0" in out
        assert "retry budget" not in out
    finally:
        httpd.shutdown()


def _trace_payload():
    """A two-trace /debug/traces payload: one healthy proxied request
    with the full router->server->engine span chain, one errored."""
    ok_spans = [
        {"trace_id": "aa" * 16, "span_id": "01" * 8, "parent_id": None,
         "name": "router.request", "start_s": 100.0,
         "duration_ms": 25.0, "status": "ok",
         "attrs": {"path": "/model/lm:predict"}},
        {"trace_id": "aa" * 16, "span_id": "02" * 8,
         "parent_id": "01" * 8, "name": "router.forward",
         "start_s": 100.001, "duration_ms": 24.0, "status": "ok",
         "attrs": {"replica": "srv-0"}},
        {"trace_id": "aa" * 16, "span_id": "03" * 8,
         "parent_id": "02" * 8, "name": "server.predict",
         "start_s": 100.002, "duration_ms": 23.0, "status": "ok",
         "attrs": {"model": "lm"}},
        {"trace_id": "aa" * 16, "span_id": "04" * 8,
         "parent_id": "03" * 8, "name": "engine.decode",
         "start_s": 100.01, "duration_ms": 20.0, "status": "ok",
         "attrs": {"tokens": 16}},
    ]
    err_spans = [
        {"trace_id": "bb" * 16, "span_id": "05" * 8, "parent_id": None,
         "name": "router.request", "start_s": 101.0,
         "duration_ms": 120.0, "status": "deadline_exceeded",
         "attrs": {}},
    ]
    return {
        "enabled": True, "capacity": 128, "sample_rate": 0.05,
        "open_traces": 0,
        "traces": [
            {"trace_id": "bb" * 16, "root": "router.request",
             "status": "deadline_exceeded", "retained": "error",
             "duration_ms": 120.0, "spans": err_spans},
            {"trace_id": "aa" * 16, "root": "router.request",
             "status": "ok", "retained": "sampled",
             "duration_ms": 25.0, "spans": ok_spans},
        ],
    }


def _serve_traces(payload):
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            assert self.path == "/debug/traces"
            data = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def test_trace_list_renders_table(capsys):
    """`kubeflow-tpu-torch trace list` prints the retained traces of any
    /debug/traces server (model server, router, or operator)."""
    httpd = _serve_traces(_trace_payload())
    try:
        rc = cli.main([
            "trace", "list", "--target",
            f"http://127.0.0.1:{httpd.server_address[1]}"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "aa" * 16 in out and "bb" * 16 in out
        assert "deadline_exceeded" in out and "error" in out
        assert "router.request" in out
    finally:
        httpd.shutdown()


def test_trace_show_renders_span_tree(capsys):
    """`kubeflow-tpu-torch trace show <id>` renders the span tree with
    durations; a unique id prefix resolves."""
    httpd = _serve_traces(_trace_payload())
    try:
        rc = cli.main([
            "trace", "show", "aaaa", "--target",
            f"http://127.0.0.1:{httpd.server_address[1]}"])
        assert rc == 0
        out = capsys.readouterr().out
        lines = out.splitlines()
        assert lines[0].startswith(f"trace {'aa' * 16}")
        assert "kept_by=sampled" in lines[0]
        # Tree order and nesting: each hop indents under its parent.
        idx = {name: next(i for i, ln in enumerate(lines)
                          if name in ln)
               for name in ("router.request", "router.forward",
                            "server.predict", "engine.decode")}
        assert idx["router.request"] < idx["router.forward"] \
            < idx["server.predict"] < idx["engine.decode"]
        fwd = lines[idx["router.forward"]]
        srv = lines[idx["server.predict"]]
        assert len(srv) - len(srv.lstrip()) \
            > len(fwd) - len(fwd.lstrip())
        assert "replica=srv-0" in out and "tokens=16" in out
        assert "25.0ms" in out
    finally:
        httpd.shutdown()


def test_trace_show_unknown_id_errors(capsys):
    httpd = _serve_traces(_trace_payload())
    try:
        rc = cli.main([
            "trace", "show", "ffff", "--target",
            f"http://127.0.0.1:{httpd.server_address[1]}"])
        assert rc == 1
        assert "no retained trace" in capsys.readouterr().err
    finally:
        httpd.shutdown()


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    """Three saved steps with the newest one corrupted on disk."""
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager

    d = tmp_path_factory.mktemp("ckpt")
    with CheckpointManager(d, max_to_keep=5) as mgr:
        for step in range(3):
            mgr.save(step, {"w": torch.arange(4, dtype=torch.float32) + step})
    victim = max((p for p in (d / "2").rglob("*") if p.is_file()),
                 key=lambda p: p.stat().st_size)
    victim.write_bytes(victim.read_bytes()[:4])
    return d


def test_checkpoints_list_renders_verdicts(checkpoint_dir, capsys):
    rc = cli.main(["checkpoints", "list", str(checkpoint_dir)])
    out = capsys.readouterr().out
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].split() == ["STEP", "STATUS", "FILES", "SIZE_MB",
                                "DETAIL"]
    by_step = {ln.split()[0]: ln for ln in lines[1:]}
    assert "verified" in by_step["0"]
    assert "verified" in by_step["1"]
    assert "resumes here" in by_step["1"]  # newest verified marked
    assert "corrupt" in by_step["2"]


def test_checkpoints_verify_exit_codes(checkpoint_dir, capsys):
    # Mixed: some steps corrupt but walk-back recovers -> exit 2.
    rc = cli.main(["checkpoints", "verify", str(checkpoint_dir)])
    out = capsys.readouterr().out
    assert rc == 2
    assert "step 2: FAIL" in out
    assert "newest verified step: 1" in out


def test_checkpoints_verify_all_clean(tmp_path, capsys):
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager

    with CheckpointManager(tmp_path / "ok") as mgr:
        mgr.save(0, {"w": torch.ones(2)})
    rc = cli.main(["checkpoints", "verify", str(tmp_path / "ok")])
    out = capsys.readouterr().out
    assert rc == 0 and "step 0: OK" in out


def test_checkpoints_verify_nothing_restorable(tmp_path, capsys):
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager

    with CheckpointManager(tmp_path / "bad") as mgr:
        mgr.save(0, {"w": torch.ones(2)})
    # Manifested but corrupt: walk-back skips it, nothing else exists.
    victim = max((p for p in (tmp_path / "bad" / "0").rglob("*")
                  if p.is_file()), key=lambda p: p.stat().st_size)
    victim.write_bytes(victim.read_bytes()[:4])
    rc = cli.main(["checkpoints", "verify", str(tmp_path / "bad")])
    out = capsys.readouterr().out
    assert rc == 1 and "no restorable steps" in out


def test_checkpoints_legacy_dir_is_a_restore_candidate(tmp_path,
                                                       capsys):
    """A pre-manifest directory is what restore_or_init says it is:
    restorable — the CLI must not tell the operator to throw it away
    (rc 1); it reports legacy candidates and exits 2."""
    from kubeflow_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
        manifest_path,
    )

    with CheckpointManager(tmp_path / "old", max_to_keep=5) as mgr:
        for step in range(2):
            mgr.save(step, {"w": torch.ones(2)})
    for step in range(2):
        manifest_path(tmp_path / "old", step).unlink()
    rc = cli.main(["checkpoints", "verify", str(tmp_path / "old")])
    out = capsys.readouterr().out
    assert rc == 2, out
    assert "legacy" in out and "newest: 1" in out
    rc = cli.main(["checkpoints", "list", str(tmp_path / "old")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "resumes here (legacy, no manifest)" in out


def test_checkpoints_list_empty_dir(tmp_path, capsys):
    rc = cli.main(["checkpoints", "list", str(tmp_path)])
    assert rc == 0
    assert "no checkpoint steps" in capsys.readouterr().out


def test_checkpoints_list_fused_member_layout(tmp_path, capsys):
    """A fused-gang checkpoint root (runtime/hfta.py: per-member
    subdirectories, no steps at the root) renders one verdict table
    per member."""
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager

    root = tmp_path / "fused"
    for name in ("m0", "m1"):
        with CheckpointManager(root / name, max_to_keep=3) as mgr:
            mgr.save(4, {"w": torch.arange(4, dtype=torch.float32)})
    rc = cli.main(["checkpoints", "list", str(root)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "member m0:" in out and "member m1:" in out
    assert out.count("resumes here") == 2
    assert out.count("verified") == 2


def test_status_verbs_read_the_ports_own_endpoints(capsys, monkeypatch):
    """``queue status``, ``fleet status`` and ``trace list`` against the
    port's own servers: the operator's metrics port serving its
    ClusterScheduler's ``/queue`` and the FleetRouter's
    ``/fleet/endpoints`` and ``/debug/traces``."""
    from kubeflow_tpu_torch.operator.gang import GangScheduler
    from kubeflow_tpu_torch.runtime import tracing
    from kubeflow_tpu_torch.runtime.prom import serve_metrics
    from kubeflow_tpu_torch.scheduler import ClusterScheduler, SchedulerConfig
    from kubeflow_tpu_torch.testing import e2e

    cluster = ClusterScheduler(GangScheduler({"h100-8": 2}),
                               SchedulerConfig())
    httpd, _ = serve_metrics(0, host="127.0.0.1",
                             json_routes={"/queue": cluster.status})
    try:
        assert cli.main(["queue", "status", "--operator",
                         f"http://127.0.0.1:{httpd.server_address[1]}"]) == 0
        out = capsys.readouterr().out
        assert "queue empty: no live TPUJobs" in out
        assert "admitted=0" in out
    finally:
        httpd.shutdown()
        httpd.server_close()
    monkeypatch.setattr(tracing, "_STORE", None)
    registry = e2e.static_registry([1], names=["srv-a"])
    registry.refresh()  # one discovery and probe pass, no loop thread
    router, router_httpd = e2e.start_router(registry)
    try:
        url = f"http://127.0.0.1:{router_httpd.server_address[1]}"
        assert cli.main(["fleet", "status", "--router", url]) == 0
        out = capsys.readouterr().out
        assert out.splitlines()[0].split()[:2] == ["ENDPOINT", "STATE"]
        assert out.splitlines()[1].split()[0] == "srv-a"
        assert "retry budget:" in out
        assert cli.main(["trace", "list", "--target", url]) == 0
        assert capsys.readouterr().out == \
            "tracing disabled on this server\n"
        # The trace store is process-wide: a fresh one holds nothing
        # (monkeypatch restores whatever store was there before).
        tracing.enable(sample_rate=1.0, capacity=8)
        assert cli.main(["trace", "list", "--target", url]) == 0
        assert capsys.readouterr().out == \
            "no retained traces (tail sampling kept nothing yet)\n"
    finally:
        e2e.close_fleet(router, router_httpd)
