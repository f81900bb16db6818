"""The port's profiling (kubeflow_tpu_torch/runtime/profiling.py, on
torch.profiler) and its trace summarizer (tools/xplane_summary.py).

The twins of tests/test_profiling.py and test_tools_entrypoints.py's
profiling tests: ``trace`` writes a trace, ``ProfileSchedule`` captures
exactly its window, ``start_server`` returns its server object or warns
and returns None (a busy port, a platform that refuses it) and serves
an on-demand capture.  The summarizer is held to a synthetic trace of
two CUDA streams whose kernels overlap and a copy under a kernel (busy
is their union; the copy is "overlapped") and to a real trace of this
CPU.  Nothing here starts a process."""

import json
import logging
import socket
import urllib.request

import pytest
import torch

from kubeflow_tpu_torch.runtime import profiling
from kubeflow_tpu_torch.tools import xplane_summary

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)


def _traces(logdir):
    return sorted(logdir.rglob("*.pt.trace.json"))


def _annotations(path):
    return {e["name"] for e in xplane_summary.load_events(path)
            if e.get("cat") == "user_annotation"}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = _traces(tmp_path)
    names = {e["name"] for e in xplane_summary.load_events(path)}
    assert "aten::matmul" in names


def test_schedule_captures_only_its_window(tmp_path):
    """``ProfileSchedule(start=1, count=2)`` over four steps: one trace,
    holding steps 1 and 2 and neither 0 nor 3."""
    sched = profiling.ProfileSchedule(str(tmp_path), start=1, count=2)
    for step in range(4):
        sched.before_step(step)
        with profiling.step_marker(step):
            torch.ones(4, 4) * step
        sched.after_step(step)
    sched.close()
    (path,) = _traces(tmp_path)
    steps = {n for n in _annotations(path) if n.startswith("train_step")}
    assert steps == {"train_step 1", "train_step 2"}


def test_schedule_close_ends_an_open_window(tmp_path):
    sched = profiling.ProfileSchedule(str(tmp_path), start=0, count=5)
    sched.before_step(0)
    with profiling.step_marker(0):
        torch.ones(4, 4) + 1
    sched.after_step(0)
    sched.close()
    (path,) = _traces(tmp_path)
    assert "train_step 0" in _annotations(path)
    sched.before_step(0)  # done: no second capture
    sched.close()
    assert len(_traces(tmp_path)) == 1


class TestStartServer:
    def test_returns_server_object_and_captures_on_demand(self, tmp_path):
        server = profiling.start_server(0)
        assert server is not None
        try:
            port = server.server_address[1]
            body = json.dumps({"logdir": str(tmp_path),
                               "duration_ms": 50}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{profiling.CAPTURE_PATH}",
                data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                answer = json.loads(resp.read())
            assert answer["trace"] == str(_traces(tmp_path)[0])
        finally:
            server.shutdown()
            server.server_close()

    def test_busy_port_warns_and_returns_none(self, caplog):
        with socket.socket() as taken:
            taken.bind(("127.0.0.1", 0))
            taken.listen()
            port = taken.getsockname()[1]
            with caplog.at_level(logging.WARNING,
                                 logger="kubeflow_tpu_torch.runtime."
                                        "profiling"):
                assert profiling.start_server(port) is None
        assert any("unavailable" in rec.message for rec in caplog.records)

    @pytest.mark.parametrize("exc", [
        RuntimeError("Address already in use"),
        NotImplementedError("profiler unavailable on this backend"),
    ])
    def test_failure_warns_and_returns_none(self, monkeypatch, caplog,
                                            exc):
        def fake_serve(port):
            raise exc

        monkeypatch.setattr(profiling, "_serve", fake_serve)
        with caplog.at_level(logging.WARNING,
                             logger="kubeflow_tpu_torch.runtime.profiling"):
            assert profiling.start_server(9876) is None
        assert any("unavailable" in rec.message
                   for rec in caplog.records)


# A synthetic device timeline (us): kernels on streams 7 and 8 that
# overlap, a copy under the first kernel, a set that overlaps none, a
# step annotation over everything, and host events that are not the
# device's.
_SYNTHETIC = [
    {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel<128>",
     "pid": 0, "tid": 7, "ts": 1000.0, "dur": 100.0,
     "args": {"device": 0, "stream": 7}},
    {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16",
     "pid": 0, "tid": 8, "ts": 1050.0, "dur": 100.0,
     "args": {"device": 0, "stream": 8}},
    {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel<128>",
     "pid": 0, "tid": 7, "ts": 1300.0, "dur": 40.0,
     "args": {"device": 0, "stream": 7}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> "
     "Device)", "pid": 0, "tid": 9, "ts": 1010.0, "dur": 20.0,
     "args": {"device": 0, "stream": 9}},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
     "pid": 0, "tid": 7, "ts": 1200.0, "dur": 10.0,
     "args": {"device": 0, "stream": 7}},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "train_step 1",
     "pid": 0, "tid": 7, "ts": 1000.0, "dur": 400.0,
     "args": {"device": 0}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 42,
     "tid": 42, "ts": 900.0, "dur": 500.0},
    {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
     "args": {"name": "GPU 0"}},
]


@pytest.fixture
def synthetic(tmp_path):
    path = tmp_path / "host_1.1.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": _SYNTHETIC}))
    return path


def test_busy_is_the_union_and_the_copy_is_overlapped(synthetic, capsys):
    """Busy = [1000, 1150) + [1200, 1210) + [1300, 1340): 0.200 ms, not
    the 0.250 ms sum; the copy under a kernel (0.020 ms) is reported
    apart; the annotation covers, it is not added."""
    (plane,) = xplane_summary.summarize_xplane(synthetic, top_n=5)
    out = capsys.readouterr().out
    assert plane.busy_ms == pytest.approx(0.200)
    assert "== GPU 0: busy (leaf ops) 0.200 ms" in out
    assert "0.020 ms  Memcpy HtoD" in out.split("-- overlapped")[1]
    assert plane.overlap == {"Memcpy HtoD (Pinned -> Device)": 0.02}
    assert plane.counts["flash_fwd_kernel<128>"] == 2
    assert plane.events("flash_fwd") == 2
    assert plane.ops["flash_fwd_kernel<128>"] == pytest.approx(0.140)
    assert plane.cats["hand-written (flash)"] == pytest.approx(0.140)
    assert plane.cats["matmul"] == pytest.approx(0.100)
    assert plane.containers == {"train_step 1": 0.4}
    assert "aten::mm" not in out
    assert xplane_summary.device_busy_ms(synthetic) == \
        pytest.approx(0.200)


def test_steps_divides_every_number(synthetic, capsys):
    assert xplane_summary.main([str(synthetic), "3", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "busy (leaf ops) 0.200 ms (0.100 ms/step x 2)" in out
    assert "    0.070 ms        1  flash_fwd_kernel<128>" in out
    assert "-- top 3 ops (ms, events) --" in out


def test_a_directory_means_its_newest_trace(synthetic, capsys):
    assert xplane_summary.device_busy_ms(synthetic.parent) == \
        pytest.approx(0.200)
    with pytest.raises(FileNotFoundError):
        xplane_summary.load_events(synthetic.parent / "empty")


def test_summarizes_a_real_cpu_trace(tmp_path, capsys):
    """A trace of this CPU has no device events: the table is over the
    host's ops by self time, and prints ``busy (leaf ops)``."""
    with profiling.trace(str(tmp_path)):
        with profiling.step_marker(0):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert xplane_summary.main([str(_traces(tmp_path)[0]), "5"]) == 0
    out = capsys.readouterr().out
    assert "== host (no device events): busy (leaf ops)" in out
    assert "aten::mm" in out
    assert "train_step 0" in out  # a container, not a leaf
    (plane,) = xplane_summary.summarize(tmp_path)
    # Self times: aten::matmul holds aten::mm, which does the work.
    assert plane.ops["aten::mm"] > plane.ops["aten::matmul"]
    assert plane.counts["aten::mm"] == 1
    # Equal but for the float64 rounding of microsecond timestamps near
    # 1e12 (about 3e-4 us an event).
    assert plane.busy_ms == pytest.approx(sum(plane.ops.values()),
                                          abs=1e-5)
