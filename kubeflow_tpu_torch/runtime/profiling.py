"""Profiling: the port of kubeflow_tpu/runtime/profiling.py on
``torch.profiler``.

The JAX package captures XPlane traces with ``jax.profiler``; the port
captures ``torch.profiler`` traces: CPU ops, and on CUDA the device's
kernels, copies and sets (CUPTI).  Each capture is written as a Chrome
trace, ``<host>_<pid>.<id>.pt.trace.json``, under ``logdir``, where
TensorBoard's PyTorch profiler plugin (and ``tools/xplane_summary.py``)
read it.

Three entry points, as in the JAX package:
  - ``trace(logdir)``: context manager around a region of the loop;
  - ``ProfileSchedule``: capture steps [start, start+count) of a loop;
  - ``start_server(port)``: on-demand remote capture.  torch has no
    profiler service, so this is a small HTTP endpoint on the process:
    ``POST /capture`` with ``{"logdir": DIR, "duration_ms": N}`` traces
    every thread of the process (and the card) for N ms and answers the
    trace's path.  No overhead until a capture is asked for.

``step_marker(step)`` names a loop step on the timelines (a
``record_function`` range, ``train_step <step>``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import threading
from typing import Iterator, Optional

log = logging.getLogger(__name__)

CAPTURE_PATH = "/capture"
# The longest on-demand capture a request may ask for.
MAX_CAPTURE_MS = 60_000


def _profiler(logdir: str, all_threads: bool = False):
    """A ``torch.profiler.profile`` of the CPU (and CUDA when there is a
    card) that writes its Chrome trace under ``logdir`` when stopped."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig

        try:
            kw["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except TypeError:  # a torch without it: the capturing thread only
            log.warning("this torch profiles the capturing thread only")
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir), **kw)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a trace of the enclosed region into ``logdir`` (a Chrome
    trace; TensorBoard's PyTorch profiler plugin serves it)."""
    prof = _profiler(logdir)
    prof.start()
    try:
        yield
    finally:
        _synchronize()
        prof.stop()
        log.info("profiler trace written to %s", logdir)


def _synchronize() -> None:
    """Let the card finish what the traced region queued, so that its
    kernels fall inside the trace."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def step_marker(step: int):
    """Annotate the timelines with the loop's step: a named range
    (``train_step <step>``) on the CPU and, on CUDA, the device's."""
    from torch.profiler import record_function

    return record_function(f"train_step {step}")


def _handler_class(lock: threading.Lock):
    """The request handler class of ``start_server``'s endpoint; one
    capture at a time (``lock``)."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 -- http.server's name
            if self.path != CAPTURE_PATH:
                return self._answer(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                logdir = str(body["logdir"])
                duration_ms = float(body.get("duration_ms", 1000))
            except (KeyError, TypeError, ValueError) as exc:
                return self._answer(400, {"error": repr(exc)})
            if not 0 < duration_ms <= MAX_CAPTURE_MS:
                return self._answer(400, {
                    "error": f"duration_ms must be in (0, "
                             f"{MAX_CAPTURE_MS}]"})
            if not lock.acquire(blocking=False):
                return self._answer(409, {
                    "error": "a capture is running"})
            try:
                path = _capture(logdir, duration_ms / 1e3)
            finally:
                lock.release()
            self._answer(200, {"trace": path})

        def _answer(self, code, payload):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):
            log.debug("profiler server: " + fmt, *args)

    return Handler


def _capture(logdir: str, seconds: float) -> str:
    """Trace every thread of this process (and the card) for ``seconds``
    into ``logdir``; returns the trace file's path."""
    import pathlib
    import time

    before = set(pathlib.Path(logdir).glob("*.pt.trace.json")) \
        if pathlib.Path(logdir).is_dir() else set()
    prof = _profiler(logdir, all_threads=True)
    prof.start()
    try:
        time.sleep(seconds)
        _synchronize()
    finally:
        prof.stop()
    new = sorted(set(pathlib.Path(logdir).glob("*.pt.trace.json")) - before)
    log.info("on-demand capture of %.3f s -> %s", seconds, logdir)
    return str(new[-1]) if new else ""


def _serve(port: int):
    """The capture endpoint on ``port`` (0 = any free port), serving from
    a daemon thread; ``shutdown()`` stops it."""
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(
        ("127.0.0.1", port), _handler_class(threading.Lock()))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="profiler-server").start()
    return server


def start_server(port: int = 9999) -> Optional[object]:
    """Start the on-demand capture server (``POST /capture`` from another
    process; see the module's docstring).

    Returns the server object (``server_address`` names its port,
    ``shutdown()`` stops it), or None when the server could not start:
    the port is already bound, or the platform refuses it.  Degrading
    with a warning instead of raising is deliberate, as in the JAX
    package: the capture server is an observability sidecar, and a busy
    port must never take down the trainer or serving process it rides
    in."""
    try:
        server = _serve(port)
    except Exception as exc:  # port taken / platform without sockets
        log.warning("profiler server on :%d unavailable: %s",
                    port, exc)
        return None
    log.info("profiler server on :%d", server.server_address[1])
    return server


@dataclasses.dataclass
class ProfileSchedule:
    """Trace exactly steps [start, start+count) of a training loop.

    Usage:
        sched = ProfileSchedule(logdir, start=10, count=3)
        for i in range(steps):
            sched.before_step(i)
            ...
            sched.after_step(i)
    """

    logdir: str
    start: int = 10
    count: int = 3
    _active: bool = False
    _done: bool = False
    _prof: object = None

    def before_step(self, step: int) -> None:
        if (not self._done and not self._active and step == self.start):
            self._prof = _profiler(self.logdir)
            self._prof.start()
            self._active = True

    def after_step(self, step: int) -> None:
        if self._active and step >= self.start + self.count - 1:
            self._stop()
            log.info("profiled steps [%d, %d) -> %s",
                     self.start, self.start + self.count, self.logdir)

    def close(self) -> None:
        if self._active:
            self._stop()

    def _stop(self) -> None:
        _synchronize()
        self._prof.stop()
        self._prof = None
        self._active = False
        self._done = True
