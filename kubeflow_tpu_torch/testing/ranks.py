"""Start a job of several processes on this host, as the operator starts a
gang: each process gets the ``KFT_*`` variables (runtime/bootstrap.py)
with a coordinator on a free local port, and the job is joined with a
timeout, so a rank that hangs fails the job instead of blocking its
caller.  The multi-process tests and ``chip_smoke.py`` start their ranks
with it.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: Optional[int]  # None: killed at the timeout
    stdout: str
    stderr: str


def free_port() -> int:
    """A port no one listens on now (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: Sequence[str], world: int, *, timeout_s: float,
              cwd: Optional[str] = None,
              env: Optional[Dict[str, str]] = None,
              threads: Optional[int] = None) -> List[RankResult]:
    """Run ``python argv...`` as ranks 0..world-1 of one job and wait for
    all of them, at most ``timeout_s`` in all; ranks still running then
    are killed (their ``returncode`` is None).  ``cwd`` is the ranks'
    working directory (the caller's by default).  ``threads`` caps each
    rank's intra-op threads (``OMP_NUM_THREADS``): ranks that share a
    host's cores run their CPU collectives far faster one thread each.
    Output is kept in temporary files, so a chatty rank cannot block on
    a full pipe."""
    coordinator = f"127.0.0.1:{free_port()}"
    logdir = tempfile.TemporaryDirectory(prefix="kft-ranks-")
    root = Path(logdir.name)
    procs = []
    logs = []
    for rank in range(world):
        child = dict(os.environ if env is None else env)
        child.update({"KFT_NUM_PROCESSES": str(world),
                      "KFT_PROCESS_ID": str(rank),
                      "KFT_COORDINATOR_ADDRESS": coordinator,
                      "PYTHONUNBUFFERED": "1"})
        if threads is not None:
            child["OMP_NUM_THREADS"] = str(threads)
        out = open(root / f"rank{rank}.out", "w+")
        err = open(root / f"rank{rank}.err", "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=cwd, env=child,
            stdout=out, stderr=err, stdin=subprocess.DEVNULL))
    deadline = time.monotonic() + timeout_s
    codes: List[Optional[int]] = []
    for proc in procs:
        try:
            codes.append(proc.wait(max(0.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    results = []
    for rank, ((out, err), code) in enumerate(zip(logs, codes)):
        texts = []
        for f in (out, err):
            f.seek(0)
            texts.append(f.read())
            f.close()
        results.append(RankResult(rank, code, *texts))
    logdir.cleanup()
    return results


def check_ranks(results: List[RankResult]) -> None:
    """Raise with every failed rank's output unless all exited 0."""
    bad = [r for r in results if r.returncode != 0]
    if bad:
        raise RuntimeError("; ".join(
            f"rank {r.rank} " + ("timed out" if r.returncode is None else
                                 f"exited {r.returncode}")
            + f": {r.stderr[-3000:]}" for r in bad))
