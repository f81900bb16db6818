"""Worker process bootstrap: the single-process part of the JAX package's
kubeflow_tpu/runtime/bootstrap.py, copied (host-only).

The operator injects the same ``KFT_*`` variables into every worker pod,
and ``worker_env`` parses them into the same ``WorkerEnv`` fields.  A job
of one process needs no rendezvous; more than one raises
``NotPortedError`` until the NCCL bootstrap lands (ROADMAP queue 1,
item 11).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import socket
from typing import Optional

from kubeflow_tpu_torch import NotPortedError

log = logging.getLogger(__name__)

# Env contract injected by the operator (manifests/tpujob.py) into every
# worker pod.
ENV_COORDINATOR = "KFT_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KFT_NUM_PROCESSES"
ENV_PROCESS_ID = "KFT_PROCESS_ID"
ENV_JOB_NAME = "KFT_JOB_NAME"
ENV_SLICE_TYPE = "KFT_SLICE_TYPE"

_ORDINAL_RE = re.compile(r"-(\d+)$")


@dataclasses.dataclass(frozen=True)
class WorkerEnv:
    """Resolved distributed identity of this worker process."""

    coordinator_address: Optional[str]
    num_processes: int
    process_id: int
    job_name: str = ""
    slice_type: str = ""

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def pod_ordinal(hostname: Optional[str] = None) -> int:
    """The process index from the pod's StatefulSet ordinal:
    ``myjob-worker-3`` -> 3; 0 for a name without one."""
    name = hostname if hostname is not None else socket.gethostname()
    m = _ORDINAL_RE.search(name)
    return int(m.group(1)) if m else 0


def worker_env(environ: Optional[dict] = None) -> WorkerEnv:
    """Parse the distributed contract from the environment.

    Precedence: explicit KFT_PROCESS_ID beats the hostname ordinal, so
    non-StatefulSet deployments (bare pods, local runs) still work.
    """
    env = os.environ if environ is None else environ
    num = int(env.get(ENV_NUM_PROCESSES, "1"))
    pid_raw = env.get(ENV_PROCESS_ID)
    pid = int(pid_raw) if pid_raw is not None else pod_ordinal()
    coord = env.get(ENV_COORDINATOR)
    if coord is None and num > 1:
        raise RuntimeError(
            f"{ENV_NUM_PROCESSES}={num} but {ENV_COORDINATOR} unset; the "
            "operator must inject the headless-Service coordinator address"
        )
    if not 0 <= pid < num:
        raise RuntimeError(f"process_id {pid} out of range for {num} processes")
    return WorkerEnv(
        coordinator_address=coord,
        num_processes=num,
        process_id=pid,
        job_name=env.get(ENV_JOB_NAME, ""),
        slice_type=env.get(ENV_SLICE_TYPE, ""),
    )


def initialize(env: Optional[WorkerEnv] = None) -> WorkerEnv:
    """Resolve this worker's identity.  A single-process job needs no
    rendezvous; a multi-process one raises ``NotPortedError``."""
    env = env or worker_env()
    if env.is_distributed:
        raise NotPortedError(
            f"multi-process training ({env.num_processes} processes) is not "
            "ported yet: the NCCL bootstrap is ROADMAP queue 1, item 11")
    log.info("single-process job; no rendezvous")
    return env
