"""Worker process bootstrap: the port of kubeflow_tpu/runtime/bootstrap.py.

The operator injects the same ``KFT_*`` variables into every worker pod,
and ``worker_env`` parses them into the same ``WorkerEnv`` fields, with
the same precedence.  A job of one process needs no rendezvous (a mesh
in it starts its one-rank group itself, parallel/mesh.py).  A
multi-process job waits for the coordinator's DNS name, as the JAX
package does before ``jax.distributed.initialize``, maps ``KFT_*`` onto
torch.distributed's env contract (``torch_dist_env``, the port's own
copy of kubeflow_tpu/tools/train_torch.py's) and starts the process
group at that address, rank and world size (the process's environment
is left as it was): NCCL when the job runs on CUDA, gloo when the
caller asks for the CPU.  On CUDA each rank then runs on GPU ``LOCAL_RANK`` (torchrun's
variable) or, without it, ``process_id`` modulo the GPUs it sees, so
several processes on one card share GPU 0.  A job started by
``torchrun`` instead (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, no ``KFT_*``) is taken as it is.  A rendezvous that
fails raises; there is no single-process fallback.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import re
import socket
import time
from typing import TYPE_CHECKING, Dict, Optional

if TYPE_CHECKING:  # torch loads at initialize(): the operator reads the
    # env names here without it
    from kubeflow_tpu_torch.device import DeviceLike

log = logging.getLogger(__name__)

# Env contract injected by the operator (manifests/tpujob.py) into every
# worker pod.
ENV_COORDINATOR = "KFT_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KFT_NUM_PROCESSES"
ENV_PROCESS_ID = "KFT_PROCESS_ID"
ENV_JOB_NAME = "KFT_JOB_NAME"
ENV_SLICE_TYPE = "KFT_SLICE_TYPE"
# The port's own: the process group's backend when the default (NCCL on
# CUDA) will not do, as for several processes sharing one GPU ("gloo").
ENV_DIST_BACKEND = "KFT_DIST_BACKEND"

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


def torch_dist_env(env: WorkerEnv) -> Dict[str, str]:
    """KFT_* -> the torch.distributed env contract (MASTER_ADDR et al.):
    a copy of the JAX package's ``train_torch.torch_dist_env``."""
    out = {
        "RANK": str(env.process_id),
        "WORLD_SIZE": str(env.num_processes),
    }
    if env.coordinator_address:
        host, _, port = env.coordinator_address.partition(":")
        out["MASTER_ADDR"] = host
        out["MASTER_PORT"] = port or "12355"
    else:
        out["MASTER_ADDR"] = "127.0.0.1"
        out["MASTER_PORT"] = "12355"
    return out


def _torchrun_env(environ) -> Optional[WorkerEnv]:
    """The identity torchrun gives (RANK, WORLD_SIZE, MASTER_*), when it
    names more than one process."""
    if int(environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    return WorkerEnv(
        coordinator_address=(f"{environ.get('MASTER_ADDR', '127.0.0.1')}:"
                             f"{environ.get('MASTER_PORT', '12355')}"),
        num_processes=int(environ["WORLD_SIZE"]),
        process_id=int(environ.get("RANK", "0")))


def initialize(
    env: Optional[WorkerEnv] = None,
    *,
    device: DeviceLike = None,
    wait_coordinator_timeout_s: float = 300.0,
    timeout_s: float = 600.0,
) -> WorkerEnv:
    """Start this worker's process group.

    Single-process jobs are a no-op.  Multi-process jobs resolve the
    coordinator's DNS name first (pods of a gang come up in any order;
    300 s as in the JAX package), then join the process group on
    ``device``'s backend (NCCL on CUDA, the default; gloo on the CPU, or
    when ``KFT_DIST_BACKEND=gloo`` asks for it: several processes
    sharing one GPU, which NCCL refuses), whose collectives time out
    after ``timeout_s``."""
    if env is None:
        env = worker_env()
        if not env.is_distributed:
            env = _torchrun_env(os.environ) or env
    if not env.is_distributed:
        log.info("single-process job; no rendezvous")
        return env
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.device import resolve_device

    host = env.coordinator_address.rsplit(":", 1)[0]
    _wait_dns(host, wait_coordinator_timeout_s)
    contract = torch_dist_env(env)
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else
                              env.process_id % torch.cuda.device_count())
    dist.init_process_group(
        os.environ.get(ENV_DIST_BACKEND)
        or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=(f"tcp://{contract['MASTER_ADDR']}:"
                     f"{contract['MASTER_PORT']}"),
        rank=int(contract["RANK"]), world_size=int(contract["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("torch.distributed up (%s): process %d/%d",
             dist.get_backend(), env.process_id, env.num_processes)
    return env


def _wait_dns(host: str, timeout_s: float, poll_s: float = 2.0) -> None:
    """Wait for the coordinator hostname to resolve (the JAX package's
    ``_wait_dns``): the gang's stable names appear in DNS as its pods
    come up."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            socket.getaddrinfo(host, None)
            return
        except socket.gaierror:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"coordinator {host!r} did not resolve within {timeout_s}s"
                ) from None
            time.sleep(poll_s)
