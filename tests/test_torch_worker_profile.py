"""The port's torch worker profile (the twin of tests/test_torch_worker.py,
which tests the JAX package's ``manifests/torch.py`` profile): the
``torch-xla-job`` manifest the port renders is not write-only; its
worker command drives a real CUDA-or-CPU torch training process
(``kubeflow_tpu_torch.tools.train_torch``) through the ``KFT_*`` gang
contract."""

import os
import subprocess
import sys

import pytest
import torch

import kubeflow_tpu_torch.manifests  # noqa: F401 — registers prototypes
from kubeflow_tpu_torch.config import default_registry
from kubeflow_tpu_torch.runtime.bootstrap import WorkerEnv, torch_dist_env
from kubeflow_tpu_torch.tools.train_torch import main

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

WORKER = ["python", "-m", "kubeflow_tpu_torch.tools.train_torch"]
FLAGS = ["--steps", "3", "--batch-size", "4", "--features", "2",
         "--device", "cpu"]


def _worker(args):
    (cr,) = default_registry.generate(
        "torch-xla-job", "torch-smoke", slice_type="cpu-2",
        command=",".join(WORKER), args=",".join(args))
    return cr["spec"]["worker"]


class TestDistEnvContract:
    def test_kft_to_torch_env(self):
        env = WorkerEnv(coordinator_address="job-worker-0.job.ns:12355",
                        num_processes=4, process_id=2, job_name="job")
        out = torch_dist_env(env)
        assert out == {
            "RANK": "2", "WORLD_SIZE": "4",
            "MASTER_ADDR": "job-worker-0.job.ns",
            "MASTER_PORT": "12355",
        }

    def test_single_process_defaults(self):
        env = WorkerEnv(coordinator_address=None, num_processes=1,
                        process_id=0)
        out = torch_dist_env(env)
        assert out["MASTER_ADDR"] == "127.0.0.1"
        assert out["WORLD_SIZE"] == "1"


class TestExecutedWorker:
    def test_single_process_trains(self):
        """The rendered worker's args run the port's trainer as given."""
        worker = _worker(FLAGS)
        assert worker["command"] == WORKER
        assert not worker.get("env")  # no torch_xla env on a CUDA worker
        assert main(worker["args"]) == 0

    @pytest.mark.slow  # two-process gloo spin-up; single-process stays tier-1
    def test_two_process_gloo_gang(self):
        """Two processes started from the rendered worker rendezvous over
        the KFT contract and take DDP-averaged steps."""
        worker = _worker(["--steps", "2", "--batch-size", "4",
                          "--features", "2", "--device", "cpu"])
        procs = []
        for rank in range(2):
            env = dict(
                os.environ, **worker.get("env", {}),
                KFT_COORDINATOR_ADDRESS="127.0.0.1:29513",
                KFT_NUM_PROCESSES="2",
                KFT_PROCESS_ID=str(rank),
                KFT_JOB_NAME="torch-smoke",
            )
            procs.append(subprocess.Popen(
                [sys.executable] + worker["command"][1:] + worker["args"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            ))
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()[-2000:]
