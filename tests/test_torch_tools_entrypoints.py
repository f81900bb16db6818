"""The port's worker tools against the JAX package's: the launcher
(tools/launcher.py), the torch worker (tools/train_torch.py) and the
usage telemetry (tools/telemetry.py).

  - the launcher's exit codes on the same commands equal JAX's (the
    commands of tests/test_tools_entrypoints.py's launcher tests: a
    command that succeeds, one that exits 3, nothing to run, and an
    in-process entrypoint); both launchers run in this process, their
    commands are ``sh -c``;
  - ``torch_dist_env`` equals JAX's ``train_torch.torch_dist_env`` on the
    same ``WorkerEnv``;
  - the port's ``train_torch`` on the CPU gives JAX's ``train_torch``
    losses (itself torch on the CPU) bit for bit, for the same seed and
    flags (tolerance 0: both run the same torch ops on the same CPU);
  - a two-process gang of the port's ``train_torch`` over gloo (the one
    test here that starts processes): rank 0's logged losses equal a
    replay of DDP's averaged steps in this process, to the 4 decimals
    the log prints;
  - ``collect``'s payloads equal JAX's but for ``jax_version`` /
    ``torch_version``; ``telemetry --once`` exits 0 with the report
    logged.
"""

import logging
import os
import re
import sys
from pathlib import Path

import pytest
import torch

from kubeflow_tpu.runtime.bootstrap import WorkerEnv as JaxWorkerEnv
from kubeflow_tpu.tools import launcher as jax_launcher
from kubeflow_tpu.tools import telemetry as jax_telemetry
from kubeflow_tpu.tools import train_torch as jax_train_torch
from kubeflow_tpu_torch.runtime import bootstrap
from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks
from kubeflow_tpu_torch.tools import launcher, telemetry, train_torch

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
KFT = ("KFT_NUM_PROCESSES", "KFT_PROCESS_ID", "KFT_COORDINATOR_ADDRESS",
       "KFT_JOB_NAME", "KFT_SLICE_TYPE", "MASTER_ADDR", "MASTER_PORT",
       "RANK", "WORLD_SIZE")


@pytest.fixture
def one_process(monkeypatch):
    """A one-process worker's environment (process 0, no rendezvous),
    restored after the test: the workers write MASTER_ADDR et al."""
    saved = {k: os.environ.get(k) for k in KFT}
    for k in KFT:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("KFT_PROCESS_ID", "0")
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.mark.parametrize("argv,code", [
    (["--no-distributed", "--", "sh", "-c", "echo worker ran"], 0),
    (["--no-distributed", "--", "sh", "-c", "exit 3"], 3),
    (["--no-distributed"], 2),
    (["--no-distributed", "--entrypoint", "sys:getrecursionlimit"], None),
], ids=["ok", "fails", "nothing", "entrypoint"])
def test_launcher_exit_codes_equal_jax(one_process, capfd, argv, code):
    theirs = jax_launcher.main(argv)
    mine = launcher.main(argv)
    assert mine == theirs
    if code is not None:
        assert mine == code
    else:
        assert mine == sys.getrecursionlimit()
    if code == 0:
        assert capfd.readouterr().out.count("worker ran") == 2


@pytest.mark.parametrize("coordinator,num,pid", [
    ("kft-job-worker-0.kft-job:1234", 4, 2), ("10.0.0.7", 2, 1),
    (None, 1, 0)])
def test_torch_dist_env_equals_jax(coordinator, num, pid):
    kw = dict(coordinator_address=coordinator, num_processes=num,
              process_id=pid, job_name="j", slice_type="h100-8")
    assert bootstrap.torch_dist_env(bootstrap.WorkerEnv(**kw)) == \
        jax_train_torch.torch_dist_env(JaxWorkerEnv(**kw))


@pytest.mark.parametrize("flags", [
    [], ["--steps", "7", "--batch-size", "5", "--features", "3",
         "--learning-rate", "0.1"]], ids=["defaults", "flags"])
def test_train_torch_losses_equal_jax(one_process, monkeypatch, flags):
    """Every step's loss, recorded where both call torch's mse_loss."""
    seen = []
    mse = torch.nn.functional.mse_loss

    def recording(*args, **kw):
        loss = mse(*args, **kw)
        seen.append(loss.item())
        return loss

    monkeypatch.setattr(torch.nn.functional, "mse_loss", recording)
    assert jax_train_torch.main(flags) == 0
    theirs, seen[:] = list(seen), []
    mine = train_torch.run(flags + ["--device", "cpu"])
    assert mine == seen == theirs
    steps = 10 if not flags else 7
    assert len(mine) == steps and mine[-1] < mine[0]


def _replay_ddp(world, steps, batch, features, lr):
    """Rank 0's losses of a ``world``-process gang, replayed here: each
    rank seeds its own generator with its id and draws its batches from
    it after its model's init; DDP starts every rank from rank 0's
    parameters and averages the gradients."""
    true_w = torch.arange(features, dtype=torch.float32)
    states = []
    for rank in range(world):
        torch.manual_seed(rank)
        model = torch.nn.Linear(features, 1)
        if rank == 0:
            weight = model.weight.detach().clone()
            bias = model.bias.detach().clone()
        states.append(torch.get_rng_state())
    losses = []
    for _ in range(steps):
        grads = []
        for rank in range(world):
            torch.set_rng_state(states[rank])
            x = torch.randn(batch, features)
            states[rank] = torch.get_rng_state()
            w = weight.clone().requires_grad_()
            b = bias.clone().requires_grad_()
            loss = torch.nn.functional.mse_loss(
                x @ w.T + b, (x @ true_w)[:, None])
            loss.backward()
            grads.append((w.grad, b.grad))
            if rank == 0:
                losses.append(loss.item())
        weight = weight - lr * sum(g[0] for g in grads) / world
        bias = bias - lr * sum(g[1] for g in grads) / world
    return losses


def test_train_torch_gang_averages_over_ranks():
    """Two processes over gloo: both finish, and rank 0's logged losses
    are a replay of DDP's averaged steps (each rank's own batches)."""
    results = run_ranks(
        ["-m", "kubeflow_tpu_torch.tools.train_torch", "--device", "cpu",
         "--steps", "5"], 2, timeout_s=120, cwd=str(REPO), threads=1)
    check_ranks(results)
    want = _replay_ddp(2, 5, 32, 8, 0.05)
    got = [float(m) for m in re.findall(r"step \d+ loss ([0-9.]+)",
                                        results[0].stderr)]
    assert len(got) == 5
    assert got == pytest.approx(want, abs=5.01e-5)
    for r in results:
        assert "torch training done: loss" in r.stderr


class _Kube:
    def __init__(self, nodes):
        self.nodes = nodes

    def list_nodes(self):
        if self.nodes is None:
            raise ConnectionError("no cluster")
        return [{} for _ in range(self.nodes)]


@pytest.mark.parametrize("kube", [None, _Kube(3), _Kube(None)],
                         ids=["no-client", "three-nodes", "unreachable"])
def test_collect_equals_jax_but_the_framework(kube):
    mine = telemetry.collect("u-1", kube=kube)
    theirs = jax_telemetry.collect("u-1", kube=kube)
    assert mine.pop("torch_version") == torch.__version__
    assert theirs.pop("jax_version") is not None
    assert mine == theirs


def test_telemetry_once_reports_and_exits_0(caplog):
    with caplog.at_level(logging.INFO,
                         logger="kubeflow_tpu_torch.tools.telemetry"):
        assert telemetry.main(["--usage-id", "u-2", "--once"]) == 0
    (rec,) = [r for r in caplog.records if "usage report" in r.message]
    assert '"usage_id": "u-2"' in rec.message
    assert '"torch_version"' in rec.message and "node_count" not in \
        rec.message
