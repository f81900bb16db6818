"""The port's CNN training slice against the JAX package's:
``optim.sgd``, ``classification_task`` + ``Trainer``, ``eval_step``,
checkpoints, and ``tools/train_cnn.py``.

float32 on the CPU, the same numpy batches and weights given to both.
Tolerances:

  - ``optim.sgd`` against ``optax.sgd`` over 5 updates: atol 1e-6;
  - 3 ``Trainer`` steps of a narrow ResNet-18 against the JAX
    ``Trainer`` with ``optax.sgd(0.1, momentum=0.9)``: loss, grad_norm,
    accuracy, parameters and ``batch_stats`` within atol 1e-4;
  - ``eval_step``: atol 1e-4.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import classification as jcls
from kubeflow_tpu.models.resnet import ResNet18 as JaxResNet18
from kubeflow_tpu.parallel import MeshSpec
from kubeflow_tpu.runtime import checkpoint as jax_checkpoint
from kubeflow_tpu.runtime.metrics import MetricsLogger as JaxMetricsLogger
from kubeflow_tpu.runtime.train import Trainer as JaxTrainer
from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.data import write_example_shards
from kubeflow_tpu_torch.models.classification import (
    classification_task,
    eval_step,
)
from kubeflow_tpu_torch.models.convert_cnn import (
    cnn_variables_to_jax,
    load_cnn_variables,
)
from kubeflow_tpu_torch.models.resnet import ResNet18, ResNetConfig
from kubeflow_tpu_torch.runtime import checkpoint, optim
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.tools import train_cnn
from test_torch_resnet import assert_trees_close, random_variables

REPO = Path(__file__).resolve().parents[1]
NARROW = dict(num_classes=10, num_filters=8)
# 33 x 33: the last stage at 2 x 2.  At 32 x 32 it runs at 1 x 1, its
# batch statistics over the batch's 4 rows, and the train-mode gradients
# turn ill-conditioned: two float32 implementations part by more than
# 1e-4 within two steps at lr 0.1.
SIZE = 33
TRAJ_TOL = dict(atol=1e-4)
TINY_ARGS = ["--device", "cpu", "--model", "resnet18", "--image-size", "33",
             "--batch-size-per-device", "2", "--num-classes", "10",
             "--log-every", "1"]


def _opt_inputs(n=5, seed=2):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 3), "b": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(n)]
    return params, grads


@pytest.mark.parametrize("momentum", [0.9, None])
@pytest.mark.parametrize("schedule", [False, True])
def test_sgd_matches_optax(momentum, schedule):
    lr = (optim.linear_schedule(0.1, 0.01, 4) if schedule else 0.1)
    jlr = (optax.linear_schedule(0.1, 0.01, 4) if schedule else 0.1)
    params, grads = _opt_inputs()
    tx = optax.sgd(jlr, momentum=momentum)
    jparams, jstate = dict(params), tx.init(params)
    ours = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sgd = optim.sgd(lr, momentum=momentum)
    state = sgd.init(ours)
    for g in grads:
        updates, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        sgd.update({k: torch.from_numpy(v) for k, v in g.items()}, state,
                   ours)
    assert state.count == len(grads)
    assert len(state.trace) == (2 if momentum else 0)
    for k in params:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(jparams[k]),
                                   atol=1e-6)


def test_sgd_keeps_float32_parameters():
    with pytest.raises(TypeError, match="sgd keeps float32"):
        optim.sgd(0.1).init([torch.zeros(2, dtype=torch.bfloat16)])


def _batches(n, batch=4, seed=7):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(batch, SIZE, SIZE, 3).astype(np.float32),
             "label": rng.randint(0, 10, size=(batch,))} for _ in range(n)]


@pytest.fixture(scope="module")
def variables():
    return jax.tree.map(np.asarray, random_variables(
        JaxResNet18(**NARROW), (1, SIZE, SIZE, 3), train=False))


def _port_trainer(variables, checkpoints=None, every=1000):
    model = ResNet18(dtype=torch.float32, device="cpu", **NARROW)
    init_fn, loss_fn = classification_task(model, (1, SIZE, SIZE, 3),
                                           device="cpu")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.sgd(0.1, momentum=0.9), device="cpu",
                      checkpoints=checkpoints, checkpoint_every=every,
                      metrics=MetricsLogger(stream=open(os.devnull, "w")))
    state = trainer.create_state(seed=0)
    state.mutable = {"batch_stats": load_cnn_variables(state.params,
                                                       variables)}
    return trainer, state


def test_trainer_trajectory_matches_jax_trainer(variables):
    jmodel = JaxResNet18(dtype=jnp.float32, **NARROW)
    _, jloss = jcls.classification_task(jmodel, (1, SIZE, SIZE, 3))

    def jinit(rng):
        return (jax.tree.map(jnp.asarray, variables["params"]),
                {"batch_stats": jax.tree.map(jnp.asarray,
                                             variables["batch_stats"])})

    jtrainer = JaxTrainer(
        init_fn=jinit, loss_fn=jloss, tx=optax.sgd(0.1, momentum=0.9),
        mesh=MeshSpec(data=1).build(jax.devices()[:1]),
        metrics=JaxMetricsLogger(stream=open(os.devnull, "w")))
    jstate = jtrainer.create_state(seed=0)
    trainer, state = _port_trainer(variables)
    jstep, step = jtrainer.compile_step(), trainer.compile_step()
    for i, batch in enumerate(_batches(3)):
        jstate, jm = jstep(jstate, jtrainer.shard_batch(batch))
        state, m = step(state, trainer.shard_batch(batch))
        for key in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TRAJ_TOL)
    assert state.step == int(jstate.step) == 3
    got = cnn_variables_to_jax(state.params, state.mutable["batch_stats"])
    assert_trees_close(got["params"], jax.tree.map(np.asarray, jstate.params),
                       **TRAJ_TOL)
    assert_trees_close(got["batch_stats"], jax.tree.map(
        np.asarray, jstate.mutable["batch_stats"]), **TRAJ_TOL)


def test_eval_step_matches_jax_and_changes_nothing(variables):
    jmodel = JaxResNet18(dtype=jnp.float32, **NARROW)
    batch = _batches(1, batch=6, seed=11)[0]
    want = jcls.eval_step(jmodel)(variables["params"],
                                  {"batch_stats": variables["batch_stats"]},
                                  batch)
    trainer, state = _port_trainer(variables)
    before = cnn_variables_to_jax(state.params, state.mutable["batch_stats"])
    got = eval_step(state.params)(state.params, state.mutable,
                                  trainer.shard_batch(batch))
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   **TRAJ_TOL)
    after = cnn_variables_to_jax(state.params, state.mutable["batch_stats"])
    assert_trees_close(after, before, atol=0, rtol=0)


def test_checkpoint_is_verified_by_jax_and_restores_the_state(tmp_path,
                                                              variables):
    trainer, state = _port_trainer(
        variables, checkpoint.CheckpointManager(tmp_path), every=2)
    state = trainer.fit(iter(_batches(3)), 3, state=state, log_every=0)
    for step in (1, 2):
        assert jax_checkpoint.verify_step(tmp_path, step) == (True, "")
    fresh_trainer, fresh = _port_trainer(variables)
    restored, start = checkpoint.CheckpointManager(tmp_path).restore_or_init(
        fresh)
    assert start == 3 and restored.step == 3
    assert_trees_close(
        cnn_variables_to_jax(restored.params,
                             restored.mutable["batch_stats"]),
        cnn_variables_to_jax(state.params, state.mutable["batch_stats"]),
        atol=0, rtol=0)
    assert restored.opt_state.count == 3
    for a, b in zip(restored.opt_state.trace, state.opt_state.trace):
        assert torch.equal(a, b)


def test_train_cnn_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.tools.train_cnn",
         "--device", "cpu", "--model", "resnet18", "--image-size", "32",
         "--batch-size-per-device", "2", "--steps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, KFT_NUM_PROCESSES="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "training done" in out.stderr
    assert '"step": 1' in out.stderr


def test_train_cnn_data_dir_and_checkpoints(tmp_path):
    rng = np.random.RandomState(0)
    write_example_shards(
        ({"image": rng.randn(SIZE, SIZE, 3).astype(np.float32),
          "label": np.int32(rng.randint(0, 10))} for _ in range(12)),
        tmp_path / "data", examples_per_shard=4)
    args = TINY_ARGS + ["--data-dir", str(tmp_path / "data"),
                        "--checkpoint-dir", str(tmp_path / "ckpt"),
                        "--checkpoint-every", "2", "--data-threads", "1"]
    first = train_cnn.run(args + ["--steps", "2"])
    assert set(first.last_metrics) >= {"loss", "grad_norm", "accuracy"}
    assert np.isfinite(first.last_metrics["loss"])
    assert first.flops_per_example == pytest.approx(
        ResNetConfig("resnet18").fwd_flops_per_image * (33 / 224) ** 2)
    assert first.peak_flops_per_chip == 0.0  # no MFU on the CPU
    assert jax_checkpoint.verify_step(tmp_path / "ckpt", 1) == (True, "")
    resumed = train_cnn.run(args + ["--steps", "3"])
    assert [r["step"] for r in resumed.metrics.history] == [2]
    assert checkpoint.CheckpointManager(tmp_path / "ckpt").all_steps() \
        == [1, 2]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert train_cnn.main(TINY_ARGS + ["--data-dir", str(empty)]) == 1


def test_train_cnn_refuses_a_gang_and_a_missing_gpu(monkeypatch):
    monkeypatch.setenv("KFT_NUM_PROCESSES", "2")
    monkeypatch.setenv("KFT_PROCESS_ID", "0")
    monkeypatch.setenv("KFT_COORDINATOR_ADDRESS", "w-0:1234")
    with pytest.raises(NotPortedError, match="item 11"):
        train_cnn.run(TINY_ARGS + ["--steps", "1"])
    monkeypatch.delenv("KFT_NUM_PROCESSES")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cnn.run([a for a in TINY_ARGS if a not in ("--device",
                                                             "cpu")])
