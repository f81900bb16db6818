"""The port's CNN training slice against the JAX package's:
``optim.sgd``, ``classification_task`` + ``Trainer``, ``eval_step``,
checkpoints, and ``tools/train_cnn.py``.

float32 on the CPU, the same numpy batches and weights given to both.
Tolerances:

  - ``optim.sgd`` against ``optax.sgd`` over 5 updates: atol 1e-6;
  - 3 ``Trainer`` steps of a narrow ResNet-18 against the JAX
    ``Trainer`` with ``optax.sgd(0.1, momentum=0.9)``: loss, grad_norm,
    accuracy, parameters and ``batch_stats`` within atol 1e-4;
  - ``eval_step``: atol 1e-4;
  - the gang (item 23): two 2-rank jobs over gloo, their ranks JAX-free
    subprocesses (tests/torch_cnn_gang_worker.py) started together while
    one process trains here.  ``trainer``: the narrow ResNet-18 through
    ``classification_task(mesh=)`` + ``Trainer`` over ``MeshSpec(data=2)``,
    each rank on 2 rows of the global batch of 4, against the JAX
    ``Trainer`` on the global batch: loss, grad_norm,
    accuracy, parameters and ``batch_stats`` after 2 sgd steps within
    atol 1e-4, the batch statistics equal on both ranks, and a rank's own
    rows giving another batch mean than the global one.  ``train_cnn``:
    ``tools/train_cnn.run`` as a gang of two over KFTR shards (each
    process reads every other shard) against one process on the same
    data at twice the rows: losses within atol 1e-4, checkpoints that
    JAX's ``verify_step`` accepts and whose parameters and batch
    statistics agree within atol 1e-4.
"""

import concurrent.futures
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
from kubeflow_tpu_torch.data import write_example_shards
from kubeflow_tpu_torch.models.classification import (
    classification_task,
    eval_step,
)
from kubeflow_tpu_torch.models.convert_cnn import (
    cnn_variables_from_jax,
    cnn_variables_to_jax,
    load_cnn_variables,
)
from kubeflow_tpu_torch.models.resnet import ResNet18, ResNetConfig
from kubeflow_tpu_torch.runtime import checkpoint, optim
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks
from kubeflow_tpu_torch.tools import train_cnn
from test_torch_resnet import assert_trees_close, random_variables

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_cnn_gang_worker.py")
GANG_TIMEOUT_S = 150
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


@pytest.fixture(scope="module")
def jax_trajectory(variables):
    """The JAX ``Trainer`` with ``optax.sgd(0.1, momentum=0.9)`` from
    ``variables`` over ``_batches(3)``: each step's loss, grad_norm and
    accuracy, and the variables after each step."""
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
    jstep = jtrainer.compile_step()
    metrics, after = [], []
    for batch in _batches(3):
        jstate, jm = jstep(jstate, jtrainer.shard_batch(batch))
        metrics.append({k: float(jm[k])
                        for k in ("loss", "grad_norm", "accuracy")})
        after.append(jax.tree.map(np.asarray, {
            "params": jstate.params,
            "batch_stats": jstate.mutable["batch_stats"]}))
    assert int(jstate.step) == 3
    return metrics, after


def test_trainer_trajectory_matches_jax_trainer(variables, jax_trajectory):
    metrics, after = jax_trajectory
    trainer, state = _port_trainer(variables)
    step = trainer.compile_step()
    for i, batch in enumerate(_batches(3)):
        state, m = step(state, trainer.shard_batch(batch))
        for key in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(m[key].item(), metrics[i][key],
                                       err_msg=f"step {i} {key}", **TRAJ_TOL)
    assert state.step == 3
    got = cnn_variables_to_jax(state.params, state.mutable["batch_stats"])
    assert_trees_close(got["params"], after[2]["params"], **TRAJ_TOL)
    assert_trees_close(got["batch_stats"], after[2]["batch_stats"],
                       **TRAJ_TOL)


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


# -- the gang ------------------------------------------------------------------


def _gang_shards(directory, n=8, per_shard=2):
    """KFTR shards of ``per_shard`` examples each: with one reader thread
    and no shuffle a process reads them in order, and a gang's process r
    every other one from r, so a gang of 2 at ``per_shard`` rows a
    process steps on the rows one process at twice that steps on."""
    rng = np.random.RandomState(5)
    write_example_shards(
        ({"image": rng.randn(SIZE, SIZE, 3).astype(np.float32),
          "label": np.int32(rng.randint(0, 10))} for _ in range(n)),
        directory, examples_per_shard=per_shard)


def _gang_argv(data, ckpt, rows):
    """The entry point's flags for ``rows`` a process, in float32: in
    bf16 each process rounds its rows' weight gradients to bf16 before
    the all-reduce, where one process rounds the whole batch's once
    (1e-3 apart in the second loss)."""
    return TINY_ARGS[:TINY_ARGS.index("--batch-size-per-device")] + [
        "--batch-size-per-device", str(rows), "--num-classes", "10",
        "--dtype", "float32",
        "--log-every", "1", "--steps", "2", "--data-dir", str(data),
        "--shuffle-buffer", "0", "--data-threads", "1",
        "--checkpoint-dir", str(ckpt), "--checkpoint-every", "1",
        "--max-restarts", "0"]


@pytest.fixture(scope="module")
def gang(tmp_path_factory, variables):
    """The two gang jobs run while one process trains on the same shards
    here."""
    work = tmp_path_factory.mktemp("cnn_gang")
    _gang_shards(work / "data")
    batches = _batches(2)
    state, stats = cnn_variables_from_jax(variables)
    torch.save({"narrow": NARROW, "input_shape": (1, SIZE, SIZE, 3),
                "state": state, "stats": stats,
                "batches": [{k: torch.from_numpy(np.asarray(v))
                             for k, v in b.items()} for b in batches],
                "train_cnn_argv": _gang_argv(work / "data",
                                             work / "ckpt_gang", 2)},
               work / "inputs.pt")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {job: pool.submit(run_ranks, [WORKER, job, str(work)], 2,
                                    timeout_s=GANG_TIMEOUT_S, cwd=str(REPO),
                                    threads=1)
                   for job in ("trainer", "train_cnn")}
        one = train_cnn.run(_gang_argv(work / "data", work / "ckpt_one", 4))
        for future in futures.values():
            check_ranks(future.result())
    jobs = {job: [torch.load(work / f"{job}-rank{r}.pt", weights_only=True)
                  for r in range(2)] for job in futures}
    return {"jobs": jobs, "one": one.metrics.history, "dir": work}


def test_gang_trainer_matches_jax_on_the_global_batch(gang, jax_trajectory):
    """The gang's 2 steps against the JAX ``Trainer``'s first 2 on the
    global batches (one device holds them whole, as pjit's global view
    of JAX's data=2 does)."""
    metrics, after = jax_trajectory
    jax_vars = after[1]
    for r in gang["jobs"]["trainer"]:
        for key, values in r["metrics"].items():
            np.testing.assert_allclose(values, [m[key] for m in metrics[:2]],
                                       err_msg=key, **TRAJ_TOL)
    first = gang["jobs"]["trainer"][0]
    model = ResNet18(dtype=torch.float32, device="cpu", **NARROW)
    model.load_state_dict(first["params"])
    got = cnn_variables_to_jax(model, first["batch_stats"])
    assert_trees_close(got["params"], jax_vars["params"], **TRAJ_TOL)
    assert_trees_close(got["batch_stats"], jax_vars["batch_stats"],
                       **TRAJ_TOL)


def test_gang_batch_statistics_are_global_and_equal(gang):
    """Both ranks hold the same running averages, those of the global
    batch: a rank's own 2 rows give another batch mean."""
    first, second = gang["jobs"]["trainer"]
    flat = jax.tree_util.tree_leaves_with_path
    for (path, a), (_, b) in zip(flat(first["batch_stats"]),
                                 flat(second["batch_stats"])):
        torch.testing.assert_close(a, b, atol=0, rtol=0,
                                   msg=jax.tree_util.keystr(path))
    for r in gang["jobs"]["trainer"]:
        assert r["local_mean_gap"] > 1e-3, r["local_mean_gap"]


def test_train_cnn_gang_checkpoint_matches_one_process(gang):
    """The gang's save (rank 0 writes the gathered state) verifies in
    JAX, and holds the one-process run's parameters and batch
    statistics after the same 2 steps."""
    work = gang["dir"]
    for step in (0, 1):
        assert jax_checkpoint.verify_step(work / "ckpt_gang", step) == (
            True, ""), step
    saved = [torch.load(work / d / "1" / checkpoint.STATE_FILE,
                        weights_only=True) for d in ("ckpt_gang",
                                                     "ckpt_one")]
    for key in ("params", "mutable"):
        flat = [dict(jax.tree_util.tree_leaves_with_path(s[key]))
                for s in saved]
        assert flat[0].keys() == flat[1].keys()
        for path, t in flat[0].items():
            np.testing.assert_allclose(
                t.numpy(), flat[1][path].numpy(), **TRAJ_TOL,
                err_msg=jax.tree_util.keystr(path))


def test_train_cnn_refuses_a_gang_and_a_missing_gpu(gang):
    """A gang of two trains (refused before it was ported): both
    processes log one loss history, the global batch's, that of one
    process on the same rows within atol 1e-4, and count its examples;
    without ``--device cpu`` and without a GPU the entry point raises."""
    ranks = gang["jobs"]["train_cnn"]
    assert [r["world"] for r in ranks] == [2, 2]
    losses = [[h["loss"] for h in r["history"]] for r in ranks]
    assert losses[0] == losses[1]
    want = [h["loss"] for h in gang["one"]]
    assert len(want) == 2
    np.testing.assert_allclose(losses[0], want, **TRAJ_TOL)
    for h in ranks[0]["history"]:
        # A step's examples are the global batch's 4.
        assert h["examples_per_sec"] * h["step_time_s"] == pytest.approx(
            4, rel=1e-2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cnn.run([a for a in TINY_ARGS if a not in ("--device",
                                                             "cpu")])
