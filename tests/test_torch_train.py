"""The port's training slice against the JAX package's.

Every comparison runs float32 on the CPU, from the same numpy inputs and
bridged weights (models/convert.py).  With ``attention="flash"`` the JAX
``Attention`` falls back to ``dot_product_attention`` on the CPU, while
the port runs its flash path's plain versions (``flash_fwd_reference``
and ``flash_bwd_reference`` through ``_FlashFunction``): the same math by
another route.  Tolerances:

  - lm_task loss and every gradient leaf: atol=rtol=1e-4;
  - remat on against off: atol=rtol=1e-6 (float32 rounding: the same
    ops, recomputed);
  - optim.adamw and the schedule against optax over 5 updates:
    atol=1e-6, rtol=1e-5 (float32 foreach arithmetic in another order);
  - Trainer against the JAX Trainer, 5 steps of loss and grad_norm:
    atol=rtol=1e-4.
"""

import collections
import dataclasses
import functools
import json
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.models.transformer import (
    TransformerConfig as JaxTransformerConfig,
)
from kubeflow_tpu.models.transformer import lm_task as jax_lm_task
from kubeflow_tpu.parallel import MeshSpec
from kubeflow_tpu.runtime.metrics import MetricsLogger as JaxMetricsLogger
from kubeflow_tpu.runtime import checkpoint as jax_checkpoint
from kubeflow_tpu.runtime.train import Trainer as JaxTrainer
from kubeflow_tpu.tools import train_lm as jax_train_lm
from kubeflow_tpu_torch import data
from kubeflow_tpu_torch.data import write_example_shards
from kubeflow_tpu_torch.models.convert import (
    load_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.transformer import (
    _MATMULS,
    Transformer,
    TransformerConfig,
    lm_task,
)
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.runtime import bootstrap, optim
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.runtime.supervisor import TrainSupervisor
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.testing import faults
from kubeflow_tpu_torch.tools import train_lm
from torch_lockcheck import lockcheck_order  # noqa: F401

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

SMALL = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, head_dim=8, max_seq_len=64,
             attention="flash")
LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
REMAT_TOL = dict(atol=1e-6, rtol=1e-6)
OPT_TOL = dict(atol=1e-6, rtol=1e-5)
TINY_ARGS = ["--d-model", "32", "--n-layers", "2", "--n-heads", "4",
             "--n-kv-heads", "2", "--d-ff", "64", "--head-dim", "8",
             "--vocab-size", "64", "--seq-len", "16",
             "--batch-size-per-device", "1", "--steps", "2",
             "--log-every", "1"]


def _tokens(seed=1, shape=(2, 48), vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _jax_params(cfg, seed=0):
    """The JAX model's initial weights at ``cfg`` from ``seed`` (numpy),
    drawn once a module for each (cfg, seed) and copied to each caller."""
    return jax.tree.map(np.copy, _jax_init(cfg, seed))


@functools.lru_cache(maxsize=None)
def _jax_init(cfg, seed):
    init_fn, _ = jax_lm_task(cfg)
    params, _ = init_fn(jax.random.key(seed))
    return jax.tree.map(np.asarray, nn.unbox(params))


def _port_model(overrides, tree):
    cfg = TransformerConfig(dtype=torch.float32, **overrides)
    return load_params(Transformer(cfg, device="meta"), params_from_jax(tree))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_close(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=str(path),
                                   **tol)


@pytest.mark.parametrize("ce_dtype,ce_chunk", [
    ("f32", 0), ("compute", 0), ("f32", 16), ("compute", 12)])
def test_lm_task_loss_and_grads_match_jax(ce_dtype, ce_chunk):
    overrides = dict(SMALL, ce_dtype=ce_dtype, ce_chunk=ce_chunk)
    jcfg = JaxTransformerConfig(dtype=jnp.float32, **overrides)
    tree = _jax_params(jcfg)
    tokens = _tokens()
    _, jax_loss_fn = jax_lm_task(jcfg)
    (jloss, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, {}, {"tokens": jnp.asarray(tokens)},
                              jax.random.key(1)), has_aux=True))(tree)

    model = _port_model(overrides, tree)
    _, loss_fn = lm_task(model.cfg, device="cpu")
    loss, (metrics, mutable) = loss_fn(
        model, {}, {"tokens": torch.from_numpy(tokens)}, None)
    loss.backward()
    assert mutable == {}
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(metrics["perplexity"].item(),
                               float(jmetrics["perplexity"]), **LOSS_TOL)
    _assert_trees_close(params_to_jax(model, grads=True),
                        jax.tree.map(np.asarray, jgrads), **LOSS_TOL)


@pytest.mark.parametrize("attention", ["flash", "dot"])
@pytest.mark.parametrize("policy", ["nobatch", "dots", "minimal"])
@pytest.mark.parametrize("save_residuals", [True, False])
def test_remat_gives_the_same_grads(attention, policy, save_residuals):
    overrides = dict(SMALL, attention=attention)
    tree = _jax_params(JaxTransformerConfig(dtype=jnp.float32, **overrides))
    tokens = {"tokens": torch.from_numpy(_tokens())}
    calls = []
    fwd = flash.flash_fwd

    def counting_fwd(*args, **kwargs):
        calls.append(1)
        return fwd(*args, **kwargs)

    def grads(**remat):
        cfg_over = dict(overrides, **remat)
        model = _port_model(cfg_over, tree)
        _, loss_fn = lm_task(model.cfg, device="cpu")
        calls.clear()
        flash.flash_fwd = counting_fwd
        try:
            loss, _ = loss_fn(model, {}, tokens, None)
            loss.backward()
        finally:
            flash.flash_fwd = fwd
        return loss.item(), params_to_jax(model, grads=True), len(calls)

    plain_loss, plain, plain_calls = grads()
    loss, rematted, remat_calls = grads(
        remat=True, remat_policy=policy,
        save_attn_residuals=save_residuals)
    np.testing.assert_allclose(loss, plain_loss, **REMAT_TOL)
    _assert_trees_close(rematted, plain, **REMAT_TOL)
    n = SMALL["n_layers"]
    if attention == "dot":
        assert plain_calls == remat_calls == 0
    else:
        # The forward kernel runs once per layer, and once more in the
        # backward only when its residuals are not kept.
        assert plain_calls == n
        assert remat_calls == (n if save_residuals else 2 * n)


class _CountMatmuls(TorchDispatchMode):
    """Counts the aten matmuls dispatched under it, by (batch, m, k, n)."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MATMULS:
            a, b = args[-2:]
            lead = a.shape[0] if a.dim() == 3 else 1
            self.seen[(lead,) + tuple(a.shape[-2:]) + (b.shape[-1],)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["nobatch", "dots", "minimal"])
def test_remat_policy_saves_what_it_names(policy):
    """The matmuls each policy recomputes in the backward: the backward's
    matmuls under remat less those without it.  A weight projection is a
    matmul whose batch is 1 (or none); the attention scores and p.v are
    batched over b * h.  "nobatch" saves the projections, "dots" every
    matmul, "minimal" none of them."""
    overrides = dict(SMALL, attention="dot")
    tree = _jax_params(JaxTransformerConfig(dtype=jnp.float32, **overrides))
    tokens = {"tokens": torch.from_numpy(_tokens())}
    b, h = tokens["tokens"].shape[0], SMALL["n_heads"]

    def backward_matmuls(**remat):
        model = _port_model(dict(overrides, **remat), tree)
        _, loss_fn = lm_task(model.cfg, device="cpu")
        loss, _ = loss_fn(model, {}, tokens, None)
        with _CountMatmuls() as count:
            loss.backward()
        return count.seen

    plain = backward_matmuls()
    rematted = backward_matmuls(remat=True, remat_policy=policy)
    assert not plain - rematted
    recomputed = rematted - plain
    projections = sum(n for key, n in recomputed.items() if key[0] == 1)
    batched = sum(n for key, n in recomputed.items() if key[0] == b * h)
    assert projections + batched == sum(recomputed.values())
    n = SMALL["n_layers"]
    # Per layer: scores q.k and p.v; the q, k, v, out, gate and up
    # projections (the MLP's last one feeds only the residual add).
    want = {"nobatch": (0, 2 * n), "dots": (0, 0),
            "minimal": (6 * n, 2 * n)}[policy]
    assert (projections, batched) == want


def test_unknown_remat_policy_raises():
    cfg = TransformerConfig(dtype=torch.float32, remat=True,
                            remat_policy="bogus", **SMALL)
    with pytest.raises(ValueError, match="remat_policy"):
        Transformer(cfg, device="cpu")


def test_flops_per_token_and_return_hidden_match_jax():
    for over in (SMALL, dict(SMALL, tied_embeddings=False)):
        jcfg = JaxTransformerConfig(dtype=jnp.float32, **over)
        cfg = TransformerConfig(dtype=torch.float32, **over)
        assert cfg.flops_per_token() == jcfg.flops_per_token()
        tree = _jax_params(jcfg)
        tokens = _tokens(shape=(2, 20))
        jh, ju = JaxTransformer(jcfg).apply({"params": tree},
                                            jnp.asarray(tokens),
                                            return_hidden=True)
        with torch.no_grad():
            h, u = _port_model(over, tree)(torch.from_numpy(tokens),
                                           return_hidden=True)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **LOSS_TOL)
        np.testing.assert_array_equal(u.detach().numpy(), np.asarray(ju))


def _opt_inputs(seed=2):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_optax(schedule):
    params, grads = _opt_inputs()
    if schedule:
        jlr = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=1e-2, warmup_steps=2, decay_steps=5,
            end_value=1e-3)
        lr = optim.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=1e-2, warmup_steps=2, decay_steps=5,
            end_value=1e-3)
    else:
        jlr = lr = 1e-2
    tx = optax.adamw(jlr)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    port = optim.adamw(lr)
    tparams = [torch.from_numpy(params[k].copy()) for k in sorted(params)]
    state = port.init(tparams)
    for t, g in enumerate(grads):
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        port.update([torch.from_numpy(g[k]) for k in sorted(g)], state,
                    tparams)
        assert state.count == t + 1
        for p, k in zip(tparams, sorted(params)):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       err_msg=f"update {t} {k}", **OPT_TOL)
            if schedule and t == 0:
                # The first update under a warmup from 0 changes nothing.
                np.testing.assert_array_equal(p.numpy(), params[k])


def test_schedule_and_global_norm_match_optax():
    jlr = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 10, 3e-5)
    lr = optim.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 10, 3e-5)
    for count in range(14):
        np.testing.assert_allclose(lr(count), float(jlr(count)), rtol=1e-6,
                                   atol=1e-12)
    _, grads = _opt_inputs()
    np.testing.assert_allclose(
        optim.global_norm([torch.from_numpy(v) for v in grads[0].values()]
                          ).item(),
        float(optax.global_norm(grads[0])), rtol=1e-6)


def _batches(n, shape=(2, 32), vocab=256):
    rng = np.random.RandomState(7)
    return [{"tokens": rng.randint(0, vocab, size=shape).astype(np.int32)}
            for _ in range(n)]


def test_trainer_trajectory_matches_jax_trainer():
    overrides = dict(SMALL, remat=True)
    jcfg = JaxTransformerConfig(dtype=jnp.float32, **overrides)
    jinit, jloss = jax_lm_task(jcfg)
    jtrainer = JaxTrainer(
        init_fn=jinit, loss_fn=jloss, tx=optax.adamw(1e-2),
        mesh=MeshSpec(data=1).build(jax.devices()[:1]),
        metrics=JaxMetricsLogger(stream=open("/dev/null", "w")))
    jstate = jtrainer.create_state(seed=0)
    tree = jax.tree.map(np.asarray, jstate.params)

    cfg = TransformerConfig(dtype=torch.float32, **overrides)
    init_fn, loss_fn = lm_task(cfg, device="cpu")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adamw(1e-2), device="cpu",
                      metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = trainer.create_state(seed=0)
    load_params(state.params, params_from_jax(tree))
    batches = _batches(5)
    jstep, step = jtrainer.compile_step(), trainer.compile_step()
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, jtrainer.shard_batch(batch))
        state, m = step(state, trainer.shard_batch(batch))
        for key in ("loss", "grad_norm", "perplexity"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       err_msg=f"step {i} {key}", **LOSS_TOL)
    assert state.step == int(jstate.step) == 5
    _assert_trees_close(params_to_jax(state.params),
                        jax.tree.map(np.asarray, jstate.params),
                        atol=1e-4, rtol=1e-3)


def test_fit_logs_the_same_trajectory_as_the_step():
    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    init_fn, loss_fn = lm_task(cfg, device="cpu")

    def trainer(**kw):
        return Trainer(init_fn=init_fn, loss_fn=loss_fn,
                       tx=optim.adamw(1e-2), device="cpu",
                       metrics=MetricsLogger(stream=open("/dev/null", "w")),
                       **kw)

    stepped = trainer()
    state = stepped.create_state(seed=3)
    losses = []
    for batch in _batches(4):
        state, m = stepped.compile_step()(state, stepped.shard_batch(batch))
        losses.append(m["loss"].item())
    for steps_per_call in (1, 2):
        fitted = trainer(flops_per_example=1.0, peak_flops_per_chip=1e9)
        seen = []
        end = fitted.fit(iter(_batches(4)), 4, state=fitted.create_state(3),
                         examples_per_step=2, log_every=1,
                         steps_per_call=steps_per_call, on_step=seen.append)
        assert end.step == 4
        logged = [r["loss"] for r in fitted.metrics.history]
        assert seen == [1, 2, 3, 4][steps_per_call - 1::steps_per_call]
        np.testing.assert_allclose(
            logged, losses[steps_per_call - 1::steps_per_call], rtol=1e-6)
        assert set(fitted.last_metrics) == {"loss", "grad_norm",
                                            "perplexity"}
        assert "mfu" in fitted.metrics.history[-1]


def test_supervisor_restarts_a_faulted_fit_from_init():
    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    init_fn, loss_fn = lm_task(cfg, device="cpu")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adamw(1e-2), device="cpu",
                      metrics=MetricsLogger(stream=open("/dev/null", "w")))
    sup = TrainSupervisor(trainer, max_restarts=2, backoff_s=0.0,
                          backoff_max_s=0.0)
    restarts = REGISTRY.counter("kft_train_restarts_total")
    before = restarts.value(reason="step")
    with faults.injected("train.step:raise*1") as inj:
        state = sup.run(lambda: iter(_batches(3)), 3, log_every=0)
    assert sup.restarts == 1 and state.step == 3
    assert restarts.value(reason="step") == before + 1
    assert inj.fired("train.step") == 4  # one failed dispatch + 3 steps


def test_train_lm_writes_the_jax_metrics_schema(tmp_path):
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    assert train_lm.main(TINY_ARGS + ["--device", "cpu", "--attention",
                                      "flash", "--remat", "--metrics-out",
                                      str(port_out)]) == 0
    assert jax_train_lm.main(TINY_ARGS + ["--metrics-out",
                                          str(jax_out)]) == 0
    port, ref = json.loads(port_out.read_text()), json.loads(
        jax_out.read_text())
    assert set(port) == set(ref) == {"config", "history"}
    assert set(port["config"]) == set(ref["config"]) | {"device"}
    assert [set(r) for r in port["history"]] == [set(r) for r in
                                                 ref["history"]]
    assert [r["step"] for r in port["history"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in port["history"])


def test_train_lm_run_returns_the_trainer_and_its_last_metrics():
    trainer = train_lm.run(TINY_ARGS + ["--device", "cpu", "--attention",
                                        "flash", "--remat"])
    last = trainer.last_metrics
    assert {"loss", "grad_norm", "perplexity"} <= set(last)
    assert all(np.isfinite(v) for v in last.values())
    assert last["grad_norm"] > 0
    assert last["loss"] == trainer.metrics.history[-1]["loss"]


# --mesh with every axis (expert with --moe-experts) and --attention ring
# are ported (tests/test_torch_parallel_train.py,
# tests/test_torch_pipeline.py, tests/test_torch_moe_mesh.py), and so is
# adafactor over parameters split over any of them: the entry point
# passes each flag set below, and the same flags with every axis at one
# rank train here.
@pytest.mark.parametrize("flag,one_rank", [
    (["--mesh", "pipeline=2,expert=2", "--pipeline-microbatches", "2",
      "--moe-experts", "4", "--optimizer", "adafactor"],
     "pipeline=1,expert=1"),
    (["--mesh", "model=2,expert=2", "--moe-experts", "4", "--optimizer",
      "adafactor"], "model=1,expert=1"),
    (["--mesh", "expert=2", "--moe-experts", "4", "--optimizer",
      "adafactor"], "expert=1")], ids=["flag0", "flag1", "flag3"])
def test_train_lm_not_ported_flags_raise(flag, one_rank):
    at = flag.index("--mesh") + 1
    args = types.SimpleNamespace(optimizer="adafactor", moe_experts=4)
    assert train_lm._not_ported(args, train_lm.parse_mesh(flag[at])) == ""
    argv = TINY_ARGS + ["--device", "cpu"] + flag
    argv[len(TINY_ARGS) + 2 + at] = one_rank
    try:
        trainer = train_lm.run(argv)
    finally:
        # The one-rank mesh started its own process group; later tests
        # of this file start with none.
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert isinstance(trainer.tx, optim.Adafactor)
    losses = [h["loss"] for h in trainer.metrics.history]
    assert len(losses) == 2 and np.isfinite(losses).all()


def _shards(tmp_path, n=24):
    rng = np.random.RandomState(3)
    return [str(p) for p in write_example_shards(
        ({"tokens": rng.randint(0, 64, size=(16,)).astype(np.int32)}
         for _ in range(n)), tmp_path / "data", examples_per_shard=8)]


def test_train_lm_adafactor_data_files_and_checkpoints(tmp_path):
    """The entry point with --optimizer adafactor, --data-files and
    --checkpoint-dir: checkpoints every 2 steps that the JAX package's
    verifier accepts, a rerun to more steps resumes after the last
    saved step, and one to as many steps trains nothing."""
    ckpt = tmp_path / "ckpt"
    flags = TINY_ARGS + ["--device", "cpu", "--optimizer", "adafactor",
                         "--data-files", *_shards(tmp_path),
                         "--checkpoint-dir", str(ckpt),
                         "--checkpoint-every", "2"]
    first = train_lm.run(flags + ["--steps", "4"])
    assert isinstance(first.tx, optim.Adafactor)
    assert [r["step"] for r in first.metrics.history] == [0, 1, 2, 3]
    assert first.checkpoints.all_steps() == [1, 3]
    for step in (1, 3):
        assert jax_checkpoint.verify_step(ckpt, step) == (True, "")
    second = train_lm.run(flags + ["--steps", "6"])
    assert [r["step"] for r in second.metrics.history] == [4, 5]
    assert second.checkpoints.all_steps() == [1, 3, 5]
    assert all(np.isfinite(r["loss"]) for r in second.metrics.history)
    third = train_lm.run(flags + ["--steps", "6"])
    assert third.metrics.history == []


def test_train_lm_data_files_give_the_jax_entry_points_batches(
        tmp_path, monkeypatch):
    """The --data-files factory is the JAX entry point's:
    RecordDataset(files, shuffle_buffer=1024, repeat=-1).shard(0, 1),
    then tensor_batches(ds, batch).  With one reader thread the port's
    yields the JAX package's arrays; the default four threads read files
    and repeated epochs in no fixed order, in both packages."""
    from kubeflow_tpu.data import RecordDataset as JaxRecordDataset
    from kubeflow_tpu.data import tensor_batches as jax_tensor_batches

    files = _shards(tmp_path, n=40)
    seen = []
    original = data.tensor_batches

    def spy(ds, batch, **kw):
        seen.append((ds.paths, ds.shuffle_buffer, ds.repeat, ds.seed,
                     batch))
        return original(ds, batch, **kw)

    monkeypatch.setattr(data, "tensor_batches", spy)
    train_lm.run(TINY_ARGS + ["--device", "cpu", "--data-files", *files,
                              "--batch-size-per-device", "2"])
    assert seen == [(files, 1024, -1, 0, 2)]
    ours = original(data.RecordDataset(
        files, shuffle_buffer=1024, repeat=-1, num_threads=1).shard(0, 1),
        2)
    theirs = jax_tensor_batches(JaxRecordDataset(
        files, shuffle_buffer=1024, repeat=-1, num_threads=1).shard(0, 1),
        2)
    for _, a, b in zip(range(30), ours, theirs):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_train_lm_runs_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(TINY_ARGS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(init_fn=None, loss_fn=None, tx=None)


def test_trainer_and_bootstrap_refuse_what_is_not_ported():
    """A mesh over ``tensor``, ``pipeline`` or ``expert`` is taken (the
    expert axis, refused before it was ported, too); a multi-process job
    whose rendezvous fails raises (no single-process fallback); a single
    process needs none."""
    names = ("data", "fsdp", "pipeline", "expert", "sequence", "tensor")

    def mesh_of(axis):
        return types.SimpleNamespace(
            mesh_dim_names=names,
            shape=tuple(2 if n == axis else 1 for n in names))

    for axis in ("tensor", "pipeline", "expert"):
        assert Trainer(init_fn=None, loss_fn=None, tx=None, device="cpu",
                       mesh=mesh_of(axis)).mesh is not None
    env = bootstrap.worker_env({"KFT_NUM_PROCESSES": "2",
                                "KFT_PROCESS_ID": "1",
                                "KFT_COORDINATOR_ADDRESS": "w-0:1234"})
    assert env.is_distributed and env.process_id == 1
    # Rank 1 of 2 against a coordinator port on this host that nobody
    # serves: the store connection gives up after the timeout.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    unserved = dataclasses.replace(
        env, coordinator_address=f"127.0.0.1:{port}")
    with pytest.raises(Exception, match="(?i)timed out|timeout|refused"):
        bootstrap.initialize(unserved, device="cpu", timeout_s=2)
    assert not torch.distributed.is_initialized()
    single = bootstrap.initialize(bootstrap.worker_env({}))
    assert not single.is_distributed
