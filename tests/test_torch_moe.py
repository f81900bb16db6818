"""The port's mixture-of-experts MLP (models/moe.py) and the MoE LM
against the JAX package's.

Every comparison runs float32 on the CPU from the same numpy inputs and
weights (models/convert.py carries ``layers/moe/{router, wi, wo}``).
Tolerances:

  - ``MoEMLP`` output 1e-5 and aux 1e-6 (atol=rtol), for the einsum and
    the gather dispatch, with capacity drops and with a zero router
    (every probability equal, so ``top_k`` ties break to the lower
    expert as ``jax.lax.top_k`` does); the einsum path's bfloat16
    dispatch rounds the tokens in both packages;
  - the LM's ``lm_task`` loss, ``moe_aux`` and every gradient leaf, and a
    5-step adafactor ``Trainer`` trajectory: 1e-4, the dense LM's
    training tolerance (tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models import moe as jax_moe
from kubeflow_tpu.models.transformer import (
    TransformerConfig as JaxTransformerConfig,
)
from kubeflow_tpu.models.transformer import lm_task as jax_lm_task
from kubeflow_tpu.parallel import MeshSpec
from kubeflow_tpu.runtime import checkpoint as jax_checkpoint
from kubeflow_tpu.runtime.metrics import MetricsLogger as JaxMetricsLogger
from kubeflow_tpu.runtime.train import Trainer as JaxTrainer
from kubeflow_tpu.tools import cli as jax_cli
from kubeflow_tpu_torch.models import moe, transformer
from kubeflow_tpu_torch.models.convert import (
    load_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
from kubeflow_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    lm_task,
)
from kubeflow_tpu_torch.runtime import optim
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.serving.engine import DecodeEngine
from kubeflow_tpu_torch.tools import cli as port_cli
from kubeflow_tpu_torch.tools import train_lm

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)
LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
D, F_, E = 16, 32, 4
SMALL_MOE = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=48, head_dim=8, max_seq_len=64,
                 attention="flash", moe_experts=4, moe_group_size=16)


def _layer_pair(impl, capacity_factor, group_size=16, zero_router=False,
                seed=0):
    """A JAX MoEMLP with its float32 params and the port's with the same
    weights."""
    jm = jax_moe.MoEMLP(d_model=D, d_ff=F_, num_experts=E, top_k=2,
                        capacity_factor=capacity_factor,
                        group_size=group_size, dtype=jnp.float32,
                        impl=impl)
    rng = np.random.default_rng(seed)
    params = {"router": rng.normal(0, 0.5, (D, E)).astype(np.float32),
              "wi": rng.normal(0, D ** -0.5, (E, 2, D, F_)).astype(
                  np.float32),
              "wo": rng.normal(0, F_ ** -0.5, (E, F_, D)).astype(
                  np.float32)}
    if zero_router:
        params["router"][:] = 0.0
    pm = moe.MoEMLP(D, F_, E, top_k=2, capacity_factor=capacity_factor,
                    group_size=group_size, dtype=torch.float32, impl=impl,
                    device="cpu")
    for name, value in params.items():
        getattr(pm, name).data = torch.from_numpy(value.copy())
    return jm, params, pm


def _jax_apply(jm, params, x):
    out, sown = jm.apply({"params": params}, jnp.asarray(x),
                         mutable=["losses"])
    return np.asarray(out), float(sown["losses"]["moe_aux"][0])


def _x(shape=(2, 24, D), seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _kept(pm, x):
    """How many of the b*s*top_k routing choices found a slot."""
    g = moe.fit_divisor(x.shape[0] * x.shape[1], pm.group_size, "", "")
    tokens = torch.from_numpy(x).reshape(-1, g, D)
    cap = max(2, int(np.ceil(g * 2 / E * pm.capacity_factor)))
    _, _, _, routes = pm._route(tokens, cap)
    return int(sum(keep.sum() for _, _, keep in routes))


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("case", ["fits", "drops", "ties"])
def test_moe_mlp_matches_jax(impl, case):
    cf, zero = {"fits": (4.0, False), "drops": (0.5, False),
                "ties": (1.25, True)}[case]
    jm, params, pm = _layer_pair(impl, cf, zero_router=zero)
    x = _x()
    want, want_aux = _jax_apply(jm, params, x)
    got, aux = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **OUT_TOL)
    np.testing.assert_allclose(aux.item(), want_aux, **AUX_TOL)
    kept = _kept(pm, x)
    total = x.shape[0] * x.shape[1] * 2
    if case == "fits":
        assert kept == total
    else:
        assert kept < total  # some choices were dropped
    if case == "ties":
        # Every probability is 1/E: each token picks experts 0 and 1, and
        # the aux is E * (1 at expert 0) * (1/E) = 1.
        assert aux.item() == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_mlp_gradients_match_jax(impl):
    jm, params, pm = _layer_pair(impl, 0.75)
    x = _x(seed=3)
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        out, sown = jm.apply({"params": p}, xx, mutable=["losses"])
        return jnp.sum(out * w) + sown["losses"]["moe_aux"][0]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = pm(xt)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    for name in ("router", "wi", "wo"):
        np.testing.assert_allclose(getattr(pm, name).grad.numpy(),
                                   np.asarray(jg[name]), err_msg=name,
                                   **OUT_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **OUT_TOL)


def test_top_k_breaks_ties_to_the_lower_index_like_jax():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.4, 0.1],
                          [0.3, 0.2, 0.3, 0.2]])
    vals, idx = moe.top_k_lower_first(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert idx.tolist() == [[0, 1], [1, 2], [0, 2]]


def test_group_fit_capacity_and_defaults_match_jax():
    assert moe.default_group_size("einsum") == \
        jax_moe.default_group_size("einsum") == 128
    assert moe.default_group_size("gather") == \
        jax_moe.default_group_size("gather") == 256
    for n, limit in ((48, 16), (2046, 256), (16384, 128), (7, 4)):
        assert moe.fit_divisor(n, limit, "x", "y") == \
            jax_moe.fit_divisor(n, limit, "x", "y")
    # One copy in the port: the chunked CE uses the MoE module's fit.
    assert transformer.fit_divisor is moe.fit_divisor
    with pytest.warns(UserWarning, match="MoE routing group degenerated"):
        moe.MoEMLP(D, F_, E, group_size=64, dtype=torch.float32,
                   device="cpu")(torch.zeros(1, 67, D))
    cfg = TransformerConfig(moe_experts=4, moe_impl="gather")
    assert cfg.resolved_moe_group_size() == 256
    assert TransformerConfig(moe_experts=4, moe_group_size=64
                             ).resolved_moe_group_size() == 64
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.MoEMLP(D, F_, E, impl="dense", device="cpu")


def _jax_tree(jcfg, seed=0):
    init_fn, _ = jax_lm_task(jcfg)
    params, _ = init_fn(jax.random.key(seed))
    return jax.tree.map(np.asarray, nn.unbox(params))


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


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_lm_task_loss_aux_and_grads_match_jax(impl):
    overrides = dict(SMALL_MOE, moe_impl=impl, moe_capacity_factor=1.0)
    jcfg = JaxTransformerConfig(dtype=jnp.float32, **overrides)
    tree = _jax_tree(jcfg)
    assert set(tree["layers"]) == {"attn", "attn_norm", "mlp_norm", "moe"}
    tokens = np.random.default_rng(1).integers(0, 128, (2, 48),
                                               dtype=np.int32)
    _, jax_loss_fn = jax_lm_task(jcfg)
    (jloss, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, {}, {"tokens": jnp.asarray(tokens)},
                              jax.random.key(1)), has_aux=True))(tree)

    cfg = TransformerConfig(dtype=torch.float32, **overrides)
    model = load_params(Transformer(cfg, device="meta"),
                        params_from_jax(tree))
    _, loss_fn = lm_task(cfg, device="cpu")
    loss, (metrics, _) = loss_fn(model, {},
                                 {"tokens": torch.from_numpy(tokens)}, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for key in ("perplexity", "moe_aux"):
        np.testing.assert_allclose(metrics[key].item(),
                                   float(jmetrics[key]), err_msg=key,
                                   **LOSS_TOL)
    _assert_trees_close(params_to_jax(model, grads=True),
                        jax.tree.map(np.asarray, jgrads), **LOSS_TOL)
    # The bridge carries the MoE leaves both ways.
    _assert_trees_close(params_to_jax(model), tree, atol=0, rtol=0)


def test_remat_gives_the_same_moe_grads():
    """The MoE aux leaves the checkpointed regions as an output: remat on
    and off give the same loss and gradients (float32)."""
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 128, (2, 32)).astype(np.int64))
    results = []
    for remat in (False, True):
        cfg = TransformerConfig(dtype=torch.float32, remat=remat,
                                **SMALL_MOE)
        model = Transformer(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        _, loss_fn = lm_task(cfg, device="cpu")
        loss, (metrics, _) = loss_fn(model, {}, {"tokens": tokens}, None)
        loss.backward()
        results.append((loss.item(), metrics["moe_aux"].item(),
                        {n: p.grad.clone()
                         for n, p in model.named_parameters()}))
    (l0, a0, g0), (l1, a1, g1) = results
    assert l0 == pytest.approx(l1, abs=1e-6) and a0 == pytest.approx(
        a1, abs=1e-6)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-6,
                                   rtol=1e-6)


def test_adafactor_trainer_trajectory_matches_jax():
    overrides = dict(SMALL_MOE, remat=True)
    jcfg = JaxTransformerConfig(dtype=jnp.float32, **overrides)
    jinit, jloss = jax_lm_task(jcfg)
    jtrainer = JaxTrainer(
        init_fn=jinit, loss_fn=jloss, tx=optax.adafactor(1e-2),
        mesh=MeshSpec(data=1).build(jax.devices()[:1]),
        metrics=JaxMetricsLogger(stream=open("/dev/null", "w")))
    jstate = jtrainer.create_state(seed=0)
    tree = jax.tree.map(np.asarray, jstate.params)

    cfg = TransformerConfig(dtype=torch.float32, **overrides)
    init_fn, loss_fn = lm_task(cfg, device="cpu")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adafactor(1e-2), device="cpu",
                      metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = trainer.create_state(seed=0)
    load_params(state.params, params_from_jax(tree))
    rng = np.random.RandomState(7)
    jstep, step = jtrainer.compile_step(), trainer.compile_step()
    for i in range(5):
        batch = {"tokens": rng.randint(0, 128, size=(2, 32)).astype(
            np.int32)}
        jstate, jm = jstep(jstate, jtrainer.shard_batch(batch))
        state, m = step(state, trainer.shard_batch(batch))
        for key in ("loss", "grad_norm", "perplexity", "moe_aux"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       err_msg=f"step {i} {key}",
                                       **LOSS_TOL)
    _assert_trees_close(params_to_jax(state.params),
                        jax.tree.map(np.asarray, jstate.params),
                        **LOSS_TOL)


TINY_MOE_ARGS = ["--d-model", "32", "--n-layers", "2", "--n-heads", "4",
                 "--n-kv-heads", "2", "--d-ff", "64", "--head-dim", "8",
                 "--vocab-size", "64", "--seq-len", "16",
                 "--batch-size-per-device", "2", "--log-every", "1",
                 "--device", "cpu", "--moe-experts", "4"]


def test_train_lm_moe_checkpoints_pass_the_jax_verifier(tmp_path, capsys):
    """``train_lm --moe-experts 4`` on the CPU trains, reports
    ``moe_aux``, and writes checkpoints that the JAX package's
    ``kubeflow-tpu checkpoints verify`` accepts; a rerun resumes."""
    ckpt = tmp_path / "ckpt"
    flags = TINY_MOE_ARGS + ["--optimizer", "adafactor",
                             "--checkpoint-dir", str(ckpt),
                             "--checkpoint-every", "2"]
    first = train_lm.run(flags + ["--steps", "4"])
    assert first.last_metrics["moe_aux"] > 0
    assert all(np.isfinite(r["loss"]) for r in first.metrics.history)
    assert first.checkpoints.all_steps() == [1, 3]
    for step in (1, 3):
        assert jax_checkpoint.verify_step(ckpt, step) == (True, "")
    assert jax_cli.main(["checkpoints", "verify", str(ckpt)]) == 0
    # The port's CLI gives the JAX one's verdict and report.
    for verb in ("verify", "list"):
        capsys.readouterr()
        port_rc = port_cli.main(["checkpoints", verb, str(ckpt)])
        port_out = capsys.readouterr().out
        assert (port_rc, port_out) == (
            jax_cli.main(["checkpoints", verb, str(ckpt)]),
            capsys.readouterr().out)
        assert port_rc == 0
    second = train_lm.run(flags + ["--steps", "5"])
    assert [r["step"] for r in second.metrics.history] == [4]


def test_train_lm_moe_capacity_factor_reaches_the_model(monkeypatch):
    seen = []
    plain = transformer.lm_task

    def spy(cfg, **kw):
        seen.append(cfg)
        return plain(cfg, **kw)

    monkeypatch.setattr(transformer, "lm_task", spy)
    train_lm.run(TINY_MOE_ARGS + ["--steps", "1",
                                  "--moe-capacity-factor", "2.0"])
    assert seen[0].moe_experts == 4
    assert seen[0].moe_capacity_factor == 2.0
    assert seen[0].moe_impl == "einsum" and seen[0].moe_top_k == 2


def test_decoding_refuses_an_moe_model():
    """Neither package decodes MoE (JAX's ``_layer_step`` reads the dense
    ``mlp`` leaves): ``generate()`` and the engine refuse the config with
    a clear error."""
    cfg = TransformerConfig(dtype=torch.float32, **SMALL_MOE)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="mixture-of-experts"):
        generate(model, torch.zeros((1, 4), dtype=torch.long),
                 DecodeConfig(max_new_tokens=2))
    with pytest.raises(ValueError, match="mixture-of-experts"):
        DecodeEngine(model, DecodeConfig(max_new_tokens=2), slots=1,
                     prefill_len=8)
    # The forward itself (the lm loader's logits) runs.
    logits = model(torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 4, 128) and torch.isfinite(logits).all()
