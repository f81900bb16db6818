"""GPipe pipeline parallelism (kubeflow_tpu_torch/parallel/pipeline.py and
the pipelined LM) against the JAX package's on the same meshes.

The JAX side runs here on the 8 fake CPU devices of tests/conftest.py,
its trainers in threads; the port's ranks are JAX-free subprocesses
(tests/torch_pipeline_worker.py) over gloo, started together with it and
joined with a timeout.  Everything is float32; the port's LM attends
through ``attention="flash"`` (its plain version on the CPU), JAX's
through its dot attention, as tests/test_transformer.py's
``TestPipelineParallel`` does.

  - ``prim`` (4 ranks, S = 4): ``pipelined_scan`` on tests/test_pipeline.py's
    tanh layers (L 8, D 16) against JAX's ``pipelined_scan`` at M 4 and 8:
    outputs within 1e-5, the gradients of x and of every stage's layers
    within 1e-4; ``with_aux`` with an aux that reads each layer's input
    equal to JAX's masked sum (rtol 1e-6, JAX's own bound against its
    sequential reference) with its gradients within 1e-4 (entries up to
    about 16); the forward without autograd equal to the one with; a
    stage whose neighbour never sends fails at its group's timeout;
  - ``pipe2`` (2 ranks): ``TestPipelineParallel``'s LM (2 layers, 4 heads,
    2 kv heads) at data=1, pipeline=2, M 4: logits on both ranks within
    1e-5 of JAX's pipelined ``Transformer`` and of the JAX forward without
    a mesh, with remat too (whose gradients equal those without); loss,
    grad_norm and parameters after 3 adamw and 2 adafactor steps within
    1e-4 of the JAX ``Trainer`` on the same mesh, equal on both ranks;
    dropout 0.1 at 0 microbatches against the trainer without a mesh; a
    checkpoint saved without a mesh restored onto the stages and resumed;
    the MoE LM's loss and aux against the mean over the microbatches
    without a mesh; the refusals (layers or batch that do not divide,
    positions or segment ids); the fused gang (tests/torch_fused_gang.py)
    over the stages at M 2 against the JAX ``FusedTrainer`` on
    pipeline=2 (per-member loss and grad_norm every step and each
    member's parameters within 1e-4, both stages' losses equal, m1
    bit-equal from its stop), and its member checkpoints, every stage's
    layers gathered: JAX's ``verify_step`` accepts them and a ``Trainer``
    without a mesh restores m0 bit for bit;
  - ``pipe8`` (8 ranks): ``TestPipelineParallel``'s data=2, pipeline=2,
    tensor=2 layout: loss and grad_norm over 5 adamw steps within 1e-4
    (relative) and the parameters after them; one layer a stage, ``wq``'s
    heads halved; a gathered checkpoint that JAX's ``verify_step``
    accepts, that a trainer without a mesh restores exactly, and that the
    pipelined trainer resumes; 5 adafactor steps against the JAX
    ``Trainer`` with ``optax.adafactor`` on that mesh (loss and grad_norm
    within 1e-4 relative, the parameters within atol=rtol=1e-4); dropout
    0.1 at 0 microbatches against the trainer without a mesh on the
    global batch (2 sgd steps within 1e-5, pipe2's bounds).  Each rank is
    fed its contiguous rows; the loss exchanges them among the data ranks
    so that the ranks' microbatch m is JAX's, global rows [m B/M, (m+1)
    B/M);
  - ``pipe4`` (4 ranks): pipeline=2, sequence=2 with the ring at M 2
    (JAX's ``test_pipelined_ring_matches_microbatched_sequential``): loss
    and gradients within 1e-5 of JAX's; fsdp=2, pipeline=2: 3 adamw steps
    within 1e-4 of JAX, with one FSDP2 reduce-scatter a block and one at
    the root a step (M forwards and backwards of a block reduce their
    summed gradient once);
  - ``train_lm`` (2 ranks): ``tools/train_lm.py --mesh pipeline=2
    --pipeline-microbatches 4`` through the bootstrap's rendezvous: both
    ranks' losses equal, and within 2e-4 of the entry point without a mesh
    on the same flags (bf16, where the microbatches' GEMMs round otherwise).
"""

import concurrent.futures
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from jax.sharding import PartitionSpec as P

from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import lm_task as jax_lm_task
from kubeflow_tpu.parallel import DEFAULT_RULES as JAX_RULES
from kubeflow_tpu.parallel import MeshSpec as JaxMeshSpec
from kubeflow_tpu.parallel import PIPELINE as JAX_PIPELINE
from kubeflow_tpu.parallel.pipeline import microbatch as jax_microbatch
from kubeflow_tpu.parallel.pipeline import pipelined_scan as jax_scan
from kubeflow_tpu.parallel.pipeline import unmicrobatch as jax_unmicrobatch
from kubeflow_tpu.runtime.checkpoint import verify_step
from kubeflow_tpu.runtime.metrics import MetricsLogger as JaxMetricsLogger
from kubeflow_tpu.runtime.train import Trainer as JaxTrainer
from kubeflow_tpu_torch.models.convert import params_from_jax, params_to_jax
from kubeflow_tpu_torch.models.transformer import TransformerConfig, lm_task
from kubeflow_tpu_torch.parallel import tensor as tp
from kubeflow_tpu_torch.parallel.pipeline import Stage, microbatch
from kubeflow_tpu_torch.runtime import optim
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks
from kubeflow_tpu_torch.tools import train_lm
from test_torch_adafactor import sharded_against_optax
from torch_fused_gang import GANG, GANG_STEPS
from torch_fused_jax import check_members, check_step, jax_gang

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_pipeline_worker.py")
# tests/test_transformer.py's CFG at 2 layers, TestPipelineParallel's LM.
PP = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, head_dim=8, max_seq_len=32)
MICRO, BATCH, SEQ, STEPS = 4, 8, 16, 5
PRIM_L, PRIM_D = 8, 16
# The fused gang over pipe2's stages (tests/torch_fused_gang.py) at M 2.
GANG_OVER = dict(pipeline_microbatches=2)
JOBS = {"prim": 4, "pipe2": 2, "pipe8": 8, "pipe4": 4, "train_lm": 2}
JOB_TIMEOUT_S = 150
TOL = dict(atol=1e-4, rtol=1e-4)
TRAIN_LM_ARGV = [
    "--device", "cpu", "--d-model", "32", "--n-layers", "2", "--n-heads",
    "4", "--n-kv-heads", "2", "--d-ff", "64", "--head-dim", "8",
    "--vocab-size", "64", "--seq-len", "16", "--batch-size-per-device",
    "8", "--steps", "3", "--log-every", "1", "--max-restarts", "0"]
PIPE_FLAGS = ["--mesh", "pipeline=2", "--pipeline-microbatches", "4"]


def _batches():
    rng = np.random.RandomState(11)
    return [rng.randint(0, PP["vocab_size"], size=(BATCH, SEQ))
            .astype(np.int32) for _ in range(STEPS)]


def _ring_tokens():
    return np.random.RandomState(4).randint(
        0, PP["vocab_size"], (4, 32)).astype(np.int32)


def _prim_inputs():
    rng = np.random.RandomState(0)
    return {"w": (rng.randn(PRIM_L, PRIM_D, PRIM_D) * 0.3).astype(np.float32),
            "b": (rng.randn(PRIM_L, PRIM_D) * 0.1).astype(np.float32),
            "x": rng.randn(32, PRIM_D).astype(np.float32),
            "x_aux": rng.randn(16, PRIM_D).astype(np.float32)}


# -- the JAX side -------------------------------------------------------------


def _jax_mesh(**spec):
    n = int(np.prod(list(spec.values())))
    return JaxMeshSpec(**spec).build(jax.devices()[:n])


def _jax_cfg(**over):
    return JaxConfig(dtype=jnp.float32, **dict(PP, **over))


def _jax_trainer(tx, **spec):
    mesh = _jax_mesh(**spec)
    init_fn, loss_fn = jax_lm_task(_jax_cfg(pipeline_microbatches=MICRO),
                                   mesh=mesh)
    return JaxTrainer(init_fn=init_fn, loss_fn=loss_fn, tx=tx, mesh=mesh,
                      metrics=JaxMetricsLogger(stream=open("/dev/null", "w")))


def _jax_run(tx, steps, **spec):
    tr = _jax_trainer(tx, **spec)
    state = tr.create_state(seed=0)
    step = tr.compile_step()
    losses, norms = [], []
    for b in _batches()[:steps]:
        state, m = step(state, tr.shard_batch({"tokens": b}))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, state.params)


def _layer(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _jax_prim(inputs):
    """tests/test_pipeline.py's pipelined tanh stack over 4 stages: outputs
    and gradients of their sum at M 4 and 8, and the aux thread at M 4."""
    mesh = _jax_mesh(data=1, pipeline=4)
    params = (jnp.asarray(inputs["w"]), jnp.asarray(inputs["b"]))
    out = {}

    def piped(n_micro, with_aux, fn):
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=((P(JAX_PIPELINE), P(JAX_PIPELINE)), P()),
            out_specs=(P(), P()) if with_aux else P())
        def run(p, x):
            res = jax_scan(fn, p, jax_microbatch(x, n_micro),
                           with_aux=with_aux)
            if with_aux:
                return jax_unmicrobatch(res[0]), res[1]
            return jax_unmicrobatch(res)
        return jax.jit(run)

    x = jnp.asarray(inputs["x"])
    for n_micro in (4, 8):
        run = piped(n_micro, False, _layer)
        (dw, db), dx = jax.grad(lambda p, v: run(p, v).sum(),
                                argnums=(0, 1))(params, x)
        out[n_micro] = {"y": np.asarray(run(params, x)), "dx": np.asarray(dx),
                        "dw": np.asarray(dw), "db": np.asarray(db)}

    def with_aux(layer, a):
        return _layer(layer, a), jnp.sum(a * a)

    run = piped(4, True, with_aux)
    x = jnp.asarray(inputs["x_aux"])
    y, aux = run(params, x)
    (dw, db), dx = jax.grad(lambda p, v: run(p, v)[1],
                            argnums=(0, 1))(params, x)
    out["aux"] = {"y": np.asarray(y), "aux": float(aux), "dx": np.asarray(dx),
                  "dw": np.asarray(dw), "db": np.asarray(db)}
    return out


def _jax_logits(tree):
    """The pipelined Transformer's logits at data=1, pipeline=2 (with and
    without remat) and the forward without a mesh, on the first batch."""
    mesh = _jax_mesh(data=1, pipeline=2)
    toks = jnp.asarray(_batches()[0])
    out = {"plain": np.asarray(JaxTransformer(_jax_cfg()).apply(
        {"params": tree}, toks))}
    with mesh, nn.logical_axis_rules(list(JAX_RULES)):
        for name, remat in (("piped", False), ("remat", True)):
            model = JaxTransformer(
                _jax_cfg(pipeline_microbatches=MICRO, remat=remat),
                mesh=mesh)
            out[name] = np.asarray(jax.jit(
                lambda v, t, m=model: m.apply(v, t))({"params": tree}, toks))
    return out


def _jax_ring(tree):
    """JAX's pipelined ring loss and gradients at pipeline=2, sequence=2,
    M 2 (test_pipelined_ring_matches_microbatched_sequential's case)."""
    mesh = _jax_mesh(pipeline=2, sequence=2)
    _, loss_fn = jax_lm_task(
        _jax_cfg(attention="ring", pipeline_microbatches=2), mesh=mesh)
    toks = jnp.asarray(_ring_tokens())
    with mesh, nn.logical_axis_rules(list(JAX_RULES)):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, {}, {"tokens": toks},
                              jax.random.key(0))[0]))(tree)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The port's jobs run while the JAX side computes here."""
    work = tmp_path_factory.mktemp("pipeline")
    tree = jax.tree.map(np.asarray, _jax_trainer(
        optax.adamw(1e-3), data=1, pipeline=2).create_state(seed=0).params)
    prim = _prim_inputs()
    torch.save({"cfg": dict(PP, attention="flash", pipeline_microbatches=MICRO),
                "params": params_from_jax(tree),
                "batches": [torch.from_numpy(b) for b in _batches()],
                "ring_tokens": torch.from_numpy(_ring_tokens()),
                "prim_w": torch.from_numpy(prim["w"]),
                "prim_b": torch.from_numpy(prim["b"]),
                "prim_x": torch.from_numpy(prim["x"]),
                "prim_x_aux": torch.from_numpy(prim["x_aux"]),
                "train_lm_argv": TRAIN_LM_ARGV + PIPE_FLAGS,
                "gang_cfg": GANG_OVER},
               work / "inputs.pt")
    with concurrent.futures.ThreadPoolExecutor(len(JOBS) + 7) as pool:
        futures = {name: pool.submit(run_ranks, [WORKER, name, str(work)], n,
                                     timeout_s=JOB_TIMEOUT_S, cwd=str(REPO),
                                     threads=1)
                   for name, n in JOBS.items()}
        jax_futures = {
            "prim": pool.submit(_jax_prim, prim),
            "logits": pool.submit(_jax_logits, tree),
            "ring": pool.submit(_jax_ring, tree),
            "adamw2": pool.submit(_jax_run, optax.adamw(1e-3), 3, data=1,
                                  pipeline=2),
            "adafactor2": pool.submit(_jax_run, optax.adafactor(1e-3), 2,
                                      data=1, pipeline=2),
            "adamw8": pool.submit(_jax_run, optax.adamw(1e-3), STEPS,
                                  data=2, pipeline=2, tensor=2),
            "adafactor8": pool.submit(_jax_run, optax.adafactor(1e-3),
                                      STEPS, data=2, pipeline=2, tensor=2),
            "fsdp": pool.submit(_jax_run, optax.adamw(1e-3), 3, fsdp=2,
                                pipeline=2),
            "gang": pool.submit(jax_gang, dict(PP, **GANG_OVER), GANG,
                                _batches()[:GANG_STEPS], pipeline=2),
        }
        jax_out = {name: f.result() for name, f in jax_futures.items()}
        jax_out["init"] = tree
        for future in futures.values():
            check_ranks(future.result())
    jobs = {name: [torch.load(work / f"{name}-rank{r}.pt",
                              weights_only=True) for r in range(n)]
            for name, n in JOBS.items()}
    jobs["dir"] = work
    return jax_out, jobs


@pytest.fixture(scope="module")
def jax_side(both):
    return both[0]


@pytest.fixture(scope="module")
def jobs(both):
    return both[1]


def _tree_of(params):
    """A port name -> tensor dict of the whole model as the JAX tree."""
    init_fn, _ = lm_task(TransformerConfig(dtype=torch.float32, **PP),
                         device="cpu")
    model, _ = init_fn(torch.Generator().manual_seed(0))
    model.load_state_dict(params)
    return params_to_jax(model)


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf, flat_want[path],
                                   err_msg=jax.tree_util.keystr(path), **tol)


# -- the primitive ------------------------------------------------------------


def test_microbatch_divisibility():
    with pytest.raises(ValueError, match="divisible"):
        microbatch(torch.zeros((10, 4)), 3)


def _prim_grads(ranks, key):
    """x's gradient (rank 0's) and every stage's layer gradients joined in
    stage order."""
    return (ranks[0][key]["dx"],
            torch.cat([r[key]["dw"] for r in ranks]).numpy(),
            torch.cat([r[key]["db"] for r in ranks]).numpy())


@pytest.mark.parametrize("n_micro", [4, 8])
def test_prim_outputs_match_jax(jobs, jax_side, n_micro):
    want = jax_side["prim"][n_micro]["y"]
    for r in jobs["prim"]:
        np.testing.assert_allclose(r[n_micro]["y"].numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n_micro", [4, 8])
def test_prim_gradients_match_jax(jobs, jax_side, n_micro):
    want = jax_side["prim"][n_micro]
    dx, dw, db = _prim_grads(jobs["prim"], n_micro)
    np.testing.assert_allclose(dx.numpy(), want["dx"], atol=1e-4)
    np.testing.assert_allclose(dw, want["dw"], atol=1e-4)
    np.testing.assert_allclose(db, want["db"], atol=1e-4)
    for r in jobs["prim"]:
        torch.testing.assert_close(r[n_micro]["dx"], dx, atol=0, rtol=0)


def test_prim_aux_is_the_masked_sum(jobs, jax_side):
    """The aux reads each layer's input, so a bubble step counted would
    move it by O(1); every rank holds the total."""
    want = jax_side["prim"]["aux"]
    for r in jobs["prim"]:
        np.testing.assert_allclose(float(r["aux"]["aux"]), want["aux"],
                                   rtol=1e-6)
        np.testing.assert_allclose(r["aux"]["y"].numpy(), want["y"],
                                   atol=1e-5)


def test_prim_aux_gradients_match_jax(jobs, jax_side):
    want = jax_side["prim"]["aux"]
    dx, dw, db = _prim_grads(jobs["prim"], "aux")
    np.testing.assert_allclose(dx.numpy(), want["dx"], atol=1e-4)
    np.testing.assert_allclose(dw, want["dw"], atol=1e-4)
    np.testing.assert_allclose(db, want["db"], atol=1e-4)


def test_prim_dead_stage_fails_within_the_timeout(jobs):
    """A stage whose neighbour never sends raises the group's timeout
    (2 s) instead of hanging the job."""
    message, seconds = jobs["prim"][1]["dead_stage"]
    assert "Timed out" in message, message
    assert seconds < 30


def test_adafactor_refuses_a_stage_split_of_a_factored_layer_dim(
        monkeypatch):
    """A stacked leaf whose whole [L, ...] factors over its layer dim (L
    256 and width 200, both past 128), split over 2 stages of 128
    layers, beside a small one: each stage's parameters and statistics
    after 3 updates are its rows of optax's on the whole leaves (the
    stages as threads, tests/test_torch_adafactor.py); the statistic
    that keeps the layer dim is the stage's rows, the one that reduces it
    whole on both stages."""
    def split(coords, leaf):
        index, group = coords["pipeline"]
        return None, Stage(index, 2, 128, group)

    results = sharded_against_optax(
        monkeypatch, {"layers.w": (256, 200), "layers.small": (256, 4)},
        {"pipeline": 2}, split)
    for local, _, state in results.values():
        assert tp.shard_of(state.v_col["layers.w"]).axis == "pipeline"
        assert tp.shard_of(state.v_row["layers.w"]) is None
        assert tp.shard_of(state.v["layers.small"]).count == 2
        assert len(local) == 256


def test_prim_forward_without_autograd(jobs):
    for r in jobs["prim"]:
        torch.testing.assert_close(r["no_grad_y"], r[4]["y"], atol=0, rtol=0)


# -- the pipelined LM ----------------------------------------------------------


@pytest.mark.parametrize("variant,want", [("logits", "piped"),
                                          ("logits", "plain"),
                                          ("remat_logits", "remat"),
                                          ("remat_logits", "plain")])
def test_pipe2_logits_match_jax(jobs, jax_side, variant, want):
    for r in jobs["pipe2"]:
        np.testing.assert_allclose(r[variant].numpy(),
                                   jax_side["logits"][want], atol=1e-5)


def test_pipe2_remat_gradients_equal_plain(jobs):
    for r in jobs["pipe2"]:
        _assert_trees_close(r["remat_grads"], r["plain_grads"], atol=1e-6,
                            rtol=1e-6)


def test_pipe2_stage_holds_its_layer(jobs):
    """Each of the two stages holds one of the two layers, as its
    ``layers.0``."""
    for r in jobs["pipe2"]:
        layers = {n.split(".")[1] for n in r["local_names"]
                  if n.startswith("layers.")}
        assert layers == {"0"}
    assert [r["stage"] for r in jobs["pipe2"]] == [0, 1]


@pytest.mark.parametrize("opt,steps", [("adamw", 3), ("adafactor", 2)])
def test_pipe2_steps_match_jax(jobs, jax_side, opt, steps):
    losses, norms, params = jax_side[f"{opt}2"]
    for r in jobs["pipe2"]:
        np.testing.assert_allclose(r[f"{opt}_losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(r[f"{opt}_norms"], norms, rtol=1e-4)
        assert len(r[f"{opt}_losses"]) == steps
    _assert_trees_close(_tree_of(jobs["pipe2"][0][f"{opt}_params"]), params,
                        **TOL)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_pipe2_stages_agree(jobs, opt):
    """Both stages report the same loss and grad_norm, and after the
    steps hold the same embedding, final norm and gathered stack."""
    first, second = jobs["pipe2"]
    assert first[f"{opt}_losses"] == second[f"{opt}_losses"]
    assert first[f"{opt}_norms"] == second[f"{opt}_norms"]
    for name, t in first[f"{opt}_params"].items():
        torch.testing.assert_close(t, second[f"{opt}_params"][name], atol=0,
                                   rtol=0)


def test_pipe2_dropout_matches_no_mesh(jobs):
    for r in jobs["pipe2"]:
        (m_loss, m_norm, m_params), (p_loss, p_norm, p_params) = r["dropout"]
        np.testing.assert_allclose(m_loss, p_loss, rtol=1e-5)
        np.testing.assert_allclose(m_norm, p_norm, rtol=1e-5)
        for name, t in m_params.items():
            torch.testing.assert_close(t, p_params[name], atol=1e-5,
                                       rtol=1e-5)


def test_pipelined_trainer_restores_no_mesh_checkpoint(jobs):
    """A save without a mesh restores onto pipeline=2's stages: the whole
    parameters as saved, each stage holding its one layer, and the next
    step's loss that of the run without a mesh."""
    for r in jobs["pipe2"]:
        assert r["restored_step"] == 2
        assert r["restored_tree_layers"] == 1
        for name, t in r["restored_params"].items():
            torch.testing.assert_close(t, r["saved_params"][name], atol=0,
                                       rtol=0)
        np.testing.assert_allclose(r["resumed_loss"], r["adamw_losses"][2],
                                   rtol=1e-5)


@pytest.mark.parametrize("case,want", [
    ("moe", None),
    ("layers", "ValueError: n_layers=3 not divisible by pipeline=2 stages"),
    ("batch", "ValueError: batch 6 not divisible by pipeline_microbatches=4"),
    ("positions", "ValueError: the pipelined layer stack supports only "
                  "default positions"),
    ("segments", "ValueError: the pipelined layer stack supports only "
                 "default positions and no segment_ids")])
def test_pipe2_refusals(jobs, case, want):
    """What the stages refuse; MoE, refused before the expert axis came
    (``want`` None), trains: its pipelined loss and aux are the mean of
    the loss and aux without a mesh on each microbatch (rtol 1e-5, JAX's
    test_pipelined_moe_matches_microbatched_sequential)."""
    for r in jobs["pipe2"]:
        if want is None:
            (loss, aux), (ref_loss, ref_aux) = r[case]
            np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
            np.testing.assert_allclose(aux, ref_aux, rtol=1e-5)
            assert aux > 0
            continue
        assert __import__("re").match(want, r["refusals"][case]), \
            r["refusals"][case]


def test_pipeline_microbatches_refuse_dropout():
    with pytest.raises(ValueError, match="dropout_rate=0"):
        TransformerConfig(pipeline_microbatches=2, dropout_rate=0.1)


def test_train_lm_refuses_pipeline_without_microbatches(capsys):
    with pytest.raises(SystemExit) as exc:
        train_lm.run(TRAIN_LM_ARGV + ["--mesh", "pipeline=2"])
    assert exc.value.code == 2
    assert "--mesh pipeline>1 requires --pipeline-microbatches>0" in \
        capsys.readouterr().err


def test_train_lm_refuses_expert_with_item_21():
    """The expert axis trains (tests/test_torch_moe_mesh.py), with
    adafactor too (refused over expert slices before it was ported): a
    one-rank ``--mesh expert=1 --moe-experts 4 --optimizer adafactor``
    gives the losses of no mesh."""
    moe = TRAIN_LM_ARGV + ["--moe-experts", "4", "--optimizer", "adafactor"]
    got, want = (train_lm.run(moe + flag).metrics.history
                 for flag in (["--mesh", "expert=1"], []))
    assert [h["loss"] for h in got] == [h["loss"] for h in want]


# -- data x pipeline x tensor ---------------------------------------------------


@pytest.mark.parametrize("step", range(STEPS))
def test_pipe8_loss_and_grad_norm_match_jax(jobs, jax_side, step):
    losses, norms, _ = jax_side["adamw8"]
    for r in jobs["pipe8"]:
        np.testing.assert_allclose(r["adamw_losses"][step], losses[step],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["adamw_norms"][step], norms[step],
                                   rtol=1e-4)


def test_pipe8_params_match_jax(jobs, jax_side):
    _assert_trees_close(_tree_of(jobs["pipe8"][0]["adamw_params"]),
                        jax_side["adamw8"][2], **TOL)


def test_pipe8_stage_shapes(jobs):
    """One of the two layers a stage, its ``wq`` with half of the 4 heads
    (the tensor axis); the embedding keeps half the vocab."""
    e, h, d, v = 32, 4, 8, 64
    for r in jobs["pipe8"]:
        shapes = r["shard_shapes"]
        assert {n.split(".")[1] for n in shapes
                if n.startswith("layers.")} == {"0"}
        assert shapes["layers.0.attn.wq"] == (e, h // 2, d)
        assert shapes["embed"] == (v // 2, e)


def test_pipe8_checkpoint_verifies_in_jax(jobs):
    for step in (0, 1):
        assert verify_step(jobs["dir"] / "ckpt", step) == (True, ""), step


def test_no_mesh_trainer_restores_pipelined_checkpoint(jobs):
    """The gathered save holds every layer whole, in the JAX layout: a
    trainer without a mesh restores step 1 as the pipelined trainer's
    parameters after 2 steps, bit for bit."""
    init_fn, loss_fn = lm_task(TransformerConfig(dtype=torch.float32, **PP),
                               device="cpu")
    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=optim.adamw(1e-3),
                 device="cpu",
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = CheckpointManager(jobs["dir"] / "ckpt").restore(
        tr.create_state(seed=3), step=1)
    assert state.step == 2 and state.opt_state.count == 2
    assert len(state.opt_state.mu) == len(list(state.params.parameters()))
    for name, p in state.params.named_parameters():
        torch.testing.assert_close(p.detach(),
                                   jobs["pipe8"][0]["ckpt_params"][name],
                                   atol=0, rtol=0)


@pytest.mark.parametrize("step", range(STEPS))
def test_pipe8_adafactor_matches_jax(jobs, jax_side, step):
    losses, norms, _ = jax_side["adafactor8"]
    for r in jobs["pipe8"]:
        np.testing.assert_allclose(r["adafactor_losses"][step], losses[step],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["adafactor_norms"][step], norms[step],
                                   rtol=1e-4)


def test_pipe8_adafactor_params_match_jax(jobs, jax_side):
    _assert_trees_close(_tree_of(jobs["pipe8"][0]["adafactor_params"]),
                        jax_side["adafactor8"][2], **TOL)


def test_pipe8_dropout_matches_no_mesh(jobs):
    """Dropout 0.1 under data=2 x pipeline=2 x tensor=2 (0 microbatches)
    against the trainer without a mesh on the global batch, pipe2's
    bounds."""
    for r in jobs["pipe8"]:
        (m_loss, m_norm, m_params), (p_loss, p_norm, p_params) = r["dropout"]
        np.testing.assert_allclose(m_loss, p_loss, rtol=1e-5)
        np.testing.assert_allclose(m_norm, p_norm, rtol=1e-5)
        for name, t in m_params.items():
            torch.testing.assert_close(t, p_params[name], atol=1e-5,
                                       rtol=1e-5)


def test_pipe8_resumes_its_checkpoint(jobs):
    for r in jobs["pipe8"]:
        np.testing.assert_allclose(r["resumed_loss"], r["adamw_losses"][2],
                                   rtol=1e-6)


# -- ring and fsdp inside the stages --------------------------------------------


def test_pipe4_ring_loss_matches_jax(jobs, jax_side):
    want, _ = jax_side["ring"]
    for r in jobs["pipe4"]:
        np.testing.assert_allclose(r["ring_loss"], want, rtol=1e-5)


def test_pipe4_ring_gradients_match_jax(jobs, jax_side):
    _, grads = jax_side["ring"]
    for r in jobs["pipe4"]:
        _assert_trees_close(r["ring_grads"], grads, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("step", range(3))
def test_pipe4_fsdp_steps_match_jax(jobs, jax_side, step):
    losses, norms, _ = jax_side["fsdp"]
    for r in jobs["pipe4"]:
        np.testing.assert_allclose(r["fsdp_losses"][step], losses[step],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["fsdp_norms"][step], norms[step],
                                   rtol=1e-4)


def test_pipe4_fsdp_params_match_jax(jobs, jax_side):
    _assert_trees_close(_tree_of(jobs["pipe4"][0]["fsdp_params"]),
                        jax_side["fsdp"][2], **TOL)


def test_pipe4_fsdp_reduces_each_block_once_a_step(jobs):
    """A block run for 4 microbatches reduce-scatters its summed gradient
    once a step, as does the root (the embedding, final norm)."""
    for r in jobs["pipe4"]:
        assert r["reduce_scatters"] == [r["fsdp_blocks"] + 1] * 3


# -- the entry point -----------------------------------------------------------


def test_train_lm_pipeline_matches_no_mesh(jobs):
    """tools/train_lm.py at --mesh pipeline=2 --pipeline-microbatches 4
    over gloo: both ranks report one loss history, that of the entry point
    without a mesh on the same flags within 2e-4 (bf16: a microbatch's
    GEMMs round otherwise than the whole batch's)."""
    ranks = jobs["train_lm"]
    assert [r["world"] for r in ranks] == [2, 2]
    losses = [[h["loss"] for h in r["history"]] for r in ranks]
    assert losses[0] == losses[1]
    plain = train_lm.run(TRAIN_LM_ARGV)
    want = [h["loss"] for h in plain.metrics.history]
    assert len(want) == 3
    np.testing.assert_allclose(losses[0], want, rtol=2e-4)


# -- the fused trainer over the stages (pipe2) ---------------------------------


@pytest.mark.parametrize("step", range(GANG_STEPS))
def test_fused_gang_over_stages_steps_match_jax(jobs, jax_side, step):
    """Every rank's per-member loss and grad_norm of each fused step at
    pipeline=2, M 2 (the schedule run once on the members' stack, each
    stage mapping its layers over the members' parameters) against JAX's
    ``FusedTrainer`` on the same mesh shape; both stages' losses equal."""
    check_step([r["gang"] for r in jobs["pipe2"]], jax_side["gang"][0], step,
               **TOL)


def test_fused_gang_over_stages_members_match_jax(jobs, jax_side):
    """Each member's whole parameters (every stage's layers gathered)
    after the steps against JAX's, and m1 bit-equal on both stages from
    its stop to the end."""
    check_members([r["gang"] for r in jobs["pipe2"]], jax_side["gang"][1],
                  dict(PP, **GANG_OVER), [GANG_STEPS, GANG[1]["stop_step"]],
                  **TOL)


def test_fused_gang_stage_checkpoint(jobs):
    """The member checkpoints the gang's fit saved over pipeline=2 (every
    stage's layers gathered under their global names): JAX's
    ``verify_step`` accepts each member's last step, and a ``Trainer``
    without a mesh on default_tx_factory(lr) restores m0's bit for bit."""
    ckdir = jobs["dir"] / "ckpt_gang_pipe"
    for m in GANG:
        last = m.get("stop_step", GANG_STEPS) - 1
        assert verify_step(ckdir / m["name"], last) == (True, ""), m["name"]
    init_fn, loss_fn = lm_task(TransformerConfig(dtype=torch.float32, **PP),
                               device="cpu")
    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                 tx=optim.default_tx_factory(GANG[0]["lr"]), device="cpu",
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = CheckpointManager(ckdir / "m0").restore(
        tr.create_state(seed=5), step=GANG_STEPS - 1)
    assert state.step == GANG_STEPS
    assert state.opt_state.inner.count == GANG_STEPS
    saved = jobs["pipe2"][0]["gang"]["params"][0]
    assert set(saved) == {n for n, _ in state.params.named_parameters()}
    for name, p in state.params.named_parameters():
        assert torch.equal(p.detach(), saved[name]), name
