"""Parallel training of the LM over a mesh of processes
(kubeflow_tpu_torch/runtime/train.py ``Trainer(mesh=...)``, FSDP2 and the
ring over gloo) against the JAX ``Trainer`` on the same mesh.

The configuration is the JAX package's ``TestFsdpDataMesh``
(tests/test_train.py): data=2, fsdp=2, sequence=2, ring attention, a
2-layer float32 LM (d_model 32, 2 heads of 16, d_ff 64, vocab 128) on
global batches of 8 x 32 tokens.  The JAX trainer runs here on the 8
fake CPU devices of tests/conftest.py; the port's 8 ranks are JAX-free
subprocesses (tests/torch_mesh_train_worker.py) that start from the JAX
trainer's initial weights, converted, each feeding its own rows (its
data x fsdp shard) and its own sequence shard.  Three jobs, started
together and joined with a timeout, hold every result these tests read:

  - ``mesh8`` (8 ranks): per-step loss and grad_norm over 5 adamw steps
    within 1e-4 (relative) of JAX, and the parameters after them within
    atol=rtol=1e-4; parameters within 1e-4 after 3 sgd steps; shard
    shapes as JAX's ``test_params_fsdp_sharded`` (each weight's
    ``embed`` dim split over fsdp) and adamw's moments sharded as their
    parameters; identical rows on every data shard giving the loss and
    grad_norm of those rows on one device (the averaging over the data
    axis) and of JAX within 1e-5; a checkpoint of 8 ranks that JAX's
    ``verify_step`` accepts, that a trainer without a mesh restores to
    the mesh's parameters exactly, and that the mesh trainer resumes to
    step 2's loss within 1e-6; remat (the ring outside the checkpointed
    regions, FSDP2 gathering for the recompute) giving the same losses
    within 1e-5; 5 adafactor steps over FSDP2's shards against the JAX
    ``Trainer`` with ``optax.adafactor`` (loss and grad_norm within 1e-4
    relative, the parameters within atol=rtol=1e-4);
  - ``world1`` (1 rank): a one-rank mesh trainer (FSDP2 over a group of
    one) bit-equal to the trainer without a mesh over 3 steps, in loss,
    grad_norm and parameters, with flash and remat, and with the ring
    (a ring of one) against flash;
  - ``train_lm`` (2 ranks): tools/train_lm.py at ``--mesh fsdp=2``
    through runtime/bootstrap.py's rendezvous from ``KFT_*`` variables
    (the twin of tests/test_bootstrap_rendezvous.py's sharded
    training): both ranks end at the same loss after 3 steps;
  - ``tensor8`` (8 ranks): JAX's ``test_tp_sharded_params_and_loss_
    decreases`` layout, data=2, fsdp=2, tensor=2, with flash (its plain
    version here), against the JAX ``Trainer`` on the same mesh: loss
    and grad_norm over 5 adamw steps within 1e-4 (relative), the
    parameters after them within atol=rtol=1e-4; shard shapes as JAX's
    specs (``wi``'s mlp dim over tensor, its embed dim over fsdp); a
    gathered checkpoint that JAX's ``verify_step`` accepts and that a
    trainer without a mesh restores exactly; 5 adafactor steps over the
    tensor slices and FSDP2's shards against the JAX ``Trainer`` with
    ``optax.adafactor`` (as mesh8's); adafactor at a width whose
    matrices factor (vocab 256, d_model 128, d_ff 256, untied), each
    split over fsdp and tensor, against the trainer
    without a mesh on the global batch over 3 steps (loss and grad_norm
    within 1e-5 relative, the parameters within atol=rtol=1e-5), and its
    checkpoint after 2 steps, gathered to the JAX layout: JAX's
    ``verify_step`` accepts it, and a trainer without a mesh restores it
    and takes the third step to the mesh's loss and parameters (1e-5);
  - ``tensor2`` (2 ranks): tensor=2 alone with an untied unembed (the
    vocab-parallel ``w_out``), the chunked CE and dropout 0.1, against
    the trainer without a mesh from the same seed: loss and grad_norm
    over 3 adamw steps within 1e-5 (relative), parameters within
    atol=rtol=1e-5, with and without remat; both tensor ranks keep the
    same dropout mask; a checkpoint saved without a mesh restores onto
    the tensor slices and resumes to the third step's loss;
  - ``dropout4`` (4 ranks): data=2, sequence=2 with the ring at dropout
    0.1 against the trainer without a mesh on the global batch: loss,
    grad_norm and parameters over 2 sgd steps within 1e-5; each rank's
    mask is its rows and positions of the one global draw, so the data
    ranks' masks differ and so do the sequence shards';
  - ``train_lm_tensor`` (2 ranks): tools/train_lm.py at ``--mesh
    model=2`` (``tensor``'s other name): both ranks' losses those of the
    entry point without a mesh on the same flags within 2e-4 (bf16).
"""

import concurrent.futures
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import lm_task as jax_lm_task
from kubeflow_tpu.parallel import MeshSpec as JaxMeshSpec
from kubeflow_tpu.runtime.checkpoint import verify_step
from kubeflow_tpu.runtime.metrics import MetricsLogger as JaxMetricsLogger
from kubeflow_tpu.runtime.train import Trainer as JaxTrainer
from kubeflow_tpu_torch.models.convert import (
    load_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.transformer import TransformerConfig, lm_task
from kubeflow_tpu_torch.runtime import optim
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks
from kubeflow_tpu_torch.tools import train_lm

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_mesh_train_worker.py")
SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
             n_kv_heads=2, d_ff=64, head_dim=16, max_seq_len=32)
BATCH, SEQ, STEPS, SGD_LR = 8, 32, 5, 0.1
JOB_TIMEOUT_S = 240
JOBS = {"mesh8": 8, "world1": 1, "train_lm": 2, "tensor8": 8, "tensor2": 2,
        "dropout4": 4, "train_lm_tensor": 2}
TOL = dict(atol=1e-4, rtol=1e-4)
NO_MESH_TOL = dict(atol=1e-5, rtol=1e-5)
TRAIN_LM_ARGV = [
    "-m", "kubeflow_tpu_torch.tools.train_lm", "--device", "cpu",
    "--mesh", "fsdp=2", "--d-model", "32", "--n-layers", "2",
    "--n-heads", "2", "--n-kv-heads", "2", "--d-ff", "64",
    "--head-dim", "16", "--vocab-size", "128", "--seq-len", "32",
    "--batch-size-per-device", "2", "--steps", "3", "--log-every", "1",
    "--max-restarts", "0"]


def _batches():
    rng = np.random.RandomState(11)
    return [rng.randint(0, SMALL["vocab_size"], size=(BATCH, SEQ))
            .astype(np.int32) for _ in range(STEPS)]


def _same_rows():
    return np.tile(np.arange(SEQ, dtype=np.int32)[None]
                   % SMALL["vocab_size"], (BATCH, 1))


def _jax_trainer(tx, tensor=False):
    """The JAX trainer on mesh8's layout with the ring, or (``tensor``)
    on tensor8's with flash."""
    spec = (dict(data=2, fsdp=2, tensor=2) if tensor
            else dict(data=2, fsdp=2, sequence=2))
    mesh = JaxMeshSpec(**spec).build(jax.devices())
    cfg = JaxConfig(dtype=jnp.float32,
                    attention="flash" if tensor else "ring", **SMALL)
    init_fn, loss_fn = jax_lm_task(cfg, mesh=mesh)
    return JaxTrainer(init_fn=init_fn, loss_fn=loss_fn, tx=tx, mesh=mesh,
                      metrics=JaxMetricsLogger(stream=open("/dev/null", "w")))


def _jax_run(tx, batches, tensor=False):
    tr = _jax_trainer(tx, tensor)
    state = tr.create_state(seed=0)
    step = tr.compile_step()
    losses, norms = [], []
    for b in batches:
        state, m = step(state, tr.shard_batch({"tokens": b}))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, state.params)


def _start_jobs(work, init_tree, pool):
    """Write the jobs' inputs and start them on ``pool``: name -> future
    of its ranks' results."""
    torch.save({"cfg": dict(SMALL, attention="ring"),
                "params": params_from_jax(init_tree),
                "batches": [torch.from_numpy(b) for b in _batches()],
                "same_rows": torch.from_numpy(_same_rows()),
                "sgd_lr": SGD_LR,
                "train_lm_argv": TRAIN_LM_ARGV[2:],
                "train_lm_tensor_argv": _tensor_argv()[2:]},
               work / "inputs.pt")
    return {name: pool.submit(run_ranks, [WORKER, name, str(work)], n,
                              timeout_s=JOB_TIMEOUT_S, cwd=str(REPO),
                              threads=1)
            for name, n in JOBS.items()}


def _tensor_argv():
    argv = list(TRAIN_LM_ARGV)
    argv[argv.index("--mesh") + 1] = "model=2"
    return argv


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The port's jobs run while the JAX trainers step here (adafactor's
    two in threads beside the rest)."""
    work = tmp_path_factory.mktemp("mesh_train")
    tree = jax.tree.map(np.asarray,
                        _jax_trainer(optax.adamw(1e-3)).create_state(
                            seed=0).params)
    with concurrent.futures.ThreadPoolExecutor(len(JOBS) + 2) as pool:
        futures = _start_jobs(work, tree, pool)
        adafactor = {tensor: pool.submit(_jax_run, optax.adafactor(1e-3),
                                         _batches(), tensor=tensor)
                     for tensor in (False, True)}
        jax_out = {"init": tree}
        (jax_out["adamw_losses"], jax_out["adamw_norms"],
         jax_out["adamw_params"]) = _jax_run(optax.adamw(1e-3), _batches())
        _, _, jax_out["sgd_params"] = _jax_run(optax.sgd(SGD_LR),
                                               _batches()[:3])
        jax_out["same_rows_losses"], jax_out["same_rows_norms"], _ = \
            _jax_run(optax.sgd(SGD_LR), [_same_rows()])
        tr = _jax_trainer(optax.adamw(1e-3), tensor=True)
        jax_out["tensor_wi_spec"] = tuple(
            tr.create_state(seed=0).params["layers"]["mlp"]["wi"]
            .sharding.spec)
        (jax_out["tensor_losses"], jax_out["tensor_norms"],
         jax_out["tensor_params"]) = _jax_run(optax.adamw(1e-3), _batches(),
                                              tensor=True)
        for tensor, future in adafactor.items():
            jax_out["adafactor_tensor" if tensor else "adafactor"] = \
                future.result()
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
    """A port name -> tensor dict as the JAX nested tree (numpy)."""
    model_cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    init_fn, _ = lm_task(model_cfg, device="cpu")
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


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_and_grad_norm_match_jax(jobs, jax_side, step):
    got = jobs["mesh8"][0]
    np.testing.assert_allclose(got["adamw_losses"][step],
                               jax_side["adamw_losses"][step], rtol=1e-4)
    np.testing.assert_allclose(got["adamw_norms"][step],
                               jax_side["adamw_norms"][step], rtol=1e-4)


def test_every_rank_reports_the_global_loss(jobs):
    first = jobs["mesh8"][0]
    for r in jobs["mesh8"][1:]:
        assert r["adamw_losses"] == first["adamw_losses"]
        assert r["adamw_norms"] == first["adamw_norms"]


def test_adamw_params_match_jax(jobs, jax_side):
    _assert_trees_close(_tree_of(jobs["mesh8"][0]["adamw_params"]),
                        jax_side["adamw_params"], **TOL)


def test_sgd_params_match_jax(jobs, jax_side):
    _assert_trees_close(_tree_of(jobs["mesh8"][0]["sgd_params"]),
                        jax_side["sgd_params"], **TOL)


def test_params_fsdp_sharded(jobs):
    """Each weight's embed dim (d_model 32) is split over fsdp=2: the
    dim JAX's rule table maps to fsdp, as test_params_fsdp_sharded
    reads it; the norm scales, replicated in JAX, take dim 0."""
    e, h, d, f, v = 32, 2, 16, 64, 128
    want = {"embed": (v, e // 2), "final_norm.scale": (e // 2,),
            "layers.0.attn.wq": (e // 2, h, d),
            "layers.0.attn.wkv": (2, e // 2, h, d),
            "layers.0.attn.wo": (h, d, e // 2),
            "layers.0.mlp.wi": (2, e // 2, f),
            "layers.0.mlp.wo": (f, e // 2),
            "layers.1.attn_norm.scale": (e // 2,)}
    for r in jobs["mesh8"]:
        for name, shape in want.items():
            assert r["shard_shapes"][name] == shape, name
        assert r["placements"]["layers.0.attn.wq"] == \
            "(Replicate(), Shard(dim=0))"
        assert r["placements"]["layers.0.mlp.wo"] == \
            "(Replicate(), Shard(dim=1))"


def test_optimizer_state_mirrors_param_sharding(jobs):
    for r in jobs["mesh8"]:
        assert r["mu_shapes"] == r["shard_shapes"]


def test_data_axis_grad_averaging(jobs, jax_side):
    """Identical rows on every data x fsdp shard: the global loss and its
    gradient are those rows' on one device (the reduction over the data
    axis is an exact average), and JAX's on the same mesh."""
    got = jobs["mesh8"][0]
    cfg = TransformerConfig(dtype=torch.float32, **dict(SMALL,
                                                        attention="flash"))
    init_fn, loss_fn = lm_task(cfg, device="cpu")
    params = params_from_jax(jax_side["init"])
    tr = Trainer(init_fn=lambda g: (load_params(init_fn(g)[0], params), {}),
                 loss_fn=loss_fn, tx=optim.sgd(SGD_LR), device="cpu",
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = tr.create_state(seed=0)
    _, m = tr.compile_step()(state, tr.shard_batch(
        {"tokens": _same_rows()[:2]}))
    np.testing.assert_allclose(got["same_rows_losses"][0], float(m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["same_rows_norms"][0],
                               float(m["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(got["same_rows_losses"][0],
                               jax_side["same_rows_losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got["same_rows_norms"][0],
                               jax_side["same_rows_norms"][0], rtol=1e-5)


def test_remat_under_fsdp_matches(jobs):
    got = jobs["mesh8"][0]
    np.testing.assert_allclose(got["remat_losses"],
                               got["adamw_losses"][:2], rtol=1e-5)
    np.testing.assert_allclose(got["remat_norms"],
                               got["adamw_norms"][:2], rtol=1e-5)


def test_checkpoint_verifies_in_jax(jobs):
    ckdir = jobs["dir"] / "ckpt"
    for step in (0, 1, 2):
        assert verify_step(ckdir, step) == (True, ""), step


def test_no_mesh_trainer_resumes_mesh_checkpoint(jobs):
    """Step 1 of the 8 ranks restores into a trainer without a mesh as
    the mesh's parameters after 2 steps, bit for bit, at step 2."""
    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    init_fn, loss_fn = lm_task(cfg, device="cpu")
    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=optim.adamw(1e-3),
                 device="cpu",
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = CheckpointManager(jobs["dir"] / "ckpt").restore(
        tr.create_state(seed=3), step=1)
    assert state.step == 2 and state.opt_state.count == 2
    for name, p in state.params.named_parameters():
        torch.testing.assert_close(p.detach(),
                                   jobs["mesh8"][0]["ckpt_params"][name],
                                   atol=0, rtol=0)


def test_mesh_trainer_resumes_its_checkpoint(jobs):
    got = jobs["mesh8"][0]
    np.testing.assert_allclose(got["resumed_loss"], got["adamw_losses"][2],
                               rtol=1e-6)


def test_adafactor_refuses_sharded_fsdp(jobs, jax_side):
    """adafactor over FSDP2's shards (refused before it was ported): the
    parameters after 5 steps are the JAX ``Trainer``'s with
    ``optax.adafactor`` on the same mesh."""
    _assert_trees_close(_tree_of(jobs["mesh8"][0]["adafactor_params"]),
                        jax_side["adafactor"][2], **TOL)


@pytest.mark.parametrize("job,want", [("mesh8", "adafactor"),
                                      ("tensor8", "adafactor_tensor")])
@pytest.mark.parametrize("step", range(STEPS))
def test_adafactor_steps_match_jax(jobs, jax_side, job, want, step):
    losses, norms, _ = jax_side[want]
    for r in jobs[job]:
        np.testing.assert_allclose(r["adafactor_losses"][step], losses[step],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["adafactor_norms"][step], norms[step],
                                   rtol=1e-4)


@pytest.mark.parametrize("variant", ["flash_remat", "ring"])
def test_world_one_mesh_bit_equal_no_mesh(jobs, variant):
    (m_loss, m_norm, m_params), (p_loss, p_norm, p_params) = \
        jobs["world1"][0][variant]
    assert m_loss == p_loss and m_norm == p_norm
    for name, t in m_params.items():
        torch.testing.assert_close(t, p_params[name], atol=0, rtol=0)


def test_two_process_bootstrap_training(jobs):
    ranks = jobs["train_lm"]
    assert [r["world"] for r in ranks] == [2, 2]
    losses = [[h["loss"] for h in r["history"]] for r in ranks]
    assert len(losses[0]) == 3 and losses[0] == losses[1]
    assert np.isfinite(losses[0]).all()


# -- tensor parallelism and dropout under a mesh ----------------------------


@pytest.mark.parametrize("step", range(STEPS))
def test_tensor_loss_and_grad_norm_match_jax(jobs, jax_side, step):
    got = jobs["tensor8"][0]
    np.testing.assert_allclose(got["adamw_losses"][step],
                               jax_side["tensor_losses"][step], rtol=1e-4)
    np.testing.assert_allclose(got["adamw_norms"][step],
                               jax_side["tensor_norms"][step], rtol=1e-4)


def test_tensor_every_rank_reports_the_global_loss(jobs):
    first = jobs["tensor8"][0]
    for r in jobs["tensor8"][1:]:
        assert r["adamw_losses"] == first["adamw_losses"]
        assert r["adamw_norms"] == first["adamw_norms"]


def test_tensor_adamw_params_match_jax(jobs, jax_side):
    _assert_trees_close(_tree_of(jobs["tensor8"][0]["adamw_params"]),
                        jax_side["tensor_params"], **TOL)


def test_tensor_params_sharded_as_jax(jobs, jax_side):
    """JAX's spec of the stacked ``wi`` [L, 2, embed, mlp] puts fsdp on
    its embed dim and tensor on its mlp dim; each rank's ``wi`` [2, e,
    f] holds half of each.  The heads of ``wq``, ``wkv`` and ``wo`` and
    the vocab of the tied ``embed`` are halved too, each weight's embed
    dim split over fsdp; the norm scales are split over fsdp only."""
    spec = jax_side["tensor_wi_spec"]
    assert spec[2:] == ("fsdp", "tensor"), spec
    e, h, d, f, v = 32, 2, 16, 64, 128
    want = {"embed": (v // 2, e // 2), "final_norm.scale": (e // 2,),
            "layers.0.attn.wq": (e // 2, h // 2, d),
            "layers.0.attn.wkv": (2, e // 2, h // 2, d),
            "layers.0.attn.wo": (h // 2, d, e // 2),
            "layers.0.mlp.wi": (2, e // 2, f // 2),
            "layers.0.mlp.wo": (f // 2, e // 2),
            "layers.1.mlp_norm.scale": (e // 2,)}
    for r in jobs["tensor8"]:
        for name, shape in want.items():
            assert r["shard_shapes"][name] == shape, name


def test_tensor_checkpoint_verifies_in_jax(jobs):
    ckdir = jobs["dir"] / "ckpt_tensor"
    for step in (0, 1):
        assert verify_step(ckdir, step) == (True, ""), step


def test_no_mesh_trainer_restores_tensor_checkpoint(jobs):
    """The gathered save of data=2, fsdp=2, tensor=2 holds each weight
    whole, in the JAX layout: a trainer without a mesh restores the mesh
    trainer's parameters after 2 steps bit for bit."""
    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    init_fn, loss_fn = lm_task(cfg, device="cpu")
    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=optim.adamw(1e-3),
                 device="cpu",
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = CheckpointManager(jobs["dir"] / "ckpt_tensor").restore(
        tr.create_state(seed=3), step=1)
    assert state.step == 2 and state.opt_state.count == 2
    for name, p in state.params.named_parameters():
        torch.testing.assert_close(p.detach(),
                                   jobs["tensor8"][0]["ckpt_params"][name],
                                   atol=0, rtol=0)


def test_adafactor_refuses_tensor_slices(jobs, jax_side):
    """adafactor over the tensor slices and FSDP2's shards (refused
    before it was ported): the parameters after 5 steps are the JAX
    ``Trainer``'s with ``optax.adafactor`` on the same mesh."""
    _assert_trees_close(_tree_of(jobs["tensor8"][0]["adafactor_params"]),
                        jax_side["adafactor_tensor"][2], **TOL)


# tests/torch_mesh_train_worker.py's WIDE: adafactor's factored leaves.
WIDE = dict(SMALL, attention="flash", vocab_size=256, d_model=128, d_ff=256,
            tied_embeddings=False)


def test_adafactor_factored_leaves_match_no_mesh(jobs):
    """At WIDE every matrix factors, its statistics reduced over fsdp or
    tensor where they split the reduced dim: data=2 x fsdp=2 x tensor=2's
    3 adafactor steps are those of the trainer without a mesh on the
    global batch."""
    for r in jobs["tensor8"]:
        (m_loss, m_norm, m_params), (p_loss, p_norm, p_params) = r["wide"]
        np.testing.assert_allclose(m_loss, p_loss, rtol=1e-5)
        np.testing.assert_allclose(m_norm, p_norm, rtol=1e-5)
        for name, t in m_params.items():
            torch.testing.assert_close(t, p_params[name], **NO_MESH_TOL)
    shapes = jobs["tensor8"][0]["wide_stat_shapes"]
    # embed [256, 128]: v_row, the mean over the vocab (split over
    # tensor, so all-reduced), keeps this rank's 64 embed columns (its
    # fsdp shard); wi [L, 2, 128, 256] keeps its layers, pair and 64
    # embed rows.
    assert shapes["embed"] == (64,) and shapes["layers.mlp.wi"] == (2, 2, 64)


def test_adafactor_checkpoint_verifies_in_jax(jobs):
    for step in (0, 1):
        assert verify_step(jobs["dir"] / "ckpt_adafactor", step) == (
            True, ""), step


def test_no_mesh_trainer_resumes_adafactor_checkpoint(jobs):
    """The mesh's adafactor save after 2 steps holds the statistics
    gathered to the JAX layout: a trainer without a mesh restores it (its
    template's shapes) and takes the third step to the mesh's third loss
    and its parameters after it."""
    init_fn, loss_fn = lm_task(TransformerConfig(dtype=torch.float32,
                                                 **WIDE), device="cpu")
    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=optim.adafactor(1e-3),
                 device="cpu",
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = CheckpointManager(jobs["dir"] / "ckpt_adafactor").restore(
        tr.create_state(seed=3), step=1)
    assert state.step == 2 and state.opt_state.count == 2
    assert state.opt_state.v_row["embed"].shape == (128,)
    state, m = tr.compile_step()(state, tr.shard_batch(
        {"tokens": _batches()[2]}))
    (losses, norms, params), _ = jobs["tensor8"][0]["wide"]
    np.testing.assert_allclose(float(m["loss"]), losses[2], rtol=1e-5)
    for name, p in state.params.named_parameters():
        torch.testing.assert_close(p.detach(), params[name], **NO_MESH_TOL)


@pytest.mark.parametrize("job,variant", [("tensor2", "plain"),
                                         ("tensor2", "remat"),
                                         ("dropout4", "ring")])
def test_dropout_mesh_step_matches_no_mesh(jobs, job, variant):
    """At dropout 0.1 the mesh trainer's steps are those of the trainer
    without a mesh on the global batch from the same seed: each rank
    keeps its share of one global mask draw."""
    for r in jobs[job]:
        (m_loss, m_norm, m_params), (p_loss, p_norm, p_params) = r[variant]
        np.testing.assert_allclose(m_loss, p_loss, rtol=1e-5)
        np.testing.assert_allclose(m_norm, p_norm, rtol=1e-5)
        for name, t in m_params.items():
            torch.testing.assert_close(t, p_params[name], **NO_MESH_TOL)


def test_dropout_masks_are_shares_of_one_draw(jobs):
    """Each rank of data=2 x sequence=2 keeps its rows and positions of
    the mask one device draws for the global [4, 32, 32] activations;
    so the data ranks' masks differ, and so do the sequence shards'."""
    whole = torch.rand((4, 32, 32),
                       generator=torch.Generator().manual_seed(7)) < 0.9
    masks = {}
    for r in jobs["dropout4"]:
        d, s = r["coords"]["data"], r["coords"]["sequence"]
        masks[d, s] = r["mask"]
        torch.testing.assert_close(
            r["mask"], whole[2 * d:2 * d + 2, 16 * s:16 * s + 16])
    assert not torch.equal(masks[0, 0], masks[1, 0])
    assert not torch.equal(masks[0, 0], masks[0, 1])


def test_tensor_ranks_keep_one_mask(jobs):
    ranks = jobs["tensor2"]
    assert [r["coords"]["tensor"] for r in ranks] == [0, 1]
    torch.testing.assert_close(ranks[0]["mask"], ranks[1]["mask"])


def test_tensor_trainer_restores_no_mesh_checkpoint(jobs):
    """A save without a mesh restores onto tensor=2's slices: the whole
    parameters as saved, each rank holding its half of the heads, mlp
    and vocab, and the next step's loss that of the run without a
    mesh."""
    for r in jobs["tensor2"]:
        assert r["restored_step"] == 2
        for name, t in r["restored_params"].items():
            torch.testing.assert_close(t, r["saved_params"][name], atol=0,
                                       rtol=0)
        t = r["coords"]["tensor"]
        torch.testing.assert_close(
            r["restored_local"]["w_out"],
            r["saved_params"]["w_out"][:, 64 * t:64 * (t + 1)], atol=0,
            rtol=0)
        np.testing.assert_allclose(r["resumed_loss"],
                                   r["plain"][1][0][2], rtol=1e-5)


def test_train_lm_tensor_matches_no_mesh(jobs):
    """tools/train_lm.py at --mesh model=2 over gloo: both tensor ranks
    feed the same rows and report the losses of the entry point run
    without a mesh on the same flags.  The entry point computes in bf16,
    where each row-parallel all-reduce adds two bf16 partial sums that
    one device rounds once: 2.2e-5 apart here, held to 2e-4."""
    ranks = jobs["train_lm_tensor"]
    assert [r["world"] for r in ranks] == [2, 2]
    losses = [[h["loss"] for h in r["history"]] for r in ranks]
    assert losses[0] == losses[1]
    argv = _tensor_argv()[2:]
    at = argv.index("--mesh")
    plain = train_lm.run(argv[:at] + argv[at + 2:])
    want = [h["loss"] for h in plain.metrics.history]
    assert len(want) == 3
    np.testing.assert_allclose(losses[0], want, rtol=2e-4)
