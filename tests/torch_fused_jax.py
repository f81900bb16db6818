"""The JAX side of the fused gangs' parity tests: the JAX package's
``FusedTrainer`` on a mesh of the fake CPU devices (tests/conftest.py),
from the port's member weights, and the checks that hold a gang's ranks
(tests/torch_fused_gang.py) to it.

Used in the pytest process by tests/test_torch_parallel_train.py,
tests/test_torch_moe_mesh.py and tests/test_torch_pipeline.py; the ranks
stay JAX-free.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import lm_task as jax_lm_task
from kubeflow_tpu.parallel import MeshSpec as JaxMeshSpec
from kubeflow_tpu.runtime.hfta import FusedTrainer as JaxFusedTrainer
from kubeflow_tpu.runtime.hfta import MemberSpec as JaxMemberSpec
from kubeflow_tpu.runtime.hfta import default_tx_factory as jax_default_tx
from kubeflow_tpu.runtime.metrics import MetricsLogger as JaxMetricsLogger
from kubeflow_tpu.runtime.train import TrainState as JaxTrainState
from kubeflow_tpu_torch.models.convert import params_to_jax
from kubeflow_tpu_torch.models.transformer import TransformerConfig, lm_task


def member_trees(cfg, members):
    """Each member's initial weights as the JAX tree: the port's draw of
    ``cfg`` (a dict of TransformerConfig fields) from its seed, which
    every rank's ``create_member_state`` makes alike."""
    init_fn, _ = lm_task(TransformerConfig(dtype=torch.float32, **cfg),
                         device="cpu")
    return [params_to_jax(init_fn(torch.Generator().manual_seed(
        m["seed"]))[0]) for m in members]


def jax_gang(cfg, members, batches, **mesh_spec):
    """The JAX ``FusedTrainer`` at ``cfg`` (TransformerConfig fields) on a
    ``MeshSpec(**mesh_spec)`` of fake CPU devices, from the port's member
    weights (the fused state pinned replicated, as its ``fit`` pins it),
    over ``batches``: each step's per-member loss and grad_norm and each
    member's parameters after the steps (numpy trees)."""
    n = int(np.prod(list(mesh_spec.values())))
    mesh = JaxMeshSpec(**mesh_spec).build(jax.devices()[:n])
    init_fn, loss_fn = jax_lm_task(JaxConfig(dtype=jnp.float32, **cfg),
                                   mesh=mesh)
    specs = [JaxMemberSpec(**m) for m in members]
    jft = JaxFusedTrainer(
        init_fn=init_fn, loss_fn=loss_fn, members=specs, mesh=mesh,
        metrics=JaxMetricsLogger(stream=open("/dev/null", "w")))
    states = [JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=tree,
        opt_state=jax_default_tx(m.lr).init(tree),
        rng=jax.random.split(jax.random.key(m.seed))[1], mutable={})
        for m, tree in zip(specs, member_trees(cfg, members))]
    state = jax.device_put(jft._stack_members(states), jax.sharding
                           .NamedSharding(mesh, jax.sharding.PartitionSpec()))
    step, active = jft.compile_step(), jnp.ones((len(specs),), bool)
    stops = jnp.asarray([m.stop_step or len(batches) for m in specs],
                        jnp.int32)
    metrics = []
    for b in batches:
        state, active, m = step(state, active, stops,
                                jft.shard_batch({"tokens": b}))
        metrics.append({k: np.asarray(m[k]) for k in ("loss", "grad_norm")})
    return metrics, [jax.tree.map(np.asarray, jft.member_state(state,
                                                              i).params)
                     for i in range(len(specs))]


def tree_of(cfg, params):
    """A port name -> whole tensor dict at ``cfg`` as the JAX nested tree
    (numpy): the weights of one device's model, whatever mesh the config
    names an attention or a schedule for."""
    cfg = {k: v for k, v in cfg.items()
           if k not in ("attention", "pipeline_microbatches")}
    init_fn, _ = lm_task(TransformerConfig(dtype=torch.float32, **cfg),
                         device="cpu")
    model, _ = init_fn(torch.Generator().manual_seed(0))
    model.load_state_dict(params)
    return params_to_jax(model)


def assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf, flat_want[path],
                                   err_msg=jax.tree_util.keystr(path), **tol)


def check_step(ranks, want, step, **tol):
    """Every rank's per-member loss and grad_norm of fused step ``step``
    against JAX's, and the ranks' losses equal."""
    for r in ranks:
        got = r["metrics"][step]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key].numpy(), want[step][key],
                                       err_msg=key, **tol)
        assert torch.equal(got["loss"], ranks[0]["metrics"][step]["loss"])


def check_members(ranks, want, cfg, stops, **tol):
    """Each member's whole parameters after the steps against JAX's (on
    every rank), the member steps, and m1's rows of every rank's stacked
    state bit-equal at its stop and at the end."""
    for r in ranks:
        assert r["steps"] == stops
        for params, tree in zip(r["params"], want):
            assert_trees_close(tree_of(cfg, params), tree, **tol)
        assert set(r["m1_at_end"]) == set(r["m1_at_stop"])
        for k, v in r["m1_at_end"].items():
            assert torch.equal(v, r["m1_at_stop"][k]), k
