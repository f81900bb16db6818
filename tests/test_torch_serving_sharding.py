"""The port's serving/sharding.py against the JAX package's, in process.

The twins of tests/test_sharding.py's TestPartitionRules: the ``--mesh``
grammar and its messages, ``build_mesh`` sizes, the rule table against
JAX's ``match_partition_rules`` on the same JAX param tree (and on an
adapter stack), non-divisible dims degrading to replicated, the rank
guard, and each rank's slices against the shards JAX's ``shard_params``
and ``shard_paged_state`` place on a mesh of the conftest's fake CPU
devices: float weights, int8 ``QTensor`` values and scales (which JAX's
regexes do not reach: the port quantizes whole, then slices as the float
weight is sliced), and the KV pool's kv heads.  A rank is a stand-in
mesh here (its index and size); the multi-process engine is
tests/test_torch_serving_mesh.py's.
"""

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models.generate import init_paged_state as jax_pool
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.ops import quantize as jq
from kubeflow_tpu.serving import adapters as jax_adapters
from kubeflow_tpu.serving import sharding as jsh
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.generate import init_paged_state
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.ops import quantize as pq
from kubeflow_tpu_torch.parallel.mesh import AXIS_ORDER
from kubeflow_tpu_torch.serving import sharding

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

SEED = 20260804
TINY = {"vocab_size": 96, "d_model": 32, "n_layers": 2, "n_heads": 4,
        "n_kv_heads": 4, "d_ff": 64, "head_dim": 8, "max_seq_len": 64}
WEIGHTS = (("layers", "attn", "wq"), ("layers", "attn", "wkv"),
           ("layers", "attn", "wo"), ("layers", "mlp", "wi"),
           ("layers", "mlp", "wo"), ("embed",))


class _Rank:
    """A stand-in for rank ``index`` of a ``tensor`` mesh of ``count``
    (``MeshSpec(data=1, tensor=count)``'s axes)."""

    mesh_dim_names = AXIS_ORDER

    def __init__(self, index, count):
        self.index, self.count = index, count
        self.shape = (1,) * (len(AXIS_ORDER) - 1) + (count,)

    def get_local_rank(self, axis):
        assert axis == "tensor"
        return self.index

    def size(self):
        return self.count

    def get_group(self, axis):
        assert axis == "tensor"
        return None  # no collective runs on a stand-in


@pytest.fixture(scope="module")
def tree():
    """The JAX LM's param tree (its structure and shapes, from
    ``eval_shape`` of its init), filled from a seeded numpy draw."""
    cfg = jax_model_config(dict(TINY, dtype="float32"))
    shapes = jax.eval_shape(lambda: nn.unbox(JaxTransformer(cfg).init(
        jax.random.key(SEED), np.zeros((1, 8), np.int32)))["params"])
    rng = np.random.RandomState(SEED)
    return cfg, jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
        shapes)


def _get(node, path):
    for key in path:
        node = node[key]
    return node


def _leaf_paths(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaf_paths(v, path + (k,))
    else:
        yield path


@pytest.mark.parametrize("spec,message", [
    ("tensor", "axis=N"), ("fsdp=2", "unknown serving mesh"),
    ("tensor=x", "not an integer"), ("tensor=0", ">= 1")])
def test_parse_mesh_flag_errors_match_jax(spec, message):
    with pytest.raises(ValueError, match=message) as port:
        sharding.parse_mesh_flag(spec)
    with pytest.raises(ValueError) as jax_err:
        jsh.parse_mesh_flag(spec)
    assert str(port.value) == str(jax_err.value)


@pytest.mark.parametrize("spec", ["", "tensor=4", " tensor = 2 ,"])
def test_parse_mesh_flag_matches_jax(spec):
    assert sharding.parse_mesh_flag(spec) == jsh.parse_mesh_flag(spec)


def test_build_mesh_sizes():
    """No mesh at sizes 0 and 1; a mesh larger than the job is refused
    (JAX refuses one larger than its visible devices); mesh_devices
    counts the ranks."""
    assert sharding.build_mesh({}) is None
    assert sharding.build_mesh({"tensor": 1}) is None
    with pytest.raises(ValueError, match="needs a job of 4 processes"):
        sharding.build_mesh({"tensor": 4}, device="cpu")
    assert sharding.mesh_devices(None) == 1
    assert sharding.mesh_devices(_Rank(0, 4)) == 4
    assert sharding.local_kv_heads(4, _Rank(3, 4)) == 1
    assert sharding.local_kv_heads(2, _Rank(3, 4)) == 2


def test_rules_map_param_tree_as_jax(tree):
    """Every leaf of the JAX LM tree gets the split dims JAX's rules
    give it."""
    _, params = tree
    want = jsh.match_partition_rules(jsh.LM_PARTITION_RULES, params)
    got = sharding.match_partition_rules(sharding.LM_PARTITION_RULES,
                                         params)
    for path in _leaf_paths(params):
        assert _get(got, path) == tuple(_get(want, path)), path
    assert _get(got, ("layers", "attn", "wq")) \
        == (None, None, "tensor", None)
    assert _get(got, ("final_norm", "scale")) == ()


def test_rules_map_adapter_stack_as_jax(tree):
    cfg, _ = tree
    stack = {"adapters": jax_adapters.init_adapter_stack(cfg, 5, 4)}
    want = jsh.match_partition_rules(jsh.LM_PARTITION_RULES, stack)
    got = sharding.match_partition_rules(sharding.LM_PARTITION_RULES,
                                         stack)
    for path in _leaf_paths(stack):
        assert _get(got, path) == tuple(_get(want, path)), path


def test_non_divisible_dim_degrades_to_replicated():
    """3 kv heads do not divide tensor=4: the wkv rule replicates that
    dim (JAX places it on no axis), and each rank keeps it whole."""
    odd = {"layers": {"attn": {"wkv": np.zeros((2, 2, 32, 3, 8),
                                               np.float32)}}}
    placed = jsh.shard_params(odd, jsh.build_mesh({"tensor": 4}))
    assert placed["layers"]["attn"]["wkv"].sharding.spec \
        == jax.sharding.PartitionSpec(None, None, None, None, None)
    local = sharding.shard_params(params_from_jax(odd), _Rank(1, 4))
    assert tuple(local["layers"]["attn"]["wkv"].shape) == (2, 2, 32, 3, 8)


def test_rank_mismatch_replicates():
    tree = {"layers": {"attn": {"wq": np.zeros((4,), np.float32)}}}
    assert sharding.match_partition_rules(
        sharding.LM_PARTITION_RULES, tree)["layers"]["attn"]["wq"] == ()
    assert jsh.match_partition_rules(
        jsh.LM_PARTITION_RULES, tree)["layers"]["attn"]["wq"] \
        == jax.sharding.PartitionSpec()


def _jax_shard(leaf, mesh, rank):
    """(index, data) of JAX's shard on device ``rank`` of ``mesh``."""
    dev = mesh.devices.flatten()[rank]
    for shard in leaf.addressable_shards:
        if shard.device == dev:
            return shard.index, np.asarray(shard.data)
    raise AssertionError(f"no shard on {dev}")


@pytest.mark.parametrize("count", [2, 4])
def test_float_slices_are_jax_shards(tree, count):
    _, params = tree
    mesh = jsh.build_mesh({"tensor": count})
    placed = jsh.shard_params(params, mesh)
    port = params_from_jax(params)
    for rank in range(count):
        local = sharding.shard_params(port, _Rank(rank, count))
        for path in _leaf_paths(params):
            _, want = _jax_shard(_get(placed, path), mesh, rank)
            np.testing.assert_array_equal(
                _get(local, path).numpy(), want, err_msg=str(path))


def test_int8_values_and_scales_sliced_with_the_float_shards(tree):
    """JAX's rule regexes end at the weight, and a QTensor's children sit
    below it, so JAX replicates int8 weights under a mesh.  The port
    quantizes whole (JAX's values and scales exactly), then slices the
    values where JAX shards the float weight, and the scale with them
    where it keeps the split dim (wq, wkv, wi, embed), whole where the
    dim is contracted (wo, mlp/wo: the whole contraction's amax)."""
    _, params = tree
    mesh = jsh.build_mesh({"tensor": 2})
    placed = jsh.shard_params(params, mesh)
    jax_q = jq.quantize_params(params)
    port_q = pq.quantize_params(params_from_jax(params))
    kept = {("layers", "attn", "wq"): True, ("layers", "attn", "wkv"): True,
            ("layers", "attn", "wo"): False, ("layers", "mlp", "wi"): True,
            ("layers", "mlp", "wo"): False, ("embed",): True}
    for rank in range(2):
        local = sharding.shard_params(port_q, _Rank(rank, 2))
        for path in WEIGHTS:
            index, _ = _jax_shard(_get(placed, path), mesh, rank)
            q, mine = _get(jax_q, path), _get(local, path)
            np.testing.assert_array_equal(
                mine.values.numpy(), np.asarray(q.values)[index],
                err_msg=str(path))
            n = len(index)
            scale_index = tuple(s for i, s in enumerate(index)
                                if i - n not in q.axes)
            want = np.asarray(q.scale)[scale_index]
            np.testing.assert_array_equal(mine.scale.numpy(), want,
                                          err_msg=str(path))
            split = tuple(mine.scale.shape) != tuple(q.scale.shape)
            assert split == kept[path], path


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_pool_local_heads_are_jax_shards(tree, kv):
    """The pool's kv heads (dim 3) split, values and scales alike;
    geometry and per-slot scalars whole; the scratch block kept."""
    cfg, _ = tree
    mesh = jsh.build_mesh({"tensor": 2})
    placed = jsh.shard_paged_state(
        jax_pool(cfg, 3, 6, 4, kv_cache_dtype=kv), mesh)
    port_cfg = TransformerConfig(dtype=torch.float32, **TINY)
    whole = init_paged_state(port_cfg, 3, 6, 4, kv, device="cpu")
    for rank in range(2):
        local = sharding.shard_paged_state(whole, _Rank(rank, 2))
        direct = init_paged_state(
            port_cfg, 3, 6, 4, kv, device="cpu",
            kv_heads=sharding.local_kv_heads(TINY["n_kv_heads"],
                                             _Rank(rank, 2)))
        for key in ("cache_k", "cache_v"):
            got, want = local[key], placed[key]
            sides = ((got.values, want.values), (got.scale, want.scale)) \
                if kv == "int8" else ((got, want),)
            for g, w in sides:
                _, data = _jax_shard(w, mesh, rank)
                assert tuple(g.shape) == data.shape
            mine = direct[key]
            assert tuple(mine.shape) == tuple(got.shape)
            # The scratch block past the view survives the slice.
            from kubeflow_tpu_torch.models.generate import _pool_with_scratch

            assert _pool_with_scratch(got).shape[1] == 7
        for key in ("lengths", "done", "keys"):
            assert torch.equal(local[key], whole[key])


def test_head_slice_of_pages():
    pages = torch.arange(2 * 3 * 4 * 4 * 2, dtype=torch.float32).reshape(
        2, 3, 4, 4, 2)
    parts = [sharding.head_slice(pages, _Rank(r, 2)) for r in range(2)]
    assert torch.equal(torch.cat(parts, dim=3), pages)
    assert sharding.head_slice(pages, None) is pages
    q = pq.QTensor(pages.to(torch.int8), pages[..., 0], (-1,))
    half = sharding.head_slice(q, _Rank(1, 2))
    assert tuple(half.values.shape) == (2, 3, 4, 2, 2)
    assert tuple(half.scale.shape) == (2, 3, 4, 2)


@pytest.mark.parametrize("kv_heads,count", [(4, 2), (2, 4)])
@pytest.mark.parametrize("int8", [False, True])
def test_shard_model_slices_as_the_rules_place_them(kv_heads, count, int8):
    """A rank's served model takes its own slices by its weights'
    logical axes (float, or int8 ``QTensor``s with their scales), and
    they are the slices the rule table places on that rank, GQA's
    undivided kv heads (2 at tensor=4) kept whole by both."""
    from kubeflow_tpu_torch.models.convert import load_params, param_tree
    from kubeflow_tpu_torch.models.transformer import Transformer

    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(TINY, n_kv_heads=kv_heads))
    whole = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(SEED))
    tree = param_tree(whole)
    if int8:
        tree = pq.quantize_params(tree)
        whole = load_params(Transformer(cfg, device="meta"), tree)
    for rank in range(count):
        mesh = _Rank(rank, count)
        got = param_tree(sharding.shard_model(whole, mesh))
        want = sharding.shard_params(tree, mesh)
        for path in _leaf_paths(want):
            g, w = _get(got, path), _get(want, path)
            if int8 and isinstance(w, pq.QTensor):
                assert torch.equal(g.values, w.values), path
                assert torch.equal(g.scale, w.scale), path
            else:
                assert torch.equal(g, w), path
