"""Serving-side mesh construction and param/KV-pool partitioning: the port
of kubeflow_tpu/serving/sharding.py.

The JAX package serves a mesh from one process over N local devices: one
``device_put`` of the params and the pool under ``NamedSharding``s, and
XLA compiles the same programs SPMD.  Here a mesh is a group of
processes, one GPU each (parallel/mesh.py), and each rank holds plain
local tensors: its slice of every weight the rule table splits and whole
copies of the rest.  Rank 0 owns the engine's host side and the other
ranks replay its device calls (serving/lockstep.py).  The pieces:

  mesh        ``build_mesh({"tensor": N})``: None at N <= 1, else a
              ``DeviceMesh`` of ``MeshSpec(tensor=N)`` over a world of
              exactly N ranks (``runtime/bootstrap.py`` starts it; JAX
              checks N against its visible devices instead), with the
              lockstep channel's CPU group attached.

  rules       ``match_partition_rules(rules, params)``: regex rules over
              '/'-joined tree paths to the split dim of each leaf (the
              JAX package's ``PartitionSpec`` holds ``"tensor"`` at that
              dim), ``LM_PARTITION_RULES`` the JAX table itself.  A dim
              that does not divide the axis is replicated with a warning
              (``_divisible``), as in JAX.

  placement   ``shard_params`` returns this rank's slice of each whole
              leaf of a param tree (or of ``{"adapters": stack}``); an
              int8 ``QTensor`` is sliced with its scale wherever the
              scale keeps the split dim and with the whole scale where
              the dim is contracted (weights are quantized whole, then
              split): the adapter stacks' placement, and the port of
              JAX's placement of the LM tree.  ``shard_model`` builds a
              rank's served model from a whole one: the model takes its
              own slices by its weights' logical axes
              (models/convert.py ``load_params``), as the rules place
              them.
              ``shard_paged_state`` gives the pool this rank's kv heads
              (dim 3) and replicates block geometry and per-slot
              scalars, so the host-owned block tables address every
              rank's pool alike.

One divergence from JAX: its rule regexes end at the weight's name, and
a ``QTensor``'s children sit one level below it (``.../wq/<flat index
0>``), so JAX replicates an int8 weight whole under a mesh.  The port
splits it as it splits the float weight.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from kubeflow_tpu_torch.device import DeviceLike
from kubeflow_tpu_torch.ops.quantize import QTensor
from kubeflow_tpu_torch.parallel.mesh import tensor_shard

log = logging.getLogger(__name__)

# The serving mesh axis (parallel/mesh.py's innermost).
TENSOR = "tensor"

# A rule's spec: the mesh axis of each dim of the leaf (None: not split),
# the entries of the JAX package's PartitionSpec.
Spec = Tuple[Optional[str], ...]
PartitionRules = Sequence[Tuple[str, Spec]]

LM_PARTITION_RULES: PartitionRules = (
    # [L, e, h, d]: attention query projection, heads split.
    (r"layers/attn/wq$", (None, None, TENSOR, None)),
    # [L, 2, e, hkv, d]: fused k/v projection, kv heads split (as the
    # pool's heads: a head's cache columns live on the rank that
    # computes them).
    (r"layers/attn/wkv$", (None, None, None, TENSOR, None)),
    # [L, h, d, e]: output projection, row-parallel over heads.
    (r"layers/attn/wo$", (None, TENSOR, None, None)),
    # [L, 2, e, f]: gate/up projections, hidden split.
    (r"layers/mlp/wi$", (None, None, None, TENSOR)),
    # [L, f, e]: down projection, row-parallel over hidden.
    (r"layers/mlp/wo$", (None, TENSOR, None)),
    # [V, e]: embedding (and tied LM head), vocab split.
    (r"embed$", (TENSOR, None)),
    # [e, V]: untied LM head, vocab split.
    (r"w_out$", (None, TENSOR)),
    # Stacked adapter factors (serving/adapters.py): the out-side factor
    # of a column-parallel projection splits its heads/kv heads/hidden
    # dim, the in-side factor of a row-parallel one its input dim (its
    # rank-r product is a partial sum, reduced with the projection's).
    # The leading adapter-row axis stays whole: a gather by slot index
    # must see every row on every rank.
    # [rows, L, r, h, d]: q delta out-factor, heads split.
    (r"adapters/attn/wq_b$", (None, None, None, TENSOR, None)),
    # [rows, L, 2, r, hkv, d]: k/v delta out-factor, kv heads split.
    (r"adapters/attn/wkv_b$", (None, None, None, None, TENSOR, None)),
    # [rows, L, h, d, r]: attn-out delta in-factor, row-parallel.
    (r"adapters/attn/wo_a$", (None, None, TENSOR, None, None)),
    # [rows, L, 2, r, f]: gate/up delta out-factor, hidden split.
    (r"adapters/mlp/wi_b$", (None, None, None, None, TENSOR)),
    # [rows, L, f, r]: MLP-down delta in-factor, row-parallel.
    (r"adapters/mlp/wo_a$", (None, None, TENSOR, None)),
)


def parse_mesh_flag(spec: str) -> Dict[str, int]:
    """``--mesh`` grammar: ``axis=N[,axis=N...]``; the only serving axis
    is ``tensor`` (``"tensor=4"``).  The empty string means no mesh."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"mesh axis {part!r} must be axis=N (e.g. tensor=4)")
        axis, _, n = part.partition("=")
        axis = axis.strip()
        if axis != TENSOR:
            raise ValueError(
                f"unknown serving mesh axis {axis!r} (serving shards "
                f"over {TENSOR!r} only; training meshes live in "
                f"parallel/mesh.py)")
        try:
            size = int(n)
        except ValueError:
            raise ValueError(
                f"mesh axis size {n!r} is not an integer") from None
        if size < 1:
            raise ValueError(f"mesh axis size must be >= 1, got {size}")
        out[axis] = size
    return out


def build_mesh(axes: Dict[str, int], device: DeviceLike = None,
               timeout_s: Optional[float] = None):
    """A 1-D ``tensor`` mesh over the job's N ranks, or None when the
    spec is empty or of size 1 (the single-device engine, unchanged).
    Every rank calls it, in the same order as every other collective.
    The job must have exactly N processes (runtime/bootstrap.py
    ``initialize`` starts them, one GPU each, or several on one GPU over
    gloo); a mismatch raises.  ``timeout_s`` bounds every collective of
    the mesh's groups and of its lockstep channel (default: the training
    meshes' ``DEFAULT_TIMEOUT_S``)."""
    size = int(axes.get(TENSOR, 1)) if axes else 1
    if size <= 1:
        return None
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, MeshSpec
    from kubeflow_tpu_torch.serving import lockstep

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != size:
        raise ValueError(
            f"mesh tensor={size} needs a job of {size} processes, this one "
            f"has {world} (start them with KFT_NUM_PROCESSES={size}, "
            f"KFT_PROCESS_ID and KFT_COORDINATOR_ADDRESS, or torchrun)")
    if timeout_s is None:
        timeout_s = DEFAULT_TIMEOUT_S
    mesh = MeshSpec(data=1, tensor=size).build(device, timeout_s=timeout_s)
    lockstep.attach(mesh, timeout_s)
    return mesh


def mesh_devices(mesh) -> int:
    """Devices an engine spans (1 = single-device): the
    ``kft_engine_mesh_devices`` gauge value."""
    return 1 if mesh is None else int(mesh.size())


def _path_str(path: Sequence[str]) -> str:
    return "/".join(path)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _unflatten(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def match_partition_rules(rules: PartitionRules, params) -> Dict[str, Any]:
    """The spec of each leaf by the first rule whose regex matches its
    '/'-joined path: a tree of the params' structure whose leaves are
    ``Spec`` tuples, ``()`` (replicated) for scalars, one-element leaves,
    unmatched paths and a spec whose rank exceeds the leaf's."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def leaf_spec(path, leaf) -> Spec:
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape or int(torch.Size(shape).numel()) == 1:
            return ()
        pstr = _path_str(path)
        for pat, spec in compiled:
            if pat.search(pstr):
                return () if len(spec) > len(shape) else tuple(spec)
        return ()

    return _unflatten((p, leaf_spec(p, leaf)) for p, leaf in _leaves(params))


def _divisible(spec: Spec, shape, size: int, what: str) -> Spec:
    """Each split dim that does not divide the axis's ``size`` degrades
    to replicated, with a warning (tiny models shard what they can)."""
    out: List[Optional[str]] = []
    for i, axis in enumerate(spec):
        if axis is not None and shape[i] % size:
            log.warning(
                "sharding %s: dim %d (size %d) does not divide mesh axis "
                "%r (size %d); replicating that dim", what, i, shape[i],
                axis, size)
            out.append(None)
        else:
            out.append(axis)
    return tuple(out)


def split_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits over ``tensor``, or None."""
    for i, axis in enumerate(spec):
        if axis == TENSOR:
            return i
    return None


def _take(leaf, dim: Optional[int], index: int, count: int):
    if dim is None:
        return leaf
    if isinstance(leaf, QTensor):
        return leaf.chunk(count, dim)[index].contiguous()
    return torch.as_tensor(leaf).chunk(count, dim=dim)[index].contiguous()


def shard_params(params, mesh, rules: PartitionRules = LM_PARTITION_RULES):
    """This rank's slice of every whole leaf of ``params`` (a nested dict
    of tensors or ``QTensor``s: the LM tree, or ``{"adapters": stack}``)
    under the rule table; replicated leaves are returned as they are.  A
    ``QTensor`` takes its values' rule and slices its scale with them
    (``QTensor.chunk``)."""
    index, count = tensor_shard(mesh)
    specs = dict(_leaves(match_partition_rules(rules, params)))
    out = []
    for path, leaf in _leaves(params):
        spec = _divisible(specs[path], tuple(leaf.shape), count,
                          _path_str(path))
        out.append((path, _take(leaf, split_dim(spec), index, count)))
    return _unflatten(out)


def shard_model(model, mesh):
    """This rank's served model: a ``Transformer`` split over the mesh's
    ``tensor`` group (dims that do not divide it stay whole), its weights
    this rank's slices of ``model``'s whole ones, on their device (int8
    ``QTensor``s sliced with their scales).  The model takes its own
    slices by its weights' logical axes (models/convert.py
    ``load_params``), which place them as ``LM_PARTITION_RULES`` does.
    A local operation: no collective runs."""
    from kubeflow_tpu_torch.models.convert import load_params, param_tree
    from kubeflow_tpu_torch.models.transformer import Transformer

    sliced = Transformer(model.cfg, device="meta", mesh=mesh,
                         replicate_indivisible=True)
    load_params(sliced, param_tree(model))
    sliced.requires_grad_(False)
    return sliced


def local_kv_heads(n_kv_heads: int, mesh) -> int:
    """The kv heads a rank's pool holds: its share when they divide the
    mesh, else all of them (replicated)."""
    _, count = tensor_shard(mesh)
    return n_kv_heads if n_kv_heads % count else n_kv_heads // count


def _pool_slice(pool, index: int, count: int):
    """[L, nb, bt, hkv, ...] pool view (with its scratch block past the
    view) -> this rank's kv heads, keeping the scratch block."""
    from kubeflow_tpu_torch.models.generate import _pool_with_scratch

    if isinstance(pool, QTensor):
        return QTensor(_pool_slice(pool.values, index, count),
                       _pool_slice(pool.scale, index, count), pool.axes)
    nb = pool.shape[1]
    full = _pool_with_scratch(pool)
    return full.chunk(count, dim=3)[index].contiguous()[:, :nb]


def shard_paged_state(state: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's share of the engine's paged state
    (models/generate.py ``init_paged_state``): the pool's kv heads (dim
    3, values and scales alike), when they divide the mesh; block
    geometry and per-slot scalars whole.  The port of JAX's placement of
    the pool, held to it by the tests; the engine builds its rank's pool
    at that shape directly (``init_paged_state(kv_heads=
    local_kv_heads(...))``) instead of slicing a whole one."""
    index, count = tensor_shard(mesh)
    heads = state["cache_k"].shape[3]
    if count == 1 or heads % count:
        if count > 1:
            log.warning("sharding the KV pool: %d kv heads do not divide "
                        "mesh axis %r (size %d); replicating them", heads,
                        TENSOR, count)
        return dict(state)
    out = dict(state)
    for key in ("cache_k", "cache_v"):
        out[key] = _pool_slice(state[key], index, count)
    return out


def head_slice(pages, mesh):
    """This rank's kv heads (dim 3) of whole host page stacks
    ``[L, n, bt, hkv, d]`` (a ``QTensor`` of values and scales for an
    int8 pool), as its pool holds them."""
    index, count = tensor_shard(mesh)
    heads = pages.shape[3]
    if count == 1 or heads % count:
        return pages
    if isinstance(pages, QTensor):
        return QTensor(pages.values.chunk(count, dim=3)[index],
                       pages.scale.chunk(count, dim=3)[index], pages.axes)
    return pages.chunk(count, dim=3)[index]
