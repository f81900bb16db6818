"""Device meshes and logical-axis rules: the port of
kubeflow_tpu/parallel/mesh.py.

The axis names, their order, ``MeshSpec``'s size resolution and the rule
table are the JAX package's, copied (the port imports nothing of it).
What differs is what a mesh is made of.  In JAX a ``Mesh`` is a grid of
devices that one program sees; here a mesh is a grid of processes, one
GPU each, and ``MeshSpec.build()`` returns a ``torch.distributed``
``DeviceMesh`` over the world's ranks, laid out in ``AXIS_ORDER`` as the
JAX package reshapes ``jax.devices()``: rank = ((((data * fsdp + f) *
pipeline + p) * expert + e) * sequence + s) * tensor + t.  Only the axes
of size above 1 get process groups of their own; every axis of size 1
shares the rank's singleton group.

``logical_spec`` returns the mesh axes of each dim as a tuple, where JAX
returns a ``PartitionSpec`` of the same entries.  ``fsdp_mesh`` is the
mesh FSDP2 shards over: the ``fsdp`` axis, with the ``data`` and
``sequence`` axes, over which parameters are replicated, folded into one
replicate dim (HSDP) when either is above 1, at this rank's index along
``tensor``, ``pipeline`` and ``expert``: FSDP2 shards and reduces within
one tensor index, one stage and one expert index, never across them.
``row_shard`` is this rank's share of the batch's rows (data x fsdp);
``tensor_shard``, ``expert_shard`` and ``pipeline_stage`` are this
rank's place along ``tensor``, ``expert`` and ``pipeline``
(parallel/tensor.py, models/moe.py, parallel/pipeline.py);
``group_over`` is the group of the ranks along some axes at this rank's
index along the others, and ``batch_group`` that of the ranks that hold
other rows or positions of the batch (data x fsdp x sequence), over
which the loss and the MoE aux's statistics are summed.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device

# Canonical mesh axis names, outermost -> innermost (the JAX package's).
DATA = "data"
FSDP = "fsdp"
PIPELINE = "pipeline"
EXPERT = "expert"
SEQUENCE = "sequence"
TENSOR = "tensor"

AXIS_ORDER: Tuple[str, ...] = (DATA, FSDP, PIPELINE, EXPERT, SEQUENCE, TENSOR)

# Timeout of every process group a mesh creates (and of the one-rank
# world group ``build`` starts itself): a collective that waits longer
# raises instead of hanging the job.
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A declarative parallelism layout: axis name -> size.

    Sizes of 1 are kept; a single axis may be -1 meaning "absorb all
    remaining devices" (here: ranks, one GPU each)."""

    data: int = -1
    fsdp: int = 1
    pipeline: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1

    def sizes(self, n_devices: int) -> Dict[str, int]:
        """Resolve -1 against a device count; validate divisibility."""
        raw = {
            DATA: self.data,
            FSDP: self.fsdp,
            PIPELINE: self.pipeline,
            EXPERT: self.expert,
            SEQUENCE: self.sequence,
            TENSOR: self.tensor,
        }
        bad = {k: v for k, v in raw.items() if v < 1 and v != -1}
        if bad:
            raise ValueError(
                f"axis sizes must be positive (or -1 to infer), got {bad}"
            )
        wild = [k for k, v in raw.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(v for v in raw.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"fixed axes product {fixed} does not divide {n_devices} devices"
                )
            raw[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {raw} has {fixed} slots but the slice has {n_devices} devices"
            )
        return raw

    def build(self, device: DeviceLike = None, *, topology=None,
              timeout_s: float = DEFAULT_TIMEOUT_S):
        """A ``DeviceMesh`` over the world's ranks, named by
        ``AXIS_ORDER``, on ``device``'s type (CUDA unless the caller asks
        for the CPU).  Every rank calls it, in the same order as every
        other collective.  A job whose process group is not up yet is a
        one-process job (``runtime/bootstrap.py`` starts a multi-process
        one): the mesh then starts its one-rank group itself, NCCL on
        CUDA and gloo on the CPU.  A ``topology``
        (``runtime/topology.py``) must name as many devices as the job
        has ranks, or the build raises before any group is made."""
        import torch.distributed as dist

        dev = resolve_device(device)
        timeout = datetime.timedelta(seconds=timeout_s)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if topology is not None and topology.devices != world:
            raise ValueError(
                f"topology {topology.name} expects {topology.devices} "
                f"devices, runtime sees {world}")
        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(torch.cuda.current_device())
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                store=dist.HashStore(), rank=0, world_size=1,
                timeout=timeout)
        sizes = self.sizes(world)
        ranks = torch.arange(world, dtype=torch.int).reshape(
            [sizes[a] for a in AXIS_ORDER])
        singleton = None
        groups = []
        for dim, axis in enumerate(AXIS_ORDER):
            if sizes[axis] > 1:
                groups.append(_axis_groups(ranks, [dim], timeout))
                continue
            if singleton is None:
                singleton = dist.group.WORLD if world == 1 else \
                    dist.new_group([dist.get_rank()], timeout=timeout,
                                   use_local_synchronization=True)
            groups.append(singleton)
        return _from_groups(groups, dev.type, ranks, AXIS_ORDER)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """Axes over which gradients are averaged (batch-sharding axes)."""
        return (DATA, FSDP)


def _axis_groups(ranks: torch.Tensor, dims: List[int],
                 timeout: datetime.timedelta):
    """The process group of this rank along ``dims`` of the rank grid:
    every rank creates every group along them (``new_group``'s contract)
    and keeps the one it is in."""
    import torch.distributed as dist

    me = dist.get_rank()
    rest = [d for d in range(ranks.dim()) if d not in dims]
    rows = ranks.permute(rest + dims).reshape(
        -1, math.prod(ranks.shape[d] for d in dims))
    mine = None
    for row in rows.tolist():
        group = dist.new_group(row, timeout=timeout)
        if me in row:
            mine = group
    return mine


def _from_groups(groups, device_type: str, ranks: torch.Tensor,
                 names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    if len(groups) == 1:
        return DeviceMesh.from_group(groups[0], device_type,
                                     mesh=ranks.flatten(),
                                     mesh_dim_names=names)
    return DeviceMesh.from_group(groups, device_type, mesh=ranks,
                                 mesh_dim_names=names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh from ``MeshSpec.build``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _at_my_index(mesh, ranks: torch.Tensor, keep: List[str]
                 ) -> torch.Tensor:
    """The rank grid along the axes ``keep`` (in that order) at this
    rank's index along every other axis."""
    dims = [AXIS_ORDER.index(a) for a in keep]
    index = tuple(slice(None) if d in dims else mesh.get_local_rank(a)
                  for d, a in enumerate(AXIS_ORDER))
    left = [d for d in range(ranks.dim()) if d in dims]
    return ranks[index].permute([left.index(d) for d in dims])


def fsdp_mesh(mesh, timeout_s: float = DEFAULT_TIMEOUT_S):
    """The mesh FSDP2 shards parameters over: 1-D over ``fsdp`` when the
    ``data`` and ``sequence`` axes are both 1, else 2-D ``("replicate",
    "fsdp")`` with the ranks of ``data`` x ``sequence`` as the replicate
    dim (HSDP: gradients reduce-scattered over fsdp, all-reduced over
    replicate), at this rank's ``tensor`` and ``pipeline`` indices: ranks
    of different tensor indices hold different slices, and ranks of
    different stages different layers, and are never joined.  A
    collective: every rank calls it once per mesh, and the result is
    kept on the mesh."""
    cached = getattr(mesh, "_kft_fsdp_mesh", None)
    if cached is not None:
        return cached
    sizes = axis_sizes(mesh)
    ranks = mesh.mesh.to(torch.int)
    fsdp_group = mesh.get_group(FSDP)
    replicate = sizes[DATA] * sizes[SEQUENCE]
    if replicate == 1:
        import torch.distributed as dist

        out = _from_groups(
            [fsdp_group], mesh.device_type,
            torch.tensor(dist.get_process_group_ranks(fsdp_group)), (FSDP,))
    else:
        dims = [AXIS_ORDER.index(DATA), AXIS_ORDER.index(SEQUENCE)]
        rep_group = _axis_groups(
            ranks, dims, datetime.timedelta(seconds=timeout_s))
        grid = _at_my_index(mesh, ranks, [DATA, SEQUENCE, FSDP])
        out = _from_groups([rep_group, fsdp_group], mesh.device_type,
                           grid.reshape(replicate, sizes[FSDP]),
                           ("replicate", FSDP))
    mesh._kft_fsdp_mesh = out
    return out


def row_shard(mesh) -> Tuple[int, int]:
    """(this rank's index, count) of the batch's row shards, over
    ``data`` x ``fsdp``; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    sizes = axis_sizes(mesh)
    return (mesh.get_local_rank(DATA) * sizes[FSDP]
            + mesh.get_local_rank(FSDP), sizes[DATA] * sizes[FSDP])


def tensor_shard(mesh) -> Tuple[int, int]:
    """(this rank's index, size) along ``tensor``; (0, 1) without a
    mesh."""
    if mesh is None or axis_sizes(mesh)[TENSOR] == 1:
        return 0, 1
    return mesh.get_local_rank(TENSOR), axis_sizes(mesh)[TENSOR]


def pipeline_stage(mesh) -> Tuple[int, int]:
    """(this rank's stage, stages) along ``pipeline``; (0, 1) without a
    mesh.  The stage's process group is ``mesh.get_group(PIPELINE)``."""
    if mesh is None or axis_sizes(mesh)[PIPELINE] == 1:
        return 0, 1
    return mesh.get_local_rank(PIPELINE), axis_sizes(mesh)[PIPELINE]


def expert_shard(mesh) -> Tuple[int, int]:
    """(this rank's index, size) along ``expert``; (0, 1) without a
    mesh."""
    if mesh is None or axis_sizes(mesh)[EXPERT] == 1:
        return 0, 1
    return mesh.get_local_rank(EXPERT), axis_sizes(mesh)[EXPERT]


def group_over(mesh, axes: Sequence[str],
               timeout_s: float = DEFAULT_TIMEOUT_S):
    """The process group of the ranks along ``axes`` at this rank's index
    along every other axis: None when those axes are all 1 (the rank is
    alone), the axis's own group when one of them is above 1, the
    world's when they span every rank.  A collective on first use (every
    rank asks for the same groups in the same order), kept on the
    mesh."""
    sizes = axis_sizes(mesh)
    key = tuple(a for a in AXIS_ORDER if a in axes and sizes[a] > 1)
    cache = mesh.__dict__.setdefault("_kft_groups", {})
    if key in cache:
        return cache[key]
    import torch.distributed as dist

    if not key:
        out = None
    elif math.prod(sizes[a] for a in key) == mesh.size():
        out = dist.group.WORLD
    elif len(key) == 1:
        out = mesh.get_group(key[0])
    else:
        out = _axis_groups(mesh.mesh.to(torch.int),
                           [AXIS_ORDER.index(a) for a in key],
                           datetime.timedelta(seconds=timeout_s))
    cache[key] = out
    return out


def batch_group(mesh, timeout_s: float = DEFAULT_TIMEOUT_S):
    """The process group of the ranks that hold other rows or sequence
    positions of the batch than this one (data x fsdp x sequence) at its
    ``tensor``, ``pipeline`` and ``expert`` indices: the loss is summed
    over it, where a sum over the whole mesh would count each share once
    per tensor rank, per stage and per expert rank, which hold the same
    rows.  The world's group when that is every rank, and the world's
    too when the rank holds the whole batch alone (a group of one).  A
    collective on first use, kept on the mesh."""
    group = group_over(mesh, (DATA, FSDP, SEQUENCE), timeout_s)
    if group is None:
        import torch.distributed as dist

        return dist.group.WORLD if mesh.size() == 1 else \
            mesh.get_group(DATA)
    return group


# ---------------------------------------------------------------------------
# Logical axis rules (the JAX package's table)
# ---------------------------------------------------------------------------

LogicalRules = Tuple[Tuple[str, Union[str, Tuple[str, ...], None]], ...]

# Default rule table for transformer + conv models (megatron-style TP with
# FSDP weight sharding on the embed dim):
#   - weights: embed dim over fsdp (ZeRO-3: gathered per layer), heads/mlp/
#     vocab over tensor;
#   - activations: batch over (data, fsdp), seq over sequence (ring
#     attention / context parallelism).
DEFAULT_RULES: LogicalRules = (
    ("batch", (DATA, FSDP)),        # global batch sharded over both dp axes
    ("seq", SEQUENCE),              # context parallelism (ring attention)
    ("embed", FSDP),                # weight embed dim: ZeRO-3 over fsdp
    ("act_embed", None),            # activation feature dim between blocks
    ("heads", TENSOR),              # attention heads split across TP
    ("kv", None),                   # per-head dim never sharded
    ("mlp", TENSOR),                # MLP hidden dim split across TP
    ("vocab", TENSOR),              # embedding/output table split
    ("expert", EXPERT),             # MoE expert dim
    ("stage", PIPELINE),            # pipeline stage dim
    ("layers", PIPELINE),           # the layer stack under GPipe
    ("conv_out", None),             # conv channels replicated
    ("norm", None),
)


def rules_to_dict(rules: LogicalRules
                  ) -> Dict[str, Union[str, Tuple[str, ...], None]]:
    return dict(rules)


def logical_spec(
    logical_axes: Sequence[Optional[str]], rules: LogicalRules = DEFAULT_RULES
) -> Tuple[Union[str, Tuple[str, ...], None], ...]:
    """Map a tuple of logical dim names to mesh axes via the rule table:
    the entries of the JAX package's ``PartitionSpec``, as a tuple.

    Unknown or None logical names become unsharded dims.  A mesh axis may
    be used at most once per spec; later duplicates degrade to None, so
    e.g. ("embed", "mlp") with both mapped to TENSOR shards only the
    first.  Trailing Nones are dropped.
    """
    table = rules_to_dict(rules)
    used: set = set()
    out: List[Union[str, Tuple[str, ...], None]] = []
    for name in logical_axes:
        target = table.get(name) if name is not None else None
        if target is None:
            out.append(None)
            continue
        axes = (target,) if isinstance(target, str) else tuple(target)
        free = tuple(a for a in axes if a not in used)
        if not free:
            out.append(None)
            continue
        used.update(free)
        out.append(free[0] if len(free) == 1 else free)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def sharded_dim(logical_axes: Sequence[Optional[str]], axis: str,
                rules: LogicalRules = DEFAULT_RULES) -> Optional[int]:
    """The dim ``logical_spec`` places on mesh ``axis`` (alone or in a
    tuple), or None."""
    for dim, entry in enumerate(logical_spec(logical_axes, rules)):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return dim
    return None
