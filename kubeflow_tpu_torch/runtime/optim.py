"""Optimizers with optax's semantics, on PyTorch tensors.

The JAX package trains with ``optax.adamw`` or ``optax.adafactor``
(tools/train_lm.py, bench.py), its CNNs with ``optax.sgd(lr,
momentum=0.9)`` (tools/train_cnn.py, bench.py's ResNet cell) and, behind
``--warmup-steps``, ``optax.warmup_cosine_decay_schedule``.
PyTorch's own classes differ from them where it matters (``AdamW``'s
weight decay defaults to 0.01 and is decoupled from the learning-rate
schedule differently; its ``Adafactor`` is another algorithm), so this
module writes optax's arithmetic out:

  - ``adamw``: optax.adamw = scale_by_adam(b1, b2, eps, eps_root) ->
    add_decayed_weights(weight_decay, applied to every parameter) ->
    scale by -learning_rate(count), at optax's defaults (b1 0.9, b2
    0.999, eps 1e-8, eps_root 0, weight_decay 1e-4), the values the JAX
    package trains with;
  - ``adafactor``: optax.adafactor at its defaults =
    scale_by_factored_rms(factored, decay_rate 0.8, decay_offset 0,
    min_dim_size_to_factor 128, eps 1e-30) -> clip_by_block_rms(1.0) ->
    scale by learning_rate(count) -> scale_by_param_block_rms(min_scale
    1e-3) -> scale(-1); no momentum, no weight decay.  Its "blocks" are
    JAX leaves: the JAX model stacks each layer parameter into one
    ``[L, ...]`` leaf, where the port holds ``layers.{i}.<name>`` per
    layer, so adafactor takes the parameters by name and works on the
    stacked leaf (``leaf_groups``): its factored dims, its block RMS and
    its statistics are the JAX leaf's;
  - ``sgd``: optax.sgd = trace(decay=momentum, nesterov=False) ->
    scale by -learning_rate(count): ``trace = g + momentum * trace``,
    then ``param += -lr * trace``; with ``momentum=None`` the update is
    ``-lr * g`` and no trace is kept;
  - schedules count updates from 0: update t uses schedule(t), so the
    first update under a warmup from 0 changes nothing;
  - ``global_norm`` is optax.global_norm.

All take the parameters and gradients as a name -> tensor mapping (as
``Trainer`` passes them, in ``named_parameters()`` order); adamw and sgd
also take plain sequences.  Under a mesh whose ``fsdp`` axis is above 1
the trainer hands the optimizers the sharded parameters (DTensors: adamw
and sgd run their elementwise arithmetic on each shard, and the moments
are sharded as their parameters are); a parameter that is a slice over
``tensor`` (parallel/tensor.py), or over ``expert`` (an MoE weight's
experts), passes its ``TensorShard`` on to its moments.

adafactor computes on every rank what optax.adafactor computes on the
whole JAX leaf, whatever split the leaf is under: FSDP2's ``Shard(dim)``
(read from the DTensor's placements; its local tensor, torch.chunk's
slice, holds no padding), ``TensorShard`` slices over ``tensor`` and
``expert`` (chained over expert x tensor), and under ``pipeline`` > 1 a
stage's L/S layers (``leaf_groups`` on its local names stack its own
layers: the stacked leaf is split over ``pipeline`` on its layer dim).
Each rank's leaf is its local tensors, with the splits of their dims
(``_layout``):

  - the factored dims are the whole leaf's (``_factored_dims`` of its
    global shape, never of the local one);
  - a mean over a dim is the local sum, all-reduced over every group
    that splits that dim, over the whole dim's size: ``v_row`` (over
    d0), ``v_col`` (over d1) and ``row_col_mean`` (``v_row`` over d1);
  - a statistic keeps the split of every dim it keeps and is replicated
    over the groups of the dim it reduces: ``v`` (unfactored) is sharded
    as its parameter; ``v_row`` is replicated over d0's groups and
    sharded over the others, ``v_col`` likewise over d1's.  Each is
    marked with its ``TensorShard`` chain (uneven ``fsdp`` links for
    FSDP2's shards), so checkpoints gather it to JAX's layout;
  - the block RMS of clip_by_block_rms and of scale_by_param_block_rms
    sums squares over every group that splits the leaf, over the whole
    leaf's size.

A leaf under no split computes as one device does.

The fused trainer (runtime/hfta.py) steps N members whose leaves and
states are stacked on a leading member axis.  Its optimizer is
``default_tx_factory(lr)`` (optax.inject_hyperparams(optax.adamw)): the
learning rate rides in the state as data, so stacking the members'
states gives an ``[M]`` learning-rate vector beside ``[M]`` counts.
``update_members(grads, state, params, keep)`` is the update of the
stack: each member's count, bias corrections and learning rate are
``[M]`` device tensors broadcast over its leaves, every candidate is
computed out of place, and only the rows ``keep`` ([M] bool) selects are
written, so a masked member's parameters, statistics and count stay
bit-exact.  adafactor picks its factored dims and blocks from the solo
leaf's shape (``[L, ...]``), never the stacked one, as the member axis is
invisible under ``jax.vmap``.

The update runs in place on the parameters and the moment buffers (one
set of foreach kernels per step; JAX's functional update allocates new
ones, which XLA's buffer donation then reuses).  The step count is a host
integer, so the bias corrections and the learning rate never read the
device.  adafactor stacks each layered leaf for its update (one copy of
those parameters and gradients a step) and writes the update back per
layer.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import (
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from kubeflow_tpu_torch.parallel import p2p
from kubeflow_tpu_torch.parallel import tensor as tp

Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]

# optax.adamw's defaults.
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4
# optax.adafactor's defaults.
DECAY_RATE, MIN_DIM_SIZE_TO_FACTOR, FACTORED_EPS = 0.8, 128, 1e-30
CLIPPING_THRESHOLD, MIN_PARAM_SCALE = 1.0, 1e-3

Tensors = Union[Sequence[torch.Tensor], Mapping[str, torch.Tensor]]


def _zeros_like(p: torch.Tensor) -> torch.Tensor:
    """A moment buffer for ``p``: zeros sharded and marked as ``p`` is."""
    return tp.like(torch.zeros_like(p), p)


def _values(tensors: Tensors) -> List[torch.Tensor]:
    return list(tensors.values() if isinstance(tensors, Mapping)
                else tensors)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32 (a device
    scalar: no host sync)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule (transition_begin 0)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError("cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha=alpha, exponent=exponent)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        return decay(count - warmup_steps)

    return schedule


@dataclasses.dataclass
class AdamState:
    """Updates taken so far (host int) and the first and second moments,
    one float32 buffer per parameter, in parameter order."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw as an in-place update: ``state = tx.init(params)``,
    then ``tx.update(grads, state, params)`` after each backward.
    Parameters are float32 master weights, as in the JAX package."""

    learning_rate: ScalarOrSchedule

    def init(self, params: Tensors) -> AdamState:
        params = _values(params)
        _check_float32("adamw", params)
        return AdamState(count=0,
                         mu=[_zeros_like(p) for p in params],
                         nu=[_zeros_like(p) for p in params])

    def lr(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based)."""
        return _lr(self.learning_rate, count)

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamState,
               params: Tensors) -> None:
        params, grads = _values(params), _values(grads)
        mu, nu = state.mu, state.nu
        lr = self.lr(state.count)
        t = state.count + 1
        # mu = b1 mu + (1 - b1) g; nu = b2 nu + (1 - b2) g^2
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - B2)
        # update = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * param
        denom = torch._foreach_div(nu, 1 - B2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        step = torch._foreach_div(mu, 1 - B1 ** t)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(step, params, alpha=WEIGHT_DECAY)
        torch._foreach_mul_(step, -lr)
        torch._foreach_add_(params, step)
        state.count = t

    @torch.no_grad()
    def update_members(self, grads: Tensors, state: AdamState,
                       params: Tensors, keep: torch.Tensor,
                       lr: torch.Tensor) -> None:
        """The update of stacked members (module docstring): leaves [M,
        ...], ``state.count`` [M] int, ``lr`` [M] float32 (the injected
        state's; this optimizer's own is not read); rows where ``keep``
        is False unchanged."""
        t = state.count + 1
        bc1, bc2 = _bias_correction(B1, t), _bias_correction(B2, t)
        for p, g, mu, nu in zip(_values(params), _values(grads), state.mu,
                                state.nu):
            mu_new = torch.add(mu * B1, g, alpha=1 - B1)
            nu_new = torch.addcmul(nu * B2, g, g, value=1 - B2)
            denom = (nu_new / _rows(bc2, p)).sqrt_().add_(EPS)
            step = (mu_new / _rows(bc1, p)).div_(denom)
            step.add_(p, alpha=WEIGHT_DECAY).mul_(_rows(-lr, p))
            _keep_rows(keep, ((mu, mu_new), (nu, nu_new), (p, p + step)))
        state.count = torch.where(keep, t, state.count)


def adamw(learning_rate: ScalarOrSchedule) -> AdamW:
    """optax.adamw(learning_rate) with optax's defaults."""
    return AdamW(learning_rate)


def _lr(learning_rate: ScalarOrSchedule, count: int) -> float:
    return float(learning_rate(count) if callable(learning_rate)
                 else learning_rate)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-member [M] vector shaped to broadcast over a stacked leaf."""
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def _keep_rows(keep: torch.Tensor, pairs) -> None:
    """Write each candidate into its buffer in the rows ``keep`` selects
    (``pairs``: (buffer, candidate)); the other rows stay bit-exact."""
    for buf, new in pairs:
        buf.copy_(torch.where(_rows(keep, buf), new, buf))


def _bias_correction(decay: float, t: torch.Tensor) -> torch.Tensor:
    """1 - decay ** t in float64, rounded to float32: the value a host
    float from the solo update's integer count becomes in its kernel."""
    return (1.0 - decay ** t.double()).float()


def _check_float32(name: str, params: Sequence[torch.Tensor]) -> None:
    bad = [tuple(p.shape) for p in params if p.dtype != torch.float32]
    if bad:
        raise TypeError(f"{name} keeps float32 parameters; got other "
                        f"dtypes at shapes {bad}")


_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


def leaf_groups(names: Sequence[str]) -> Dict[str, List[str]]:
    """The JAX leaf each parameter belongs to: ``layers.{i}.<rest>`` for
    every i stack, in layer order, into the one leaf ``layers.<rest>``
    (the JAX model's ``[L, ...]`` layer stack); any other name is a leaf
    of its own.  Leaf -> its parameters' names, in first-seen order."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for name in names:
        m = _LAYER.match(name)
        leaf, index = (f"layers.{m.group(2)}", int(m.group(1))) if m \
            else (name, 0)
        groups.setdefault(leaf, []).append((index, name))
    out = {}
    for leaf, members in groups.items():
        indices = sorted(i for i, _ in members)
        if indices != list(range(len(members))):
            raise ValueError(f"layer parameters of {leaf} are not layers "
                             f"0..{len(members) - 1}: {indices}")
        out[leaf] = [n for _, n in sorted(members)]
    return out


def _factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims`` (factored=True): the second-largest and
    the largest axis by numpy's argsort (ties resolve as numpy's do), or
    None below two dims or when the second is under 128."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


@dataclasses.dataclass
class AdafactorState:
    """Updates taken so far (host int) and, per JAX leaf name, optax's
    factored statistics in the stacked leaf's shapes (this rank's share
    of them under a split, module docstring): ``v_row`` and ``v_col`` for
    a factored leaf (``v`` a [1] placeholder), ``v`` for the others
    (``v_row``, ``v_col`` placeholders), all float32."""

    count: int
    v_row: Dict[str, torch.Tensor]
    v_col: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage); any other tensor
    itself."""
    to_local = getattr(t, "to_local", None)
    return to_local() if callable(to_local) else t


def _is_layered(members: List[str]) -> bool:
    return members[0].startswith("layers.")


def _leaf(tensors: Mapping[str, torch.Tensor], members: List[str]
          ) -> torch.Tensor:
    """This rank's part of the JAX leaf of ``members``: its local
    tensors stacked [L, ...] for layers (a copy), the local tensor itself
    for a leaf of its own."""
    if not _is_layered(members):
        return _local(tensors[members[0]])
    return torch.stack([_local(tensors[n]) for n in members])


def _member_leaf(tensors: Mapping[str, torch.Tensor], members: List[str]
                 ) -> torch.Tensor:
    """``_leaf`` of stacked members: [M, L, ...] for layers (a copy), the
    [M, ...] tensor itself for a leaf of its own."""
    if not _is_layered(members):
        return tensors[members[0]]
    return torch.stack([tensors[n] for n in members], dim=1)


def _fsdp_splits(t: torch.Tensor) -> List[tp.TensorShard]:
    """FSDP2's splits of a DTensor ``t``: one uneven ``fsdp`` split for
    each mesh dim it is sharded over (its ``Shard(dim)`` placements),
    none for another tensor."""
    if not callable(getattr(t, "to_local", None)):
        return []
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    return [tp.TensorShard(placement.dim, coord[i], mesh.size(i),
                           mesh.get_group(i), "fsdp",
                           size=t.shape[placement.dim])
            for i, placement in enumerate(t.placements)
            if placement.is_shard()]


@dataclasses.dataclass(frozen=True)
class _Layout:
    """A JAX leaf's whole shape and this rank's splits of it: one
    ``TensorShard`` (no ``then``) per split, its dim the leaf's."""

    whole: Tuple[int, ...]
    splits: Tuple[tp.TensorShard, ...]

    def groups(self, dim: Optional[int] = None) -> List:
        """The groups that split ``dim`` (every dim when None)."""
        return [s.group for s in self.splits if dim is None or s.dim == dim]

    def mark(self, t: torch.Tensor, removed: Optional[int]) -> torch.Tensor:
        """``t``, a statistic of the leaf without dim ``removed`` (None:
        all of its dims), marked with the splits of the dims it keeps."""
        chain = None
        for s in self.splits:
            if s.dim == removed:
                continue
            dim = s.dim - int(removed is not None and s.dim > removed)
            chain = dataclasses.replace(s, dim=dim, then=chain)
        return tp.mark(t, chain)


def _layout(params: Mapping[str, torch.Tensor], members: List[str],
            stacked: bool = False) -> _Layout:
    """The layout of the JAX leaf of ``members``: FSDP2's splits of its
    DTensors, then their ``TensorShard`` slices over ``tensor`` and
    ``expert``, then for a stage's layers the ``pipeline`` split of the
    layer dim.  ``stacked``: the tensors are members' ``[M, ...]`` stacks
    marked as their solo leaves are (runtime/hfta.py), and the layout is
    a member's."""
    first = params[members[0]]
    splits = _fsdp_splits(first)
    shard = tp.shard_of(first)
    shape = tuple(first.shape[1:] if stacked else first.shape)
    whole = shape if shard is None else shard.whole_shape(shape)
    while shard is not None:
        splits.append(dataclasses.replace(shard, then=None))
        shard = shard.then
    if not _is_layered(members):
        return _Layout(whole, tuple(splits))
    splits = [dataclasses.replace(s, dim=s.dim + 1) for s in splits]
    stage = tp.stage_of(first)
    layers = len(members)
    if stage is not None:
        layers *= stage.count
        splits.append(tp.TensorShard(0, stage.index, stage.count,
                                     stage.group, "pipeline"))
    return _Layout((layers,) + whole, tuple(splits))


def _sum_over(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The sum of ``t`` over each of ``groups`` in turn (orthogonal
    axes of the mesh: their product's sum)."""
    for group in groups:
        t = p2p.all_reduce(t, group)
    return t


def _mean(t: torch.Tensor, dim: int, layout: _Layout, leaf_dim: int,
          keepdim: bool = False) -> torch.Tensor:
    """The mean of the whole leaf's values along its dim ``leaf_dim``
    (``dim`` of ``t``): the local sum all-reduced over the groups that
    split that dim, over its whole size; ``t.mean`` where none does."""
    groups = layout.groups(leaf_dim)
    if not groups:
        return t.mean(dim, keepdim=keepdim)
    return _sum_over(t.sum(dim, keepdim=keepdim), groups) \
        / layout.whole[leaf_dim]


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """optax.adafactor as an in-place update over named float32
    parameters: ``state = tx.init(named)``, then
    ``tx.update(named_grads, state, named)``."""

    learning_rate: ScalarOrSchedule

    def _groups(self, params) -> Dict[str, List[str]]:
        if not isinstance(params, Mapping):
            raise TypeError(
                "adafactor takes the parameters by name (a name -> tensor "
                "mapping, as Trainer passes them): its blocks are the JAX "
                "model's stacked leaves")
        return leaf_groups(list(params))

    def init(self, params: Mapping[str, torch.Tensor]) -> AdafactorState:
        _check_float32("adafactor", _values(params))
        state = AdafactorState(count=0, v_row={}, v_col={}, v={})
        for leaf, members in self._groups(params).items():
            layout = _layout(params, members)
            local = _local(params[members[0]])
            shape = list(local.shape)
            if _is_layered(members):
                shape = [len(members)] + shape
            dims = _factored_dims(layout.whole)

            def zeros(s, removed=None):
                return layout.mark(torch.zeros(s, dtype=torch.float32,
                                               device=local.device), removed)

            def placeholder():
                return torch.zeros(1, dtype=torch.float32,
                                   device=local.device)

            if dims is None:
                state.v_row[leaf] = placeholder()
                state.v_col[leaf] = placeholder()
                state.v[leaf] = zeros(shape)
            else:
                d1, d0 = dims
                state.v_row[leaf] = zeros(np.delete(shape, d0).tolist(), d0)
                state.v_col[leaf] = zeros(np.delete(shape, d1).tolist(), d1)
                state.v[leaf] = placeholder()
        return state

    def lr(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based)."""
        return _lr(self.learning_rate, count)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor],
               state: AdafactorState,
               params: Mapping[str, torch.Tensor]) -> None:
        # optax: decay_rate_t = 1 - (count + 1) ** -0.8 in float32.
        t = np.float32(state.count + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-DECAY_RATE))
        lr = self.lr(state.count)
        for leaf, members in self._groups(params).items():
            layout = _layout(params, members)
            g = _leaf(grads, members)
            p = _leaf(params, members)
            u = self._scaled(leaf, g, state, decay, layout)
            # clip_by_block_rms(1.0): u / max(1, rms(u) / threshold).
            rms_u, rms_p = _block_rms(u, p, layout)
            u = u / torch.clamp(rms_u / CLIPPING_THRESHOLD, min=1.0)
            # scale_by_learning_rate, then scale_by_param_block_rms.
            u = u * lr
            u = u * torch.where(rms_p <= MIN_PARAM_SCALE,
                                torch.full_like(rms_p, MIN_PARAM_SCALE),
                                rms_p)
            # scale(-1), applied.
            if _is_layered(members):
                torch._foreach_sub_([_local(params[n]) for n in members],
                                    list(u.unbind(0)))
            else:
                _local(params[members[0]]).sub_(u)
        state.count += 1

    @torch.no_grad()
    def update_members(self, grads: Mapping[str, torch.Tensor],
                       state: AdafactorState,
                       params: Mapping[str, torch.Tensor],
                       keep: torch.Tensor, lr: torch.Tensor) -> None:
        """The update of stacked members (module docstring): each leaf
        [M, ...] and its statistics [M, ...], ``state.count`` [M] int,
        ``lr`` [M] float32 (the injected state's); the factored dims are
        the solo leaf's, the block RMS each member's own; rows where
        ``keep`` is False unchanged.  A leaf under a split (its solo
        marks, runtime/hfta.py) takes the whole JAX leaf's factored dims,
        means and block RMS as ``update`` does, each all-reduce on the
        members' stack."""
        t = state.count + 1
        # optax: decay_rate_t = 1 - (count + 1) ** -0.8, in float32.
        decay = 1.0 - (t.double() ** -DECAY_RATE).float()
        fresh = (1.0 - decay.double()).float()
        for leaf, members in self._groups(params).items():
            layout = _layout(params, members, stacked=True)
            g = _member_leaf(grads, members)
            p = _member_leaf(params, members)
            dims = _factored_dims(layout.whole)
            g_sqr = g * g + FACTORED_EPS
            if dims is None:
                v = state.v[leaf]
                v_new = v * _rows(decay, v) + g_sqr * _rows(fresh, v)
                u = g * torch.rsqrt(v_new)
                stats = ((v, v_new),)
            else:
                # d1, d0 are the solo leaf's dims, one less than the
                # stack's.
                d1, d0 = dims
                v_row, v_col = state.v_row[leaf], state.v_col[leaf]
                row_new = v_row * _rows(decay, v_row) \
                    + _mean(g_sqr, d0 + 1, layout, d0) * _rows(fresh, v_row)
                col_new = v_col * _rows(decay, v_col) \
                    + _mean(g_sqr, d1 + 1, layout, d1) * _rows(fresh, v_col)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = _mean(row_new, reduced_d1 + 1, layout, d1,
                                     keepdim=True)
                row_factor = torch.rsqrt(row_new / row_col_mean)
                col_factor = torch.rsqrt(col_new)
                u = g * row_factor.unsqueeze(d0 + 1) \
                    * col_factor.unsqueeze(d1 + 1)
                stats = ((v_row, row_new), (v_col, col_new))
            rms_u, rms_p = _member_block_rms(u, p, layout)
            u = u / _rows(torch.clamp(rms_u / CLIPPING_THRESHOLD, min=1.0), u)
            u = u * _rows(lr, u)
            u = u * _rows(torch.where(rms_p <= MIN_PARAM_SCALE,
                                      torch.full_like(rms_p, MIN_PARAM_SCALE),
                                      rms_p), u)
            p_new = p - u
            if _is_layered(members):
                news = [(params[n], p_new[:, i]) for i, n in enumerate(members)]
            else:
                news = [(params[members[0]], p_new)]
            _keep_rows(keep, stats + tuple(news))
        state.count = torch.where(keep, t, state.count)

    @staticmethod
    def _scaled(leaf: str, g: torch.Tensor, state: AdafactorState,
                decay: float, layout: _Layout) -> torch.Tensor:
        """scale_by_factored_rms on this rank's part of one leaf: updates
        its statistics in place and returns g scaled by their inverse
        root (the means over split dims all-reduced, module
        docstring)."""
        g_sqr = g * g + FACTORED_EPS
        dims = _factored_dims(layout.whole)
        if dims is None:
            v = _local(state.v[leaf])
            v.mul_(decay).add_(g_sqr, alpha=1.0 - decay)
            return g * torch.rsqrt(v)
        d1, d0 = dims
        v_row, v_col = _local(state.v_row[leaf]), _local(state.v_col[leaf])
        v_row.mul_(decay).add_(_mean(g_sqr, d0, layout, d0),
                               alpha=1.0 - decay)
        v_col.mul_(decay).add_(_mean(g_sqr, d1, layout, d1),
                               alpha=1.0 - decay)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = _mean(v_row, reduced_d1, layout, d1, keepdim=True)
        row_factor = torch.rsqrt(v_row / row_col_mean)
        col_factor = torch.rsqrt(v_col)
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)


def _block_rms(u: torch.Tensor, p: torch.Tensor, layout: _Layout
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sqrt(mean(t * t)) over the whole JAX leaf of the update ``u`` and
    of the parameter ``p`` (this rank's parts): under splits, the local
    sums of squares all-reduced together over every group that splits
    the leaf, over the whole leaf's size."""
    groups = layout.groups()
    if not groups:
        return torch.sqrt(torch.mean(u * u)), torch.sqrt(torch.mean(p * p))
    sq = _sum_over(torch.stack([torch.sum(u * u), torch.sum(p * p)]),
                   groups)
    rms = torch.sqrt(sq / math.prod(layout.whole))
    return rms[0], rms[1]


def _member_block_rms(u: torch.Tensor, p: torch.Tensor, layout: _Layout
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_block_rms`` of each member of the stacks ``u`` and ``p`` [M,
    ...]: two [M] vectors; under splits the local sums of squares of
    both, ``[2, M]``, all-reduced once over each group."""
    every = tuple(range(1, u.dim()))
    groups = layout.groups()
    if not groups:
        return (torch.sqrt(torch.mean(u * u, dim=every)),
                torch.sqrt(torch.mean(p * p, dim=every)))
    sq = _sum_over(torch.stack([torch.sum(u * u, dim=every),
                                torch.sum(p * p, dim=every)]), groups)
    rms = torch.sqrt(sq / math.prod(layout.whole))
    return rms[0], rms[1]


def adafactor(learning_rate: ScalarOrSchedule) -> Adafactor:
    """optax.adafactor(learning_rate) with optax's defaults."""
    return Adafactor(learning_rate)


@dataclasses.dataclass
class SgdState:
    """Updates taken so far (host int) and the momentum trace, one
    float32 buffer per parameter in parameter order (empty without
    momentum)."""

    count: int
    trace: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Sgd:
    """optax.sgd as an in-place update over float32 parameters:
    ``state = tx.init(params)``, then ``tx.update(grads, state, params)``."""

    learning_rate: ScalarOrSchedule
    momentum: Optional[float] = None

    def init(self, params: Tensors) -> SgdState:
        params = _values(params)
        _check_float32("sgd", params)
        trace = ([_zeros_like(p) for p in params]
                 if self.momentum is not None else [])
        return SgdState(count=0, trace=trace)

    def lr(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based)."""
        return _lr(self.learning_rate, count)

    @torch.no_grad()
    def update(self, grads: Tensors, state: SgdState,
               params: Tensors) -> None:
        params, grads = _values(params), _values(grads)
        lr = self.lr(state.count)
        step = grads
        if self.momentum is not None:
            # trace = g + momentum * trace
            torch._foreach_mul_(state.trace, self.momentum)
            torch._foreach_add_(state.trace, grads)
            step = state.trace
        torch._foreach_add_(params, torch._foreach_mul(step, -lr))
        state.count += 1

    @torch.no_grad()
    def update_members(self, grads: Tensors, state: SgdState,
                       params: Tensors, keep: torch.Tensor,
                       lr: torch.Tensor) -> None:
        """The update of stacked members (module docstring): leaves [M,
        ...], ``state.count`` [M] int, ``lr`` [M] float32 (the injected
        state's); rows where ``keep`` is False unchanged."""
        t = state.count + 1
        traces = state.trace or [None] * len(_values(params))
        for p, g, trace in zip(_values(params), _values(grads), traces):
            pairs = ()
            step = g
            if trace is not None:
                step = g + trace * self.momentum
                pairs = ((trace, step),)
            _keep_rows(keep, pairs + ((p, p + step * _rows(-lr, p)),))
        state.count = torch.where(keep, t, state.count)


def sgd(learning_rate: ScalarOrSchedule,
        momentum: Optional[float] = None) -> Sgd:
    """optax.sgd(learning_rate, momentum) (no Nesterov term)."""
    return Sgd(learning_rate, momentum)


@dataclasses.dataclass
class InjectedState:
    """optax.inject_hyperparams's state in the port's idiom: the learning
    rate as data (a float for one job, an [M] float32 tensor for stacked
    members) beside the inner optimizer's state."""

    learning_rate: Union[float, torch.Tensor]
    inner: object


@dataclasses.dataclass(frozen=True)
class InjectLearningRate:
    """``inner`` (adamw, adafactor or sgd) with its learning rate in its
    state: optax.inject_hyperparams(tx)(learning_rate=...).  The
    optimizer's own ``learning_rate`` is what ``init`` puts in the state;
    ``inner``'s is never read."""

    inner: Union[AdamW, "Adafactor", Sgd]
    learning_rate: float

    def init(self, params: Tensors) -> InjectedState:
        return InjectedState(learning_rate=float(self.learning_rate),
                             inner=self.inner.init(params))

    def update(self, grads: Tensors, state: InjectedState,
               params: Tensors) -> None:
        dataclasses.replace(
            self.inner, learning_rate=float(state.learning_rate)).update(
                grads, state.inner, params)

    def update_members(self, grads: Tensors, state: InjectedState,
                       params: Tensors, keep: torch.Tensor) -> None:
        self.inner.update_members(grads, state.inner, params, keep,
                                  state.learning_rate)


def default_tx_factory(lr: float) -> InjectLearningRate:
    """The fused trainer's default (runtime/hfta.py): adamw with the
    learning rate in its state, so that stacked members each step at
    their own rate."""
    return InjectLearningRate(adamw(0.0), lr)
