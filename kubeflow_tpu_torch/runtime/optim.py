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
also take plain sequences.

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

Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]

# optax.adamw's defaults.
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4
# optax.adafactor's defaults.
DECAY_RATE, MIN_DIM_SIZE_TO_FACTOR, FACTORED_EPS = 0.8, 128, 1e-30
CLIPPING_THRESHOLD, MIN_PARAM_SCALE = 1.0, 1e-3

Tensors = Union[Sequence[torch.Tensor], Mapping[str, torch.Tensor]]


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
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

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


def adamw(learning_rate: ScalarOrSchedule) -> AdamW:
    """optax.adamw(learning_rate) with optax's defaults."""
    return AdamW(learning_rate)


def _lr(learning_rate: ScalarOrSchedule, count: int) -> float:
    return float(learning_rate(count) if callable(learning_rate)
                 else learning_rate)


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
    factored statistics in the stacked leaf's shapes: ``v_row`` and
    ``v_col`` for a factored leaf (``v`` a [1] placeholder), ``v`` for
    the others (``v_row``, ``v_col`` placeholders), all float32."""

    count: int
    v_row: Dict[str, torch.Tensor]
    v_col: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _leaf(tensors: Mapping[str, torch.Tensor], members: List[str]
          ) -> torch.Tensor:
    """The JAX leaf of ``members``: stacked [L, ...] for layers (a copy),
    the tensor itself for a leaf of its own."""
    if len(members) == 1 and not members[0].startswith("layers."):
        return tensors[members[0]]
    return torch.stack([tensors[n] for n in members])


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
            first = params[members[0]]
            shape = list(first.shape)
            if members[0].startswith("layers."):
                shape = [len(members)] + shape
            dims = _factored_dims(shape)

            def zeros(s):
                return torch.zeros(s, dtype=torch.float32,
                                   device=first.device)

            if dims is None:
                state.v_row[leaf], state.v_col[leaf] = zeros(1), zeros(1)
                state.v[leaf] = zeros(shape)
            else:
                d1, d0 = dims
                state.v_row[leaf] = zeros(np.delete(shape, d0).tolist())
                state.v_col[leaf] = zeros(np.delete(shape, d1).tolist())
                state.v[leaf] = zeros(1)
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
            g = _leaf(grads, members)
            p = _leaf(params, members)
            u = self._scaled(leaf, g, state, decay)
            # clip_by_block_rms(1.0): u / max(1, rms(u) / threshold).
            rms_u = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms_u / CLIPPING_THRESHOLD, min=1.0)
            # scale_by_learning_rate, then scale_by_param_block_rms.
            u = u * lr
            rms_p = torch.sqrt(torch.mean(p * p))
            u = u * torch.where(rms_p <= MIN_PARAM_SCALE,
                                torch.full_like(rms_p, MIN_PARAM_SCALE),
                                rms_p)
            # scale(-1), applied.
            if len(members) == 1 and not members[0].startswith("layers."):
                params[members[0]].sub_(u)
            else:
                torch._foreach_sub_([params[n] for n in members],
                                    list(u.unbind(0)))
        state.count += 1

    @staticmethod
    def _scaled(leaf: str, g: torch.Tensor, state: AdafactorState,
                decay: float) -> torch.Tensor:
        """scale_by_factored_rms on one leaf: updates the leaf's
        statistics in place and returns g scaled by their inverse root."""
        g_sqr = g * g + FACTORED_EPS
        dims = _factored_dims(list(g.shape))
        if dims is None:
            v = state.v[leaf]
            v.mul_(decay).add_(g_sqr, alpha=1.0 - decay)
            return g * torch.rsqrt(v)
        d1, d0 = dims
        v_row, v_col = state.v_row[leaf], state.v_col[leaf]
        v_row.mul_(decay).add_(g_sqr.mean(d0), alpha=1.0 - decay)
        v_col.mul_(decay).add_(g_sqr.mean(d1), alpha=1.0 - decay)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = v_row.mean(reduced_d1, keepdim=True)
        row_factor = torch.rsqrt(v_row / row_col_mean)
        col_factor = torch.rsqrt(v_col)
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)


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
        trace = ([torch.zeros_like(p) for p in params]
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


def sgd(learning_rate: ScalarOrSchedule,
        momentum: Optional[float] = None) -> Sgd:
    """optax.sgd(learning_rate, momentum) (no Nesterov term)."""
    return Sgd(learning_rate, momentum)
