"""Optimizers with optax's semantics, on PyTorch tensors.

The JAX package trains with ``optax.adamw`` (tools/train_lm.py, bench.py)
and, behind ``--warmup-steps``, ``optax.warmup_cosine_decay_schedule``.
PyTorch's own classes differ from them where it matters (``AdamW``'s
weight decay defaults to 0.01 and is decoupled from the learning-rate
schedule differently; its ``Adafactor`` is another algorithm), so this
module writes optax's arithmetic out:

  - ``adamw``: optax.adamw = scale_by_adam(b1, b2, eps, eps_root) ->
    add_decayed_weights(weight_decay, applied to every parameter) ->
    scale by -learning_rate(count), at optax's defaults (b1 0.9, b2
    0.999, eps 1e-8, eps_root 0, weight_decay 1e-4), the values the JAX
    package trains with;
  - schedules count updates from 0: update t uses schedule(t), so the
    first update under a warmup from 0 changes nothing;
  - ``global_norm`` is optax.global_norm.

The update runs in place on the parameters and the moment buffers (one
set of foreach kernels per step; JAX's functional update allocates new
ones, which XLA's buffer donation then reuses).  The step count is a host
integer, so the bias corrections and the learning rate never read the
device.  ``adafactor`` is not ported yet (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence, Union

import torch

Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]

# optax.adamw's defaults.
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


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

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        bad = [tuple(p.shape) for p in params if p.dtype != torch.float32]
        if bad:
            raise TypeError(f"adamw keeps float32 parameters; got other "
                            f"dtypes at shapes {bad}")
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    def lr(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based)."""
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor]) -> None:
        params, grads = list(params), list(grads)
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
