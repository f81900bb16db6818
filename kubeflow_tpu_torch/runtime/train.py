"""Training runtime: state init, the train step and the fit loop, on one
device.  The port of kubeflow_tpu/runtime/train.py.

The JAX ``Trainer`` jits one SPMD step over a mesh.  This one runs the
same step eagerly on one explicit device: a mesh raises
``NotPortedError`` (parallel training, ROADMAP queue 1, item 11).  What
carries over unchanged:

  - the task contract: ``init_fn(generator) -> (model, mutable)`` and
    ``loss_fn(model, mutable, batch, rng) -> (loss, (metrics, mutable))``
    (models/transformer.py ``lm_task``);
  - the step: loss, gradients, optimizer update, step + 1, with ``loss``,
    ``grad_norm`` and the task's metrics kept as device tensors;
  - the fit loop's dispatch discipline: no host sync except at log and
    checkpoint boundaries, at most two calls in flight, the next batch
    staged while the current step runs, ``on_step`` at each call
    boundary and the ``train.step`` fault site before each dispatch;
  - verified checkpoints (runtime/checkpoint.py): ``fit`` resumes from
    the newest verified step, skips the batches already trained (the
    data's ``seek`` or a drain), saves every ``checkpoint_every`` steps
    on call boundaries, and ends with a save of the last step and a
    ``wait()``.

The optimizer gets the parameters and gradients by name
(``named_parameters()`` order), which adafactor needs to stack the JAX
model's layer leaves.  The state is updated in place (parameters,
gradients and optimizer moments), where the JAX step returns a new one
into donated buffers.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger, Timer
from kubeflow_tpu_torch.runtime.optim import global_norm
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)

# (model, mutable, batch, generator) -> (loss, (metrics dict, new_mutable))
LossFn = Callable[
    [nn.Module, Any, Any, torch.Generator],
    Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], Any]],
]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer state, the step count
    (a host int: reading it never syncs the device), the generator of the
    step's randomness and the task's mutable collections."""

    step: int
    params: nn.Module
    opt_state: Any
    rng: torch.Generator
    mutable: Any = dataclasses.field(default_factory=dict)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _Done:
    """Stands for a call in flight: ``synchronize()`` waits for the work
    enqueued before it was made (nothing to wait for on the CPU)."""

    def __init__(self, device: torch.device):
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def synchronize(self) -> None:
        if self._event is not None:
            self._event.synchronize()


@dataclasses.dataclass
class Trainer:
    """Trainer on one device (CUDA unless ``device="cpu"``).

    init_fn: generator -> (model, mutable).
    loss_fn: (model, mutable, batch, generator) ->
      (scalar loss, (metrics dict, new_mutable))
    tx: an optimizer with ``init(params)`` and
      ``update(grads, state, params)`` (runtime/optim.py).
    """

    init_fn: Callable[[torch.Generator], Tuple[nn.Module, Any]]
    loss_fn: LossFn
    tx: Any
    device: DeviceLike = None
    mesh: Any = None
    checkpoints: Any = None  # runtime/checkpoint.py CheckpointManager
    checkpoint_every: int = 1000
    metrics: MetricsLogger = dataclasses.field(default_factory=MetricsLogger)
    # Useful-FLOPs per example for MFU reporting (0 = skip MFU).
    flops_per_example: float = 0.0
    peak_flops_per_chip: float = 0.0

    def __post_init__(self) -> None:
        if self.mesh is not None:
            raise NotPortedError(
                "a mesh (parallel training) is not ported yet: ROADMAP "
                "queue 1, item 11; the port trains on one device")
        self.device = resolve_device(self.device)
        self._multi_steps: Dict[int, Callable] = {}
        self._last_metrics: Dict[str, float] = {}

    @property
    def last_metrics(self) -> Dict[str, float]:
        """Scalar metrics from the final step of the last fit() call
        (empty before any fit)."""
        return dict(self._last_metrics)

    # -- state ------------------------------------------------------------

    def create_state(self, seed: int = 0) -> TrainState:
        """Draw the model's weights from ``seed`` on the device and
        initialize the optimizer state."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params, mutable = self.init_fn(gen)
        opt_state = self.tx.init(dict(params.named_parameters()))
        # The step's own stream (dropout, once ported), apart from init's.
        rng = torch.Generator(device=self.device).manual_seed(seed + 1)
        return TrainState(step=0, params=params, opt_state=opt_state,
                          rng=rng, mutable=mutable)

    # -- step -------------------------------------------------------------

    def _step_body(self, state: TrainState, batch: Any
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = dict(state.params.named_parameters())
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss, (aux, new_mutable) = self.loss_fn(
                state.params, state.mutable, batch, state.rng)
            loss.backward()
        grads = {name: p.grad for name, p in params.items()}
        grad_norm = global_norm(list(grads.values()))
        self.tx.update(grads, state.opt_state, params)
        for p in params.values():
            p.grad = None  # gradients live only inside the step
        state.step += 1
        state.mutable = new_mutable
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, **aux}
        return state, metrics

    def compile_step(self) -> Callable[[TrainState, Any],
                                       Tuple[TrainState, Dict]]:
        """The step function.  PyTorch runs eagerly, so there is nothing
        to compile; capturing the step as a CUDA graph is later work."""
        return self._step_body

    def compile_multi_step(
        self, k: int
    ) -> Callable[[TrainState, Any], Tuple[TrainState, Dict]]:
        """K train steps per call over a list of k device batches; returns
        the last step's metrics."""
        if k in self._multi_steps:
            return self._multi_steps[k]

        def run(state: TrainState, batches: Any):
            if len(batches) != k:
                raise ValueError(f"{len(batches)} batches for a {k}-step "
                                 "call")
            metrics: Dict[str, torch.Tensor] = {}
            for batch in batches:
                state, metrics = self._step_body(state, batch)
            return state, metrics

        self._multi_steps[k] = run
        return run

    def shard_batch(self, batch: Any) -> Any:
        """Place a host batch (numpy or torch leaves) on the device.  On
        CUDA the copy goes through pinned memory without blocking the
        host, so it overlaps the step already enqueued."""
        cuda = self.device.type == "cuda"

        def put(x):
            t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                else x)
            if cuda and t.device.type == "cpu":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

        return _tree_map(put, batch)

    # -- loop -------------------------------------------------------------

    def fit(
        self,
        data: Iterable[Any],
        num_steps: int,
        *,
        state: Optional[TrainState] = None,
        examples_per_step: int = 0,
        log_every: int = 10,
        steps_per_call: int = 1,
        on_step: Optional[Callable[[int], None]] = None,
    ) -> TrainState:
        """Run the train loop with metrics and periodic verified
        checkpoints.  With a checkpoint manager attached, the run resumes
        from its newest verified step (rerunning the same command is the
        whole recovery contract), and batches already trained are not
        replayed: the data's ``seek(start_step)`` where it has one, else
        a drain.

        Dispatch discipline (as in the JAX trainer):
          - steps are enqueued asynchronously; the host never waits for
            the device except at log boundaries (one float(loss));
          - the *next* batch is copied to the device while the current
            step is still executing;
          - step time is averaged over the window since the last sync;
          - at most two calls are in flight: the host waits for the call
            from two calls ago, so at most two calls' batches are
            resident ahead of the device;
          - ``steps_per_call=k`` runs k steps per call
            (compile_multi_step); logging lands on call boundaries.

        Each loop iteration fires the ``train.step`` fault site BEFORE the
        dispatch, and ``on_step(i_next)`` runs at each call boundary
        (runtime/supervisor.py stamps its heartbeat there).
        """
        if state is None:
            state = self.create_state()
        start_step = 0
        if self.checkpoints is not None:
            state, start_step = self.checkpoints.restore_or_init(state)
        if start_step >= num_steps:
            self._last_metrics = {}
            return state
        step_fn = self.compile_step()
        it = iter(data)
        if start_step:
            seek = getattr(data, "seek", None)
            if callable(seek):
                seek(start_step)
            else:
                for _ in range(start_step):
                    next(it)
        final_metrics: Dict[str, Any] = {}
        k = max(1, int(steps_per_call))
        multi_fn = self.compile_multi_step(k) if k > 1 else None
        batch = self.shard_batch(next(it))
        timer = Timer()
        timer.start()
        window_steps = 0
        inflight: Deque[_Done] = deque()
        i = start_step
        while i < num_steps:
            faults.fire("train.step")
            if multi_fn is not None and i + k <= num_steps:
                chunk = [batch]
                for _ in range(k - 1):
                    chunk.append(self.shard_batch(next(it)))
                state, metrics = multi_fn(state, chunk)
                advance = k
            else:
                state, metrics = step_fn(state, batch)
                advance = 1
            i_next = i + advance
            window_steps += advance
            if i_next < num_steps:
                # Overlaps with the step enqueued above.
                batch = self.shard_batch(next(it))
            inflight.append(_Done(self.device))
            if len(inflight) > 2:
                # Backpressure: in steady state this call is already
                # done, so the wait is free — it only paces the host.
                inflight.popleft().synchronize()
            if on_step is not None:
                on_step(i_next)
            last = i_next - 1
            if log_every and (i_next // log_every > i // log_every
                              or i_next == num_steps):
                loss = float(metrics["loss"])  # device sync
                dt = timer.stop() / window_steps
                timer.start()
                window_steps = 0
                self.metrics.step(
                    step=last,
                    step_time_s=dt,
                    examples_per_step=examples_per_step,
                    flops_per_step=self.flops_per_example * examples_per_step * 3
                    if self.flops_per_example else None,
                    n_chips=1,
                    peak_flops_per_chip=self.peak_flops_per_chip or None,
                    loss=loss,
                )
            if (self.checkpoints is not None and i_next // self.checkpoint_every
                    > i // self.checkpoint_every):
                self.checkpoints.save(last, state)
            final_metrics = metrics
            i = i_next
        if self.checkpoints is not None:
            self.checkpoints.save(num_steps - 1, state)
            self.checkpoints.wait()
        self._last_metrics = {
            key: float(v) for key, v in final_metrics.items()
            if torch.is_tensor(v) and v.dim() == 0
        }
        return state
