"""Training runtime: state init, the train step and the fit loop.  The
port of kubeflow_tpu/runtime/train.py.

The JAX ``Trainer`` jits one SPMD step over a mesh.  This one runs the
same step eagerly, on one explicit device or, with ``mesh`` (a
``DeviceMesh`` from parallel/mesh.py ``MeshSpec.build``), as one process
a GPU over the mesh's ``data``, ``fsdp``, ``pipeline``, ``expert``,
``sequence`` and ``tensor`` axes.  What carries over unchanged:

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

Under a mesh (JAX's ``param_shardings``, ``_opt_shardings`` and
``shard_batch``):

  - with ``tensor`` above 1 the task's model holds this rank's slices
    of the weights the rule table splits over ``tensor`` (heads, mlp and
    vocab), as plain local tensors marked with their ``TensorShard``
    (models/transformer.py, parallel/tensor.py); the kernels launch on
    the local tensors' memory, and FSDP2 takes a plain local tensor as a
    whole one, so no DTensor spans the ``tensor`` axis;
  - parameters are then sharded over ``fsdp`` and replicated over
    ``data`` and ``sequence`` with FSDP2 (``fully_shard`` per ``Block``
    and at the root: ZeRO-3 gathers a layer's weights for its forward
    and backward) over ``fsdp_mesh``, which holds the ranks of this
    rank's tensor index only.  Each parameter is sharded on the dim the
    rule table maps to ``fsdp`` from the JAX model's logical axes (the
    task's model gives them, ``param_logical_axes``; ``embed`` goes over
    fsdp), dim 0 for one the rule table leaves replicated;
  - the optimizer state follows its parameter: the optimizer runs on the
    sharded parameters (DTensors) when ``fsdp`` is above 1, and on the
    local tensors (whole, or their tensor slices) otherwise; the
    moments carry their parameter's ``TensorShard``, so checkpoints
    gather and split them as the parameters;
  - each process feeds its own rows (``shard_batch`` takes this rank's
    rows at the global sequence length and keeps its sequence shard);
  - the task's loss has the global loss as its value on every rank and
    that rank's share of it as its gradient (``lm_task(mesh=...)``).
    FSDP2 averages the gradients over its ranks (data x fsdp x
    sequence at one tensor index), so the step scales the backward by
    their number: the reduced gradient is the global loss's, as JAX's
    psum gives it.  The ranks of a tensor group each hold the whole
    gradient of their own slices and of the replicated weights;
  - with ``expert`` above 1 the MoE model holds this rank's experts of
    each ``moe.wi`` and ``moe.wo``, marked as the tensor slices are, and
    FSDP2's mesh is at this rank's expert index: the ranks of an expert
    group hold the same rows, their replicated weights' gradients whole
    and equal on each;
  - with ``pipeline`` above 1 the task's model holds its stage's layers
    (models/transformer.py, parallel/pipeline.py), and FSDP2 wraps only
    those, over the stage's own ranks; every stage computes the same
    loss from the broadcast outputs, so the embedding, final norm and
    unembed and their gradients are whole and equal on every stage;
  - ``grad_norm`` is the global norm over the shards (squares summed
    over ``fsdp``, over ``tensor`` and ``expert`` for the slices over
    them and over ``pipeline`` for a stage's layers, the rest counted
    once), and MFU counts every rank's chip.

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

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.parallel import tensor as tp
from kubeflow_tpu_torch.parallel.mesh import (
    DEFAULT_RULES,
    EXPERT,
    FSDP,
    PIPELINE,
    SEQUENCE,
    TENSOR,
    axis_sizes,
    fsdp_mesh,
    sharded_dim,
)
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


def place_batch(batch: Any, device: torch.device) -> Any:
    """Place a host batch (numpy or torch leaves) on ``device``.  On CUDA
    the copy goes through pinned memory without blocking the host, so it
    overlaps the step already enqueued."""
    cuda = device.type == "cuda"

    def put(x):
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if cuda and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return _tree_map(put, batch)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    to_local = getattr(t, "to_local", None)
    return to_local() if callable(to_local) else t


# The axes a parameter may be split over (not replicated): its bit in
# ``_split_bits``.
_SPLIT_AXES = (PIPELINE, TENSOR, EXPERT)


def _split_bits(param) -> int:
    """A bit for each axis of ``_SPLIT_AXES`` that ``param`` is split
    over: its ``TensorShard``'s axes, and ``pipeline`` for a stage's
    layer."""
    shard = tp.shard_of(param)
    axes = set(() if shard is None else shard.axes())
    if tp.stage_of(param) is not None:
        axes.add(PIPELINE)
    return sum(1 << bit for bit, axis in enumerate(_SPLIT_AXES)
               if axis in axes)


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
    """Trainer on one device (CUDA unless ``device="cpu"``), or on this
    rank's device over ``mesh``.

    init_fn: generator -> (model, mutable).
    loss_fn: (model, mutable, batch, generator) ->
      (scalar loss, (metrics dict, new_mutable)); under a mesh the loss's
      value is the global loss and its gradient this rank's share of it
      (``lm_task(mesh=...)``).
    tx: an optimizer with ``init(params)`` and
      ``update(grads, state, params)`` (runtime/optim.py).
    mesh / rules: a ``DeviceMesh`` from ``MeshSpec.build`` (every rank
      builds the same trainer and calls it in step) and the logical-axis
      rule table.
    """

    init_fn: Callable[[torch.Generator], Tuple[nn.Module, Any]]
    loss_fn: LossFn
    tx: Any
    device: DeviceLike = None
    mesh: Any = None  # a DeviceMesh from parallel/mesh.py MeshSpec.build
    rules: Any = DEFAULT_RULES
    checkpoints: Any = None  # runtime/checkpoint.py CheckpointManager
    checkpoint_every: int = 1000
    metrics: MetricsLogger = dataclasses.field(default_factory=MetricsLogger)
    # Useful-FLOPs per example for MFU reporting (0 = skip MFU).
    flops_per_example: float = 0.0
    peak_flops_per_chip: float = 0.0

    def __post_init__(self) -> None:
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
        if self.mesh is not None:
            # Every rank drew the same weights from the same seed; each
            # keeps its shards.
            self._shard(params)
        opt_state = self.tx.init(self._opt_view(params.named_parameters()))
        # The step's own stream (dropout's masks), apart from init's.
        rng = torch.Generator(device=self.device).manual_seed(seed + 1)
        return TrainState(step=0, params=params, opt_state=opt_state,
                          rng=rng, mutable=mutable)

    # -- step -------------------------------------------------------------

    def _shard(self, model: nn.Module) -> None:
        """FSDP2 over ``fsdp_mesh``: each Block, then the root, with each
        parameter sharded on the dim the rule table maps to ``fsdp``."""
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        axes_of = getattr(model, "param_logical_axes", dict)()
        names = {id(p): n for n, p in model.named_parameters()}
        before = dict(model.named_parameters())

        def placement(param):
            dim = sharded_dim(axes_of.get(names[id(param)], ()), FSDP,
                              self.rules)
            return Shard(0 if dim is None else dim)

        mesh = fsdp_mesh(self.mesh)
        for block in getattr(model, "layers", ()):
            fully_shard(block, mesh=mesh, shard_placement_fn=placement)
        fully_shard(model, mesh=mesh, shard_placement_fn=placement)
        # FSDP2's parameters replace the model's: they are the same
        # tensor slices of the same stage's layers.
        for name, param in model.named_parameters():
            tp.like(param, before[name])

    def _opt_view(self, named) -> Dict[str, torch.Tensor]:
        """What the optimizer steps: the tensors themselves, or under a
        mesh whose ``fsdp`` is 1 their local tensors, which are whole or
        (marked as the tensors are) their slices over ``tensor``."""
        named = dict(named)
        if self.mesh is None or axis_sizes(self.mesh)[FSDP] > 1:
            return named
        return {k: tp.like(_local(v), v) for k, v in named.items()}

    def _grad_norm(self, grads, params) -> torch.Tensor:
        """optax.global_norm of the step's gradients; under a mesh over
        the shards of every gradient: a sum of squares over ``fsdp``,
        over ``tensor`` and ``expert`` for the gradients whose parameter
        is a slice over that axis, and over ``pipeline`` for those of a
        stage's layers; the replicated ones counted once."""
        sizes = {} if self.mesh is None else axis_sizes(self.mesh)
        split = [(axis, _SPLIT_AXES.index(axis))
                 for axis in (TENSOR, EXPERT, PIPELINE)
                 if sizes.get(axis, 1) > 1]
        fsdp = sizes.get(FSDP, 1)
        if fsdp == 1 and not split:
            return global_norm([_local(g) for g in grads])
        import torch.distributed as dist

        sq = torch.stack(torch._foreach_norm(
            [_local(g).float() for g in grads])) ** 2
        # Each gradient's squares go to the sum of its kind: a bit for
        # each axis it is split over.
        kind = torch.tensor([_split_bits(p) for p in params],
                            device=sq.device)
        sq = torch.zeros(2 ** len(_SPLIT_AXES), device=sq.device
                         ).index_add_(0, kind, sq)
        if fsdp > 1:
            dist.all_reduce(sq, group=self.mesh.get_group(FSDP))
        for axis, bit in split:
            over = [k for k in range(sq.numel()) if k >> bit & 1]
            summed = sq.clone()
            dist.all_reduce(summed, group=self.mesh.get_group(axis))
            sq[over] = summed[over]
        return torch.sqrt(sq.sum())

    def _step_body(self, state: TrainState, batch: Any
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = dict(state.params.named_parameters())
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss, (aux, new_mutable) = self.loss_fn(
                state.params, state.mutable, batch, state.rng)
            ranks = 1 if self.mesh is None else fsdp_mesh(self.mesh).size()
            # FSDP2 averages over its ranks; each rank's gradient is its
            # share of the global loss's, so the sum is wanted.
            (loss * ranks if ranks > 1 else loss).backward()
        grads = self._opt_view((n, p.grad) for n, p in params.items())
        grad_norm = self._grad_norm(list(grads.values()),
                                    list(params.values()))
        self.tx.update(grads, state.opt_state, self._opt_view(params))
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
        """Place a host batch on the device (``place_batch``).  Under a
        mesh the batch is this rank's rows at the global sequence length
        (every rank of a ``sequence`` group feeds the same rows), and
        each ``[b, s, ...]`` leaf keeps this rank's sequence shard."""
        if self.mesh is not None and axis_sizes(self.mesh)[SEQUENCE] > 1:
            n = axis_sizes(self.mesh)[SEQUENCE]
            r = self.mesh.get_local_rank(SEQUENCE)

            def cut(x):
                x = np.asarray(x) if not torch.is_tensor(x) else x
                if x.ndim < 2:
                    return x
                if x.shape[1] % n:
                    raise ValueError(
                        f"sequence length {x.shape[1]} does not split over "
                        f"{n} sequence ranks")
                s = x.shape[1] // n
                return x[:, r * s:(r + 1) * s]

            batch = _tree_map(cut, batch)
        return place_batch(batch, self.device)

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
                    n_chips=1 if self.mesh is None else self.mesh.size(),
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
