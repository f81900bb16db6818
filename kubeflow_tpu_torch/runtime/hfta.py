"""Horizontally fused training arrays: N small jobs stepped as one program
on one device.  The port of kubeflow_tpu/runtime/hfta.py.

HFTA (PAPERS.md, arXiv 2102.02344) fuses a swarm of hyperparameter-sweep
jobs (same architecture, different lr and seed), each of which would
under-fill the card, along a leading member axis: parameters, optimizer
state and step counts become ``[members, ...]`` stacks stepped by one
program, so the card's launches and memory traffic are shared by the
whole family.  As in the JAX package:

  - **Per-member hparams.**  The learning rate rides inside the
    optimizer state (runtime/optim.py ``default_tx_factory``), so the
    stacked state holds an ``[members]`` lr vector that the one stacked
    update reads.  Seeds diverge each member's ``torch.Generator``.
  - **Active mask, not retirement.**  An early-stopped (``stop_step``)
    or diverged (non-finite loss) member freezes: the fused step still
    computes its candidate update, but a per-member boolean mask
    discards it, so its parameters, optimizer state, step and generator
    stay bit-exact at the freeze point.  The mask and the step counts
    are device tensors, read on the host only at log and checkpoint
    boundaries.
  - **Per-member checkpoints.**  Each member saves and restores its own
    solo-shaped port :class:`~kubeflow_tpu_torch.runtime.train.TrainState`
    under ``<checkpoint_dir>/<member.name>/`` through the verified
    :class:`~kubeflow_tpu_torch.runtime.checkpoint.CheckpointManager`, so
    a plain ``Trainer`` on ``default_tx_factory(member.lr)`` resumes a
    member as if it had run alone.  On a fused resume the gang re-enters
    at ``max(start_i)``; members that froze earlier re-enter masked.

The step, where JAX runs ``jax.jit(jax.vmap(member_step))``: the members'
parameters are stacked by ``torch.func.stack_module_state`` and one
member's loss is mapped over them with ``torch.func.vmap`` of
``functional_call``, all members on one shared batch (HFTA's shared
input).  The gradients come from one ``backward()`` of the summed member
losses; ``grad_norm`` is each member's own.  The map is
runtime/member_map.py's: a checkpointed region (remat) wraps the map
rather than sitting inside it, dropout masks are drawn from each
member's generator outside it, and the flash kernels fold the members
into one launch (ops/flash.py ``_FlashFunction.vmap``).  Width
invariance is to float tolerance here, not bit-identity: a member's
products run batched over the members, in another accumulation order
than its solo run's.

The fit loop keeps ``Trainer.fit``'s dispatch discipline (at most two
calls in flight, async checkpoints, the ``train.step`` fault site,
``on_step`` at each call boundary), so ``TrainSupervisor`` wraps a
FusedTrainer unchanged.  A mesh raises ``NotPortedError`` (a fused
trainer over a mesh, ROADMAP queue 1 item 22).  JAX's process-level cache
of traced steps has no counterpart: eager PyTorch has nothing to trace.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import deque
from typing import (Any, Callable, Deque, Dict, Iterable, List, Optional,
                    Sequence)

import numpy as np
import torch
from torch.func import stack_module_state, vmap

from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.runtime import member_map
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger, Timer
from kubeflow_tpu_torch.runtime.optim import default_tx_factory
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.runtime.train import (LossFn, TrainState, _Done,
                                              place_batch)
from kubeflow_tpu_torch.testing import faults


@dataclasses.dataclass(frozen=True)
class MemberSpec:
    """One fused-array member: a solo job's identity inside the gang.

    stop_step: freeze (mask) the member once its step counter reaches
      this value — the early-stop knob.  None = run to ``num_steps``.
    """

    name: str
    seed: int = 0
    lr: float = 1e-3
    tenant: str = "default"
    stop_step: Optional[int] = None


class _Tensor:
    """Stands for a tensor leaf in a state's form (``_form``)."""


def _form(tree: Any) -> Any:
    """A state's structure and host scalars, its tensors replaced by
    ``_Tensor``: what ``_unstack`` needs to rebuild one member."""
    if isinstance(tree, torch.Tensor):
        return _Tensor
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _form(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _form(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_form(v) for v in tree)
    return tree


def _stack(trees: Sequence[Any], device: torch.device) -> Any:
    """Solo states stacked on a new leading member axis on ``device``:
    tensors stacked, host ints (counts) an int64 and floats (learning
    rates) a float32 vector."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack([t.to(device) for t in trees])
    if isinstance(first, int):
        return torch.tensor(trees, dtype=torch.int64, device=device)
    if isinstance(first, float):
        return torch.tensor(trees, dtype=torch.float32, device=device)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(t, f.name) for t in trees], device)
            for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(xs), device) for xs in zip(*trees))
    raise TypeError(f"cannot stack a {type(first).__name__}")


def _unstack(form: Any, stacked: Any, i: int) -> Any:
    """Member ``i`` of a stacked state, in the solo ``form``: tensors
    copied, vectors back to host scalars (a float the stack rounded to
    float32 keeps the form's own value)."""
    if form is _Tensor:
        return stacked[i].detach().clone()
    if isinstance(form, int):
        return int(stacked[i])
    if isinstance(form, float):
        value = float(stacked[i])
        return form if float(np.float32(form)) == value else value
    if dataclasses.is_dataclass(form) and not isinstance(form, type):
        return dataclasses.replace(form, **{
            f.name: _unstack(getattr(form, f.name),
                             getattr(stacked, f.name), i)
            for f in dataclasses.fields(form)})
    if isinstance(form, dict):
        return {k: _unstack(v, stacked[k], i) for k, v in form.items()}
    if isinstance(form, (list, tuple)):
        return type(form)(_unstack(f, s, i) for f, s in zip(form, stacked))
    return form


def _select(keep: torch.Tensor, new: Any, old: Any) -> Any:
    """``torch.where(keep, new, old)`` over a stacked tree, member rows."""
    if isinstance(new, torch.Tensor):
        return torch.where(keep.reshape(keep.shape + (1,) * (new.dim() - 1)),
                           new, old)
    if isinstance(new, dict):
        return {k: _select(keep, v, old[k]) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        return type(new)(_select(keep, n, o) for n, o in zip(new, old))
    return new


def _copy_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


@dataclasses.dataclass
class FusedTrainer:
    """N same-architecture training jobs fused into one program on one
    device (CUDA unless ``device="cpu"``).

    init_fn / loss_fn: the same contracts as
      :class:`~kubeflow_tpu_torch.runtime.train.Trainer`; the member
      axis is this class's business.  Inside the fused step ``loss_fn``
      receives the model with one member's parameters mapped in, and for
      ``rng`` a ``member_map.MemberGenerators`` (each member's draws from
      its own generator).
    tx_factory: lr -> an optimizer with the lr in its state
      (``optim.InjectLearningRate``, whose ``update_members`` steps the
      stack), so that members differ; the default is
      ``optim.default_tx_factory``.
    members: the member array.  Order is the stacking order and the
      checkpoint subdirectory layout — keep it stable across resumes.
    mesh / rules: None; a mesh raises ``NotPortedError`` (a fused
      trainer over a mesh, ROADMAP queue 1 item 22).
    checkpoint_dir: per-member managers live at
      ``<checkpoint_dir>/<member.name>``; None disables checkpointing.
    mask_nonfinite: freeze a member whose loss goes non-finite instead
      of letting NaNs poison its params (the masked update discards
      the whole bad step, so the member holds its last finite state).

    The fused state ``fit`` returns is a ``TrainState`` whose ``step`` is
    an [M] int64 device tensor, ``params`` a name -> [M, ...] dict of
    stacked leaves, ``opt_state`` the members' states stacked (counts and
    learning rates as [M] vectors) and ``rng`` the members' generators;
    ``member_state(fused, i)`` is member i's solo state.
    """

    init_fn: Callable[[torch.Generator], Any]
    loss_fn: LossFn
    members: Sequence[MemberSpec]
    mesh: Any = None
    tx_factory: Callable[[float], Any] = default_tx_factory
    rules: Any = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1000
    max_to_keep: int = 3
    metrics: MetricsLogger = dataclasses.field(default_factory=MetricsLogger)
    mask_nonfinite: bool = True
    device: DeviceLike = None

    def __post_init__(self) -> None:
        if not self.members:
            raise ValueError("FusedTrainer needs at least one member")
        names = [m.name for m in self.members]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate member names: {names}")
        if self.mesh is not None or self.rules is not None:
            raise NotPortedError(
                "a fused trainer over a mesh is not ported yet: ROADMAP "
                "queue 1 item 22; the fused trainer runs on one device")
        self.device = resolve_device(self.device)
        self._tx = self.tx_factory(0.0)  # lr comes from opt_state
        self._skeleton: Optional[torch.nn.Module] = None
        self._forms: List[Any] = []
        self._managers: Dict[str, CheckpointManager] = {}
        self._last_metrics: Dict[str, float] = {}
        self._last_active: List[bool] = [True] * len(self.members)
        self._member_steps = REGISTRY.counter(
            "kft_train_member_steps_total",
            "optimizer steps applied per fused-array member")
        self._members_active = REGISTRY.gauge(
            "kft_train_members_active",
            "fused-array members currently unmasked")

    # -- observability -----------------------------------------------------

    @property
    def member_names(self) -> List[str]:
        return [m.name for m in self.members]

    @property
    def last_metrics(self) -> Dict[str, float]:
        return dict(self._last_metrics)

    @property
    def last_active(self) -> List[bool]:
        """Per-member mask after the last fit() call — False means the
        member froze (early stop, non-finite loss or num_steps reached)."""
        return list(self._last_active)

    # -- per-member state --------------------------------------------------

    def manager(self, member: MemberSpec) -> Optional[CheckpointManager]:
        if self.checkpoint_dir is None:
            return None
        mgr = self._managers.get(member.name)
        if mgr is None:
            mgr = CheckpointManager(
                f"{self.checkpoint_dir}/{member.name}",
                max_to_keep=self.max_to_keep)
            self._managers[member.name] = mgr
        return mgr

    def create_member_state(self, member: MemberSpec) -> TrainState:
        """Solo-shaped init, drawn exactly as ``Trainer.create_state``
        draws it (weights from ``seed``, the step generator from
        ``seed + 1``), so a member checkpoint round-trips with a plain
        Trainer on ``tx_factory(member.lr)``."""
        gen = torch.Generator(device=self.device).manual_seed(member.seed)
        params, mutable = self.init_fn(gen)
        opt_state = self.tx_factory(member.lr).init(
            dict(params.named_parameters()))
        rng = torch.Generator(device=self.device).manual_seed(
            member.seed + 1)
        return TrainState(step=0, params=params, opt_state=opt_state,
                          rng=rng, mutable=mutable)

    def member_state(self, fused: TrainState, i: int) -> TrainState:
        """Member ``i`` of a fused state as a solo-shaped TrainState
        (copies, and a copy of its generator): what gets checkpointed and
        what a solo Trainer would hold."""
        if self._skeleton is None:
            raise ValueError("no fused state was built by this trainer")
        model = copy.deepcopy(self._skeleton)
        model.load_state_dict(
            {k: v[i].detach().clone() for k, v in fused.params.items()},
            assign=True)
        opt_form, mutable_form = self._forms[i]
        return TrainState(
            step=int(fused.step[i]), params=model,
            opt_state=_unstack(opt_form, fused.opt_state, i),
            rng=_copy_generator(fused.rng[i]),
            mutable=_unstack(mutable_form, fused.mutable, i))

    def _stack_members(self, solo_states: Sequence[TrainState]
                       ) -> TrainState:
        """Stack solo states on a new leading member axis (copies: the
        solo states, generators included, are left as they are).  The
        parameters become stacked leaves (``stack_module_state``) over a
        parameterless copy of the first member's module, the skeleton
        every member's forward runs through."""
        models = [s.params for s in solo_states]
        params, buffers = stack_module_state(models)
        if buffers:
            raise NotPortedError("a fused model with buffers is not ported "
                                 "(the port's LM has none)")
        params = {k: v.detach().to(self.device).requires_grad_()
                  for k, v in params.items()}
        memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"))
                for p in models[0].parameters()}
        self._skeleton = copy.deepcopy(models[0], memo)
        self._forms = [(_form(s.opt_state), _form(s.mutable))
                       for s in solo_states]
        return TrainState(
            step=torch.tensor([int(s.step) for s in solo_states],
                              dtype=torch.int64, device=self.device),
            params=params,
            opt_state=_stack([s.opt_state for s in solo_states],
                             self.device),
            rng=[_copy_generator(s.rng) for s in solo_states],
            mutable=_stack([s.mutable for s in solo_states], self.device))

    # -- fused step --------------------------------------------------------

    def _fused_step(self, state: TrainState, active: torch.Tensor,
                    stops: torch.Tensor, batch: Any):
        """Every member's candidate step, then the mask: members whose
        ``active`` is off (or whose loss is non-finite, with
        ``mask_nonfinite``) keep their state bit-exact."""
        n = len(self.members)
        params = state.params
        for p in params.values():
            p.grad = None
        skeleton, gens = self._skeleton, state.rng

        def member(p, mutable, index, batch):
            rng = member_map.MemberGenerators(gens, index)
            loss, (aux, new_mutable) = member_map.call(
                skeleton, p, self.loss_fn, mutable, batch, rng)
            return loss, aux, new_mutable

        with torch.enable_grad():
            with member_map.mapping(n):
                losses, aux, new_mutable = vmap(
                    member, in_dims=(0, 0, 0, None))(
                        params, state.mutable,
                        torch.arange(n, device=self.device), batch)
            losses.sum().backward()
        grads = {k: p.grad for k, p in params.items()}
        grad_norm = torch.stack([
            g.float().square().flatten(1).sum(1) for g in grads.values()
        ]).sum(0).sqrt()
        losses = losses.detach()
        keep = active & torch.isfinite(losses) if self.mask_nonfinite \
            else active
        self._tx.update_members(grads, state.opt_state, params, keep)
        for p in params.values():
            p.grad = None  # gradients live only inside the step
        state.step = torch.where(keep, state.step + 1, state.step)
        state.mutable = _select(keep, new_mutable, state.mutable)
        metrics = {"loss": losses, "grad_norm": grad_norm,
                   **{k: v.detach() for k, v in aux.items()}}
        return state, keep & (state.step < stops), metrics

    def compile_step(self) -> Callable:
        """The fused step, ``(state, active, stops, batch) -> (state,
        active, metrics)``.  PyTorch runs eagerly, so there is nothing
        to compile or to cache across trainers."""
        return self._fused_step

    def shard_batch(self, batch: Any) -> Any:
        """One batch feeds every member (HFTA's shared-input shape),
        placed on the device as ``Trainer.shard_batch`` places it."""
        return place_batch(batch, self.device)

    # -- loop --------------------------------------------------------------

    def _stop_of(self, member: MemberSpec, num_steps: int) -> int:
        return min(num_steps, member.stop_step
                   if member.stop_step is not None else num_steps)

    def fit(
        self,
        data: Iterable[Any],
        num_steps: int,
        *,
        member_states: Optional[Sequence[TrainState]] = None,
        examples_per_step: int = 0,
        log_every: int = 10,
        on_step: Optional[Callable[[int], None]] = None,
    ) -> TrainState:
        """Run the fused loop; returns the final stacked TrainState.

        member_states: each member's initial solo state (as
          ``Trainer.fit(state=...)`` takes one), in member order; by
          default ``create_member_state``.  A state re-enters at its own
          step, as a restored one does (``member_state`` of an earlier
          run continues it), and a checkpointed member still resumes
          from its newest verified step.

        Resume: each member independently ``restore_or_init``s from its
        own verified subdirectory; the gang re-enters at
        ``max(start_i)`` with members that froze earlier (or already
        hit their stop) re-entering masked — their state rides along
        untouched.
        """
        n = len(self.members)
        if member_states is not None and len(member_states) != n:
            raise ValueError(f"{len(member_states)} member states for "
                             f"{n} members")
        solo_states: List[TrainState] = []
        starts: List[int] = []
        for i, m in enumerate(self.members):
            init = (member_states[i] if member_states is not None
                    else self.create_member_state(m))
            mgr = self.manager(m)
            st, s0 = init, int(init.step)
            if mgr is not None:
                mgr.wait()  # a restart restores what the last run queued
                st, s0 = mgr.restore_or_init(init)
                if st is init:
                    s0 = int(init.step)
            solo_states.append(st)
            starts.append(s0)
        gang_start = max(starts)
        stops = [self._stop_of(m, num_steps) for m in self.members]
        active_host = [starts[i] == gang_start and gang_start < stops[i]
                       for i in range(n)]
        state = self._stack_members(solo_states)
        del solo_states
        self._members_active.set(float(sum(active_host)))
        if gang_start >= num_steps or not any(active_host):
            self._last_active = active_host
            self._last_metrics = {}
            return state

        step_fn = self.compile_step()
        active = torch.tensor(active_host, device=self.device)
        stops_arr = torch.tensor(stops, dtype=torch.int64,
                                 device=self.device)

        it = iter(data)
        if gang_start:
            seek = getattr(data, "seek", None)
            if callable(seek):
                seek(gang_start)
            else:
                for _ in range(gang_start):
                    next(it)

        # A masked member has drawn its step's randomness all the same;
        # at each boundary its generator goes back to the state it had
        # after its own last applied step (``settle``).
        gens = state.rng
        marks = [[g.get_state()] for g in gens]
        marked_at = list(starts)
        last_saved = [s - 1 for s in starts]
        last_counted = list(starts)

        def settle() -> List[int]:
            """Host read of the step counts at a boundary: count each
            member's new steps and restore the generators of those that
            froze since the last boundary."""
            steps_host = [int(s) for s in state.step.tolist()]
            for idx, m in enumerate(self.members):
                delta = steps_host[idx] - last_counted[idx]
                if delta > 0:
                    self._member_steps.inc(delta, member=m.name)
                last_counted[idx] = steps_host[idx]
                gens[idx].set_state(
                    marks[idx][steps_host[idx] - marked_at[idx]])
                marks[idx] = [gens[idx].get_state()]
                marked_at[idx] = steps_host[idx]
            return steps_host

        def save(idx: int, steps_host: List[int]) -> None:
            mgr = self.manager(self.members[idx])
            saved = steps_host[idx] - 1
            if mgr is not None and saved >= 0 and saved != last_saved[idx]:
                mgr.save(saved, self.member_state(state, idx))
                last_saved[idx] = saved

        save_points = {s for s in stops if s < num_steps}
        final_metrics: Dict[str, Any] = {}
        batch = self.shard_batch(next(it))
        timer = Timer()
        timer.start()
        window_steps = 0
        inflight: Deque[_Done] = deque()
        i = gang_start
        while i < num_steps:
            faults.fire("train.step")
            state, active, metrics = step_fn(state, active, stops_arr, batch)
            for idx, g in enumerate(gens):
                marks[idx].append(g.get_state())
            i_next = i + 1
            window_steps += 1
            if i_next < num_steps:
                batch = self.shard_batch(next(it))
            inflight.append(_Done(self.device))
            if len(inflight) > 2:
                inflight.popleft().synchronize()
            if on_step is not None:
                on_step(i_next)
            last = i_next - 1
            at_end = i_next == num_steps
            crossed_stop = i_next in save_points
            at_boundary = (
                i_next // self.checkpoint_every > i // self.checkpoint_every)
            if log_every and (i_next // log_every > i // log_every or at_end):
                losses = metrics["loss"].tolist()  # device sync
                act = active.tolist()
                dt = timer.stop() / window_steps
                timer.start()
                window_steps = 0
                live = [float(l) for l, a in zip(losses, act) if a]
                settle()  # keeps the generator marks short
                self.metrics.step(
                    step=last,
                    step_time_s=dt,
                    examples_per_step=examples_per_step * max(1, sum(act)),
                    n_chips=1,
                    loss=sum(live) / len(live) if live else None,
                    members=n,
                    members_active=int(sum(act)),
                )
            final_metrics = metrics
            i = i_next
            if crossed_stop or at_boundary or at_end:
                steps_host = settle()
                act_host = active.tolist()
                self._members_active.set(float(sum(act_host)))
                for idx in range(n):
                    if at_boundary or at_end or steps_host[idx] == stops[idx]:
                        save(idx, steps_host)
                if not any(act_host):
                    # Every member froze: the remaining gang steps would
                    # be pure masked no-ops — finish early.
                    break
        # Final settle: save any member whose newest step never hit a
        # boundary (covers non-finite freezes and the early break).
        steps_host = settle()
        for idx in range(n):
            save(idx, steps_host)
        for mgr in self._managers.values():
            mgr.wait()
        act_host = [bool(a) for a in active.tolist()]
        self._last_active = act_host
        self._members_active.set(float(sum(act_host)))
        losses = final_metrics["loss"].tolist() if final_metrics else []
        self._last_metrics = {
            f"loss/{m.name}": float(l)
            for m, l in zip(self.members, losses)
        }
        if losses:
            self._last_metrics["loss"] = float(
                sum(float(l) for l in losses) / len(losses))
        return state
