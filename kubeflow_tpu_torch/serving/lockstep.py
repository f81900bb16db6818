"""The lockstep channel of a tensor-parallel engine: rank 0 leads, the
other ranks replay its device calls in the same order.

The JAX package serves a mesh from one process, so its engine's host
side (front end, scheduler, prefix cache, block tables) drives every
device of the mesh with each program call.  The port's mesh is one
process a GPU (parallel/mesh.py), so rank 0 alone runs the host side and
every call that writes or reads device state goes through one choke
point there, ``Channel.call``: it broadcasts the call (a target key, a
method name and the call's host arguments) to the other ranks over a CPU
process group, then runs it; every other rank receives the call in
``Channel.follow`` and runs the same method on its own copy of the
target, on its own slices.  The model's collectives inside the call
(its all-reduces and the logits' all-gather) then meet across the ranks.
``Channel.announce`` broadcasts an event that only the followers act on
(an engine built on rank 0, which each follower builds too), and
``close`` ends their loops.

The invariant: followers run exactly the device calls rank 0 ran, in the
same order.  A call is broadcast only when rank 0 is about to run it, so
a call that rank 0 skips (a fault site that aborts a round) is skipped
everywhere.  One mutex serializes rank 0's calls across its threads (an
engine's loop, a hot swap building the next engine, the heartbeat), so
two threads never interleave their collectives.

The command group is gloo (a ``gloo`` subgroup when the job's group is
NCCL), and its collectives time out after the bootstrap's timeout: a
dead rank fails the job with an error, never a hang.  While rank 0 is
idle it sends a no-op every quarter of that timeout, so idle followers
do not time out.
"""

from __future__ import annotations

import datetime
import logging
import threading
from typing import Any, Callable, Dict, Optional

from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)

_ATTR = "_kft_lockstep"
_LEADER = 0


class ChannelClosed(RuntimeError):
    """The channel was closed, or a collective on it failed (a rank died
    or timed out): no more calls reach the followers."""


class RankFault(ChannelClosed):
    """A call that every rank runs failed on at least one of them
    (``Channel.agree``): it is raised on every rank, and the channel
    takes no more calls, since the ranks' device state may differ."""


class Channel:
    """Rank 0's choke point and the followers' replay loop over one CPU
    process ``group`` of ``size`` ranks."""

    def __init__(self, group, rank: int, size: int, timeout_s: float):
        self.group = group
        self.rank = rank
        self.size = size
        self.timeout_s = float(timeout_s)
        # Rank 0: one call at a time, whichever thread makes it.
        self._mutex = threading.RLock()
        self._targets: Dict[str, Any] = {}
        self._next_key = 0
        self._closed = False
        self._error: Optional[BaseException] = None
        self._last_send = faults.monotonic()
        self._stop = threading.Event()
        self._beat: Optional[threading.Thread] = None
        if self.leader:
            self._beat = threading.Thread(
                target=self._heartbeat, daemon=True, name="lockstep-beat")
            self._beat.start()

    @property
    def leader(self) -> bool:
        return self.rank == _LEADER

    # -- every rank -------------------------------------------------------

    def register(self, key: str, target: Any) -> None:
        """Make ``target`` the object that calls on ``key`` run on, on
        this rank."""
        self._targets[key] = target

    def unregister(self, key: str) -> None:
        self._targets.pop(key, None)

    def target(self, key: str) -> Any:
        """This rank's target of ``key``."""
        return self._targets[key]

    def gather_cat(self, local, dim: int):
        """Every rank's CPU tensor ``local`` (equal shapes), concatenated
        along ``dim`` in rank order: an all-gather over the channel's
        group, made inside a call that every rank runs."""
        import torch
        import torch.distributed as dist

        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(self.size)]
        try:
            dist.all_gather(parts, local, group=self.group)
        except Exception as exc:
            raise self._broken(ChannelClosed(
                f"lockstep all-gather failed on rank {self.rank}: "
                f"{exc!r}")) from exc
        return torch.cat(parts, dim=dim)

    def agree(self, error: Optional[BaseException], what: str) -> None:
        """Every rank's verdict on a call that they all run (``error``:
        this rank's failure, or None), met in one all-reduce before the
        call's own collectives: when any rank failed, every rank raises
        ``RankFault`` here, so that none is left waiting inside a
        collective that another skipped."""
        import torch
        import torch.distributed as dist

        failed = torch.tensor([int(error is not None)], dtype=torch.int64)
        try:
            dist.all_reduce(failed, group=self.group)
        except Exception as exc:
            raise self._broken(ChannelClosed(
                f"lockstep agreement on {what} failed on rank "
                f"{self.rank}: {exc!r}")) from exc
        if failed.item():
            raise self._broken(RankFault(
                f"{what} failed on {failed.item()} of {self.size} ranks "
                f"(this rank: {error!r})")) from error

    def _broken(self, exc: ChannelClosed) -> ChannelClosed:
        """Mark the channel failed (rank 0 sends nothing more) and return
        ``exc`` to raise."""
        if self._error is None:
            self._error = exc
        return exc

    # -- rank 0 -----------------------------------------------------------

    def new_key(self, prefix: str) -> str:
        """A key no target of this channel has had (rank 0)."""
        with self._mutex:
            self._next_key += 1
            return f"{prefix}-{self._next_key}"

    def call(self, key: str, method: str, *args):
        """Rank 0: broadcast ``key.method(*args)`` to the followers, then
        run it on this rank's target and return its result.  ``args``
        are host values (numpy arrays, CPU tensors, plain data)."""
        with self._mutex:
            self._send((key, method, args))
            return getattr(self._targets[key], method)(*args)

    def announce(self, event: str, *args) -> None:
        """Rank 0: broadcast ``event(*args)`` for the followers' handler
        of that name to run; nothing runs here."""
        with self._mutex:
            self._send((None, event, args))

    def close(self) -> None:
        """Rank 0: end the followers' loops (idempotent)."""
        with self._mutex:
            if self._closed:
                return
            try:
                if self._error is None:
                    self._send((None, "exit", ()))
            finally:
                self._closed = True
                self._stop.set()

    def _send(self, message) -> None:
        import torch.distributed as dist

        if not self.leader:
            raise RuntimeError("only rank 0 sends on the lockstep channel")
        if self._closed or self._error is not None:
            raise ChannelClosed(
                "lockstep channel is closed"
                + (f" ({self._error!r})" if self._error else ""))
        try:
            dist.broadcast_object_list([message], src=_LEADER,
                                       group=self.group)
        except Exception as exc:
            self._error = exc
            raise ChannelClosed(
                f"lockstep broadcast failed: {exc!r}") from exc
        self._last_send = faults.monotonic()

    def _heartbeat(self) -> None:
        period = self.timeout_s / 4.0
        while not self._stop.wait(period / 4.0):
            with self._mutex:
                if self._closed or self._error is not None:
                    return
                if faults.monotonic() - self._last_send < period:
                    continue
                try:
                    self._send((None, "noop", ()))
                except ChannelClosed:
                    log.error("lockstep heartbeat failed: a follower rank "
                              "is gone", exc_info=True)
                    return

    # -- the other ranks --------------------------------------------------

    def follow(self, handlers: Dict[str, Callable]) -> None:
        """The followers' loop: receive each call rank 0 makes and run it
        on this rank's target of the same key, or an announced event on
        its handler in ``handlers``, until rank 0 closes the channel.  A
        failed receive (rank 0 gone, or silent past the timeout) raises
        ``ChannelClosed``."""
        import torch.distributed as dist

        if self.leader:
            raise RuntimeError("rank 0 leads the lockstep channel")
        while True:
            box = [None]
            try:
                dist.broadcast_object_list(box, src=_LEADER,
                                           group=self.group)
            except Exception as exc:
                raise ChannelClosed(
                    f"lockstep receive failed on rank {self.rank}: "
                    f"{exc!r}") from exc
            key, method, args = box[0]
            if key is not None:
                getattr(self._targets[key], method)(*args)
            elif method == "exit":
                return
            elif method != "noop":
                handlers[method](*args)


def attach(mesh, timeout_s: Optional[float] = None) -> Channel:
    """Create the lockstep channel of ``mesh`` (a collective: every rank
    calls it once, as ``serving/sharding.py build_mesh`` does) and keep
    it on the mesh.  Its group is gloo over the mesh's ranks, with
    ``timeout_s`` (default: the mesh's groups' timeout)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S

    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    group = dist.new_group(ranks, backend="gloo",
                           timeout=datetime.timedelta(seconds=timeout_s))
    chan = Channel(group, ranks.index(dist.get_rank()), len(ranks),
                   timeout_s)
    setattr(mesh, _ATTR, chan)
    return chan


def channel(mesh) -> Channel:
    """The lockstep channel ``attach`` kept on ``mesh``."""
    chan = getattr(mesh, _ATTR, None)
    if chan is None:
        raise ValueError("this mesh has no lockstep channel: build serving "
                         "meshes with serving/sharding.py build_mesh")
    return chan
