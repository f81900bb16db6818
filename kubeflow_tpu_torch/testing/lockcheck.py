"""Opt-in runtime lock-ORDER sanitizer (``KFT_LOCKCHECK=1``).

The port's copy of kubeflow_tpu/testing/lockcheck.py (stdlib only).

The static lock-guard checker (analysis/locks.py) proves writes hold
the right lock; it cannot see *ordering* — thread A taking
``state._lock`` then ``breaker._lock`` while thread B nests them the
other way deadlocks only under exactly the wrong interleaving, which
no amount of test repetition reliably produces.  This module makes
the ordering observable instead: with the sanitizer installed,
``threading.Lock()`` returns an instrumented lock that

  * tags every lock with its ALLOCATION SITE (file:line) — ordering
    discipline is a property of code sites, not lock instances (all
    ``EndpointState._lock``s are one node);
  * keeps a per-thread stack of held locks and a global site-level
    acquisition graph: acquiring B while holding A adds edge A->B;
  * records a violation whenever a new edge closes a cycle in the
    site graph — the static signature of a potential deadlock, caught
    on the FIRST run that exercises both orders, no interleaving luck
    required.

Violations are recorded, not raised: throwing inside ``acquire``
would corrupt whatever invariant the caller's critical section
protects and turn one report into cascade noise.  The pytest fixture
(tests/torch_lockcheck.py) enables the sanitizer for the port's
serving/engine/fleet/scheduler/supervisor test modules under
``KFT_LOCKCHECK=1`` and FAILS the test at teardown if any violation was
recorded.

Same-site edges (two ``EndpointState._lock`` instances held at once)
are ignored: instance-level ordering within one site needs an
instance key (e.g. always lock lower id() first) that site granularity
cannot express — flagging them would drown real inversions.

Scope: only locks CREATED while installed are instrumented (the
wrapper replaces the ``threading.Lock`` factory; existing locks are
untouched), so enable it before constructing the objects under test.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

ENV = "KFT_LOCKCHECK"

_real_lock = threading.Lock


def enabled_in_env(environ=os.environ) -> bool:
    return environ.get(ENV, "").strip() not in ("", "0", "false")


class LockOrderViolation:
    """One cycle-closing acquisition, with both paths spelled out."""

    def __init__(self, edge: Tuple[str, str], cycle: List[str],
                 thread: str):
        self.edge = edge
        self.cycle = cycle
        self.thread = thread

    def __repr__(self) -> str:
        path = " -> ".join(self.cycle)
        return (f"lock-order inversion on {self.thread}: acquiring "
                f"{self.edge[1]} while holding {self.edge[0]} closes "
                f"the cycle [{path}]")


class LockOrderSanitizer:
    """The acquisition-graph recorder shared by every checked lock."""

    def __init__(self):
        self._graph_lock = _real_lock()
        # site -> set of sites acquired while this one was held
        self._edges: Dict[str, Set[str]] = {}
        self._violations: List[LockOrderViolation] = []
        self._sites: Set[str] = set()
        self._tls = threading.local()

    # -- called from _CheckedLock ------------------------------------------

    def note_created(self, site: str) -> None:
        with self._graph_lock:
            self._sites.add(site)

    def _held(self) -> List[Tuple[str, int]]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def note_acquired(self, site: str, ident: int) -> None:
        stack = self._held()
        new_edges = [(held_site, site) for held_site, _ in stack
                     if held_site != site]
        stack.append((site, ident))
        if not new_edges:
            return
        with self._graph_lock:
            for a, b in new_edges:
                if b in self._edges.get(a, ()):
                    continue
                cycle = self._find_path(b, a)
                self._edges.setdefault(a, set()).add(b)
                if cycle is not None:
                    self._violations.append(LockOrderViolation(
                        (a, b), cycle + [b],
                        threading.current_thread().name))

    def note_released(self, site: str, ident: int) -> None:
        stack = self._held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == (site, ident):
                del stack[i]
                return

    def _find_path(self, start: str, goal: str) -> Optional[List[str]]:
        """DFS b ~> a in the current edge set — the path that the new
        a->b edge would close into a cycle."""
        seen = set()
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self._edges.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    # -- test surface ------------------------------------------------------

    def violations(self) -> List[LockOrderViolation]:
        with self._graph_lock:
            return list(self._violations)

    def sites(self) -> Set[str]:
        """Every allocation site that made a checked lock since
        install: how much of the code the graph saw."""
        with self._graph_lock:
            return set(self._sites)

    def reset(self) -> None:
        with self._graph_lock:
            self._edges.clear()
            self._violations.clear()


class _CheckedLock:
    """Drop-in ``threading.Lock()`` replacement that reports to the
    sanitizer.  Exposes the full lock surface (acquire/release/locked/
    context manager) so Condition and Event internals built on top of
    a patched factory keep working."""

    __slots__ = ("_inner", "_site", "_sanitizer")

    def __init__(self, sanitizer: LockOrderSanitizer, site: str):
        self._inner = _real_lock()
        self._site = site
        self._sanitizer = sanitizer

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._sanitizer.note_acquired(self._site, id(self))
        return got

    def release(self) -> None:
        self._sanitizer.note_released(self._site, id(self))
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition() probes these on its lock; delegating keeps a
    # checked lock usable as Condition backing storage.
    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()


_active: Optional[LockOrderSanitizer] = None


def active() -> Optional[LockOrderSanitizer]:
    return _active


def install() -> LockOrderSanitizer:
    """Swap ``threading.Lock`` for the checked factory.  Returns the
    sanitizer; idempotent (a second install returns the live one)."""
    global _active
    if _active is not None:
        return _active
    sanitizer = LockOrderSanitizer()

    def make_lock():
        import sys

        frame = sys._getframe(1)
        site = f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:" \
               f"{frame.f_lineno}"
        sanitizer.note_created(site)
        return _CheckedLock(sanitizer, site)

    threading.Lock = make_lock
    _active = sanitizer
    return sanitizer


def uninstall() -> None:
    global _active
    threading.Lock = _real_lock
    _active = None
