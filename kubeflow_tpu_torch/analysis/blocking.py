"""blocking-under-lock: no blocking operation on a lock-held path.

The router/engine/scheduler stall class: a ``time.sleep`` (or a
policy-clock backoff, a socket read, a subprocess, a future wait, a
blocking queue get, an HTTP client round-trip) executed while a
``self.*lock*`` is held turns one slow request into a convoy — every
thread that touches the lock queues behind wall time.  The repo's
discipline (the fault injector sleeps OUTSIDE its lock; kube retries
back off outside the transport lock) exists precisely because this
bug is invisible to single-threaded tests.

Flow-sensitive over the CFG (analysis/cfg.py): the held-lock state is
a forward may-analysis — ``with self.<name>:`` where ``<name>``
contains "lock" acquires (module-level ``with _LOCK:`` too), the
with-exit releases on BOTH the normal and the exception edge,
``.acquire()``/``.release()`` calls adjust the set, and a method named
``*_locked`` starts with a synthetic caller-held token (the repo's
caller-holds-the-lock convention).  A blocking call at a node whose
in-state holds ANY lock — i.e. reached with the lock held on SOME
path — is a finding.

Blocking operations recognized:

  * ``time.sleep(...)`` and ``faults.policy_backoff(...)`` (the
    policy-clock-waited backoff helper);
  * ``subprocess.*`` calls;
  * socket I/O: ``.recv/.recv_into/.recvfrom/.send/.sendall/.accept``;
  * ``Future.result()`` waits (any ``.result(...)`` call);
  * blocking queue gets: ``.get(block=True)``, ``.get(True)``,
    ``.get(timeout=...)``, or a bare ``.get()`` on a receiver whose
    name contains "queue";
  * HTTP client round-trips: ``urlopen(...)``, ``.getresponse()``,
    and ``.request(...)`` on a ``conn``-named receiver.

``Condition.wait()`` is deliberately NOT listed: it releases its own
lock while waiting (the ``with self._cond: self._cond.wait()`` idiom
is correct).  Nested functions inherit the lock state of their
definition site — except generators, which run AFTER the defining
``with`` exited (their resume state must not merge into lock-held
state); a provably-safe site suppresses with
``# kft: allow=blocking-under-lock`` and a sentence saying why.
"""

from __future__ import annotations

from typing import FrozenSet, List, Optional, Tuple

import ast

from kubeflow_tpu_torch.analysis import cfg
from kubeflow_tpu_torch.analysis.core import Finding

CHECK = "blocking-under-lock"

_SOCKET_ATTRS = {"recv", "recv_into", "recvfrom", "send", "sendall",
                 "accept"}

_MAX_NESTING = 8


def _lock_names(with_stmt) -> List[str]:
    """The lock-ish context managers of one with statement (final
    name segment contains "lock", case-insensitive)."""
    names = []
    for item in with_stmt.items:
        name = cfg.dotted(item.context_expr)
        if name and "lock" in name.rsplit(".", 1)[-1].lower():
            names.append(name)
    return names


def _lockish_receiver(call: ast.Call) -> Optional[str]:
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    name = cfg.dotted(func.value)
    if name and "lock" in name.rsplit(".", 1)[-1].lower():
        return name
    return None


def _const(expr) -> object:
    return expr.value if isinstance(expr, ast.Constant) else None


def blocking_reason(call: ast.Call) -> Optional[str]:
    """Why this call blocks, or None.  Kept importable so the tests
    and future checkers share one list."""
    func = call.func
    name = cfg.dotted(func)
    attr = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else None)
    recv = (cfg.dotted(func.value)
            if isinstance(func, ast.Attribute) else None)
    if name == "time.sleep":
        return "time.sleep"
    if attr == "policy_backoff":
        return "faults.policy_backoff"
    if name and name.split(".", 1)[0] == "subprocess":
        return name
    if attr in _SOCKET_ATTRS:
        return f"socket {attr}"
    if attr == "urlopen":
        return "urlopen"
    if attr == "getresponse":
        return "getresponse"
    if attr == "request" and recv \
            and "conn" in recv.rsplit(".", 1)[-1].lower():
        return f"{recv}.request"
    if attr == "result":
        return "Future.result"
    if attr == "get":
        keywords = {k.arg: k.value for k in call.keywords if k.arg}
        if "block" in keywords and _const(keywords["block"]) is not False:
            return "queue get(block=True)"
        if call.args and _const(call.args[0]) is True:
            return "queue get(block=True)"
        if "timeout" in keywords:
            return "get(timeout=...)"
        if not call.args and not call.keywords and recv \
                and "queue" in recv.rsplit(".", 1)[-1].lower():
            return f"{recv}.get"
    return None


class BlockingUnderLock:
    name = CHECK

    def visit_module(self, rel: str, tree: ast.Module,
                     text: str) -> List[Finding]:
        findings: List[Finding] = []
        for qual, fn in cfg.top_level_functions(tree):
            self._analyze(rel, qual, fn, self._entry_locks(fn),
                          findings, depth=0)
        return findings

    def finish(self) -> List[Finding]:
        return []

    def _entry_locks(self, fn) -> FrozenSet[Tuple[str, str]]:
        if fn.name.endswith("_locked"):
            return frozenset({("lock", "<caller-held lock>")})
        return frozenset()

    def _analyze(self, rel: str, qual: str, fn,
                 entry: FrozenSet, findings: List[Finding],
                 depth: int) -> None:
        graph = cfg.build_cfg(fn)
        if graph is None:
            return

        def transfer(node, state):
            if node.kind == "with-acquire":
                return state | {("lock", n)
                                for n in _lock_names(node.stmt)}
            if node.kind == "with-exit":
                return state - {("lock", n)
                                for n in _lock_names(node.stmt)}
            gen, kill = set(), set()
            for call in cfg.node_calls(node):
                attr = (call.func.attr
                        if isinstance(call.func, ast.Attribute)
                        else None)
                recv = _lockish_receiver(call)
                if recv and attr == "acquire":
                    gen.add(("lock", recv))
                elif recv and attr == "release":
                    kill.add(("lock", recv))
            return (state - kill) | gen

        ins = cfg.fixpoint(graph, entry, transfer)
        seen = set()
        for node in graph.nodes:
            state = ins.get(node)
            if not state:
                continue
            locks = sorted(t[1] for t in state if t[0] == "lock")
            if not locks:
                continue
            for call in cfg.node_calls(node):
                reason = blocking_reason(call)
                if reason is None:
                    continue
                key = (call.lineno, call.col_offset, reason)
                if key in seen:  # finally/with duplication
                    continue
                seen.add(key)
                findings.append(Finding(
                    check=CHECK, path=rel, line=call.lineno,
                    col=call.col_offset,
                    message=(f"{reason} may block while holding "
                             f"{', '.join(locks)} in {qual}() — "
                             f"every thread touching the lock queues "
                             f"behind wall time; move the blocking "
                             f"call outside the locked region"),
                    symbol=f"{reason.replace(' ', '-')}@{qual}"))
        if depth >= _MAX_NESTING:
            return
        for node, child in cfg.nested_function_nodes(graph):
            at_def = ins.get(node, frozenset())
            inherited = frozenset(t for t in at_def
                                  if t[0] == "lock")
            if cfg.is_generator(child):
                # A generator body runs at iteration time, after the
                # defining with block exited — its resume state must
                # not inherit the definition site's held locks.
                inherited = frozenset()
            self._analyze(rel, f"{qual}.{child.name}", child,
                          inherited | self._entry_locks(child),
                          findings, depth + 1)
