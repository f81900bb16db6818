"""lock-guard: flow-insensitive guarded-by discipline per class.

The cycle-profile bug class: a stats()/status() snapshot reads a
set of fields under ``self._lock`` while some OTHER method mutates one
of them bare — a classic lost update that no single-threaded test can
catch.  The repo's discipline is guarded-by-construction: once any
method of a class writes an attribute inside ``with self.<lock>:``,
that attribute is *guarded* and every other write in the class must
hold the lock too.

Mechanics (deliberately flow-insensitive — one AST walk per class):

  * a *lock context* is the body of a ``with self.<name>:`` statement
    where ``<name>`` contains "lock" (``_lock``, ``_state_lock``, ...),
    or the whole body of a method whose name ends in ``_locked`` —
    the repo's caller-holds-the-lock naming convention
    (``_take_batch_locked``, ``_prune_locked``, ...);
  * a write is an assignment/augmented assignment to ``self.<attr>``
    (container mutation through method calls is out of scope);
  * ``__init__``/``__new__``/``__post_init__`` writes are construction
    before publication and never count, in either direction (dataclass
    classes construct in ``__post_init__``).

False positives (a write provably single-threaded at that point, e.g.
after every worker joined) suppress with ``# kft: allow=lock-guard``
and a comment saying why the lock is not needed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import ast

from kubeflow_tpu_torch.analysis.core import Finding

CHECK = "lock-guard"

_CTOR = {"__init__", "__new__", "__post_init__"}


def _is_self_lock(expr: ast.expr) -> bool:
    return (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and "lock" in expr.attr.lower())


def _self_attr_writes(node: ast.stmt) -> List[Tuple[str, ast.expr]]:
    """self.<attr> targets rebound by this single statement."""
    targets: List[ast.expr] = []
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    out = []
    for t in targets:
        for leaf in ast.walk(t):
            if (isinstance(leaf, ast.Attribute)
                    and isinstance(leaf.value, ast.Name)
                    and leaf.value.id == "self"):
                out.append((leaf.attr, leaf))
    return out


class _MethodWalk:
    """Collect (attr, node, under_lock) writes for one method."""

    def __init__(self, whole_body_locked: bool):
        self.writes: List[Tuple[str, ast.expr, bool]] = []
        self._base_locked = whole_body_locked

    def walk(self, body: List[ast.stmt], locked: bool = None) -> None:
        locked = self._base_locked if locked is None else locked
        for stmt in body:
            for attr, node in _self_attr_writes(stmt):
                self.writes.append((attr, node, locked))
            if isinstance(stmt, ast.With):
                inner = locked or any(
                    _is_self_lock(item.context_expr)
                    for item in stmt.items)
                self.walk(stmt.body, inner)
                continue
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                # Nested helpers inherit the lexical lock state of
                # their definition site — the repo's inline-closure
                # idiom (note_wake in _take_batch_locked).  A closure
                # defined under a lock but EXECUTED later on another
                # thread would be mis-blessed; none exist here, and
                # the runtime sanitizer (testing/lockcheck.py) covers
                # that dynamic gap.
                self.walk(stmt.body, locked)
                continue
            for child_body in (getattr(stmt, "body", None),
                               getattr(stmt, "orelse", None),
                               getattr(stmt, "finalbody", None)):
                if isinstance(child_body, list):
                    self.walk(child_body, locked)
            for handler in getattr(stmt, "handlers", []):
                self.walk(handler.body, locked)


class LockGuard:
    name = CHECK

    def visit_module(self, rel: str, tree: ast.Module,
                     text: str) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(rel, node))
        return findings

    def _check_class(self, rel: str,
                     cls: ast.ClassDef) -> List[Finding]:
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        guarded: Dict[str, str] = {}      # attr -> first guarding method
        unlocked: List[Tuple[str, ast.expr, str]] = []
        for m in methods:
            if m.name in _CTOR:
                continue
            walk = _MethodWalk(m.name.endswith("_locked"))
            walk.walk(m.body)
            for attr, site, locked in walk.writes:
                if locked:
                    guarded.setdefault(attr, m.name)
                else:
                    unlocked.append((attr, site, m.name))
        out = []
        for attr, site, method in unlocked:
            if attr not in guarded:
                continue
            out.append(Finding(
                check=CHECK, path=rel, line=site.lineno,
                col=site.col_offset,
                message=(f"{cls.name}.{attr} is written under the lock "
                         f"in {guarded[attr]}() but written bare here "
                         f"in {method}() — lost-update hazard"),
                symbol=f"{cls.name}.{attr}@{method}"))
        return out

    def finish(self) -> List[Finding]:
        return []
