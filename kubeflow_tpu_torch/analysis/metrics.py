"""metric-hygiene: Prometheus naming + label-set consistency.

The registry (runtime/prom.py) is append-only by design: a name
registered once keeps its first help string, and a label key-set
mismatch between two call sites silently splits one logical series
into disjoint families — dashboards sum over labels and read HALF the
traffic (the round-3 near-miss: kft_serving_shed_total incremented
with batcher= in one file and model= in another would never alarm).

Rules, applied to every literal metric name the walker can resolve
(string literal or a module-level UPPER_CASE constant, including ones
imported from a sibling module — constants are resolved repo-wide in
finish()):

  * names match ``kft_[a-z0-9_]+`` — one namespace, greppable;
  * counters end ``_total`` (the exposition-format convention) and
    nothing else does — a gauge named ``_total`` reads as a counter
    to every recording rule;
  * all call sites of one metric name use ONE label key-set
    (``inc(model=...)`` vs ``inc()`` aggregate-plus-labeled is the one
    sanctioned split; two different NON-EMPTY key-sets are a finding).

Sites that interpolate names at runtime are invisible to this checker
— keep metric names literal (the repo already does).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import ast

from kubeflow_tpu_torch.analysis.core import Finding

CHECK = "metric-hygiene"

_REG_METHODS = {"counter", "gauge", "histogram"}
_USE_METHODS = {"inc", "set", "observe", "declare"}

_AMBIGUOUS = object()


class MetricHygiene:
    name = CHECK

    def __init__(self):
        # name constants seen anywhere: identifier -> value|_AMBIGUOUS
        self._consts: Dict[str, object] = {}
        # (rel, line, col, kind, ("str"|"ref", value))
        self._registrations: List[Tuple] = []
        # (rel, line, col, ("str"|"ref", value), labelkeys)
        self._usages: List[Tuple] = []

    # -- per-module collection ---------------------------------------------

    def visit_module(self, rel: str, tree: ast.Module,
                     text: str) -> List[Finding]:
        bindings: Dict[str, Tuple] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                self._note_const(node)
                self._note_binding(node, bindings)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            reg = self._as_registration(node)
            if reg is not None:
                kind, name_ref = reg
                self._registrations.append(
                    (rel, node.lineno, node.col_offset, kind, name_ref))
                continue
            self._note_usage(rel, node, bindings)
        return []

    def _note_const(self, node: ast.Assign) -> None:
        if (len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            name = node.targets[0].id
            prev = self._consts.get(name)
            if prev is None:
                self._consts[name] = node.value.value
            elif prev != node.value.value:
                self._consts[name] = _AMBIGUOUS

    def _as_registration(self, node: ast.Call
                         ) -> Optional[Tuple[str, Tuple]]:
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _REG_METHODS and node.args):
            return None
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value,
                                                          str):
            return func.attr, ("str", first.value)
        if isinstance(first, ast.Name):
            return func.attr, ("ref", first.id)
        return None

    def _unwrap_receiver(self, expr: ast.expr) -> Optional[Tuple]:
        """Metric name-ref for a usage receiver: a chained registration
        call (possibly through .declare)."""
        if isinstance(expr, ast.Call):
            reg = self._as_registration(expr)
            if reg is not None:
                return reg[1]
            if (isinstance(expr.func, ast.Attribute)
                    and expr.func.attr == "declare"):
                return self._unwrap_receiver(expr.func.value)
        return None

    def _note_binding(self, node: ast.Assign,
                      bindings: Dict[str, Tuple]) -> None:
        name_ref = self._unwrap_receiver(node.value)
        if name_ref is None:
            return
        for target in node.targets:
            if isinstance(target, ast.Name):
                bindings[f"n:{target.id}"] = name_ref
            elif (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                bindings[f"a:{target.attr}"] = name_ref

    def _note_usage(self, rel: str, node: ast.Call,
                    bindings: Dict[str, Tuple]) -> None:
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _USE_METHODS):
            return
        base = func.value
        name_ref = self._unwrap_receiver(base)
        if name_ref is None:
            if isinstance(base, ast.Name):
                name_ref = bindings.get(f"n:{base.id}")
            elif (isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"):
                name_ref = bindings.get(f"a:{base.attr}")
        if name_ref is None:
            return
        if any(kw.arg is None for kw in node.keywords):
            return  # **labels — key-set unknowable statically
        keys = tuple(sorted(kw.arg for kw in node.keywords))
        self._usages.append(
            (rel, node.lineno, node.col_offset, name_ref, keys))

    # -- cross-module verdicts ---------------------------------------------

    def _resolve(self, name_ref: Tuple) -> Optional[str]:
        kind, value = name_ref
        if kind == "str":
            return value
        resolved = self._consts.get(value)
        return resolved if isinstance(resolved, str) else None

    def finish(self) -> List[Finding]:
        findings: List[Finding] = []
        for rel, line, col, kind, name_ref in self._registrations:
            name = self._resolve(name_ref)
            if name is None:
                continue
            if not name.startswith("kft_") or not all(
                    c.islower() or c.isdigit() or c == "_"
                    for c in name):
                findings.append(Finding(
                    check=CHECK, path=rel, line=line, col=col,
                    message=(f"metric name {name!r} must match "
                             f"kft_[a-z0-9_]+ — one greppable "
                             f"namespace"),
                    symbol=f"name:{name}"))
            if kind == "counter" and not name.endswith("_total"):
                findings.append(Finding(
                    check=CHECK, path=rel, line=line, col=col,
                    message=(f"counter {name!r} must end _total "
                             f"(exposition-format convention)"),
                    symbol=f"counter-suffix:{name}"))
            if kind != "counter" and name.endswith("_total"):
                findings.append(Finding(
                    check=CHECK, path=rel, line=line, col=col,
                    message=(f"{kind} {name!r} must NOT end _total — "
                             f"recording rules would read it as a "
                             f"counter"),
                    symbol=f"{kind}-suffix:{name}"))
        by_name: Dict[str, Dict[Tuple, List[Tuple]]] = {}
        for rel, line, col, name_ref, keys in self._usages:
            name = self._resolve(name_ref)
            if name is None or not keys:
                continue  # empty set = sanctioned aggregate series
            by_name.setdefault(name, {}).setdefault(keys, []).append(
                (rel, line, col))
        for name, by_keys in sorted(by_name.items()):
            if len(by_keys) < 2:
                continue
            ranked = sorted(by_keys.items(),
                            key=lambda kv: (-len(kv[1]), kv[0]))
            canonical = ranked[0][0]
            for keys, sites in ranked[1:]:
                rel, line, col = sorted(sites)[0]
                findings.append(Finding(
                    check=CHECK, path=rel, line=line, col=col,
                    message=(f"metric {name!r} used with label keys "
                             f"{list(keys)} here but {list(canonical)} "
                             f"at {len(ranked[0][1])} other site(s) — "
                             f"one name, one label set"),
                    symbol=f"labels:{name}:{','.join(keys)}"))
        return findings
