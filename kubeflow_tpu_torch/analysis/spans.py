"""span-discipline: live spans end on every path; hot loops stamp.

Three rules over the tracing layer (runtime/tracing.py), each a
defect class otherwise caught only by hand:

  * **liveness** — a live span bound by ``x = tracing.start_span(...)``
    (or a ``Span(...)`` ctor) must be ``end()``ed or ``close()``d on
    EVERY CFG path out of the function, exception edges included: a
    span leaked on an except path never completes its trace, the
    tail-sampler never takes the error verdict, and the one trace an
    incident needed ages out of the open buffer.  Flow-sensitive over
    analysis/cfg.py: a start gens a token, ``x.end()``/``x.close()``
    kills it, and ownership transfers kill too (``return x``, storing
    ``x`` into an attribute/container, ``.append(x)``/``.put(x)``/
    ``.add(x)``).  A token alive at the function's exit or raise-exit
    is a finding at the start line; re-binding ``x`` while its span is
    live is a finding at the re-bind.
  * **hot-loop stamping** — the hot-loop modules (``serving/engine.py``,
    ``models/generate.py``) must never create live span objects:
    drain-time ``record_span`` stamping from perf readings already
    taken is the only sanctioned form (the engine's disabled-tracer
    cost budget is one None check per site).
  * **unique names** — every literal span name passed to
    ``start_span``/``record_span`` is unique within its module: two
    sites sharing a name merge unrelated operations into one series
    in the store's per-root-name slow windows and make trace trees
    unreadable; record one logical span from one site (a helper, if
    two code paths stamp it).

Spans entered via ``with tracing.use_span(span):`` bind context, not
lifetime — the with block is neutral here.  Suppress a deliberate
hand-off the ownership heuristics can't see with
``# kft: allow=span-discipline`` and a sentence saying why.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import ast

from kubeflow_tpu_torch.analysis import cfg
from kubeflow_tpu_torch.analysis.core import Finding

CHECK = "span-discipline"

HOT_MODULES = {"kubeflow_tpu_torch/serving/engine.py",
               "kubeflow_tpu_torch/models/generate.py"}

_START_ATTRS = {"start_span", "Span"}
_END_ATTRS = {"end", "close"}
_SINK_ATTRS = {"append", "put", "add"}

_MAX_NESTING = 8


def _call_name(call: ast.Call) -> str:
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _is_span_start(expr) -> bool:
    return isinstance(expr, ast.Call) \
        and _call_name(expr) in _START_ATTRS


class SpanDiscipline:
    name = CHECK

    def visit_module(self, rel: str, tree: ast.Module,
                     text: str) -> List[Finding]:
        findings: List[Finding] = []
        self._check_names(rel, tree, findings)
        if rel in HOT_MODULES:
            self._check_hot_module(rel, tree, findings)
        for qual, fn in cfg.top_level_functions(tree):
            self._analyze(rel, qual, fn, findings, depth=0)
        return findings

    def finish(self) -> List[Finding]:
        return []

    # -- unique names ------------------------------------------------------

    def _check_names(self, rel: str, tree: ast.Module,
                     findings: List[Finding]) -> None:
        sites: Dict[str, List[ast.Call]] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if _call_name(node) not in ("start_span", "record_span"):
                continue
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                sites.setdefault(node.args[0].value, []).append(node)
        for name, calls in sorted(sites.items()):
            if len(calls) < 2:
                continue
            calls.sort(key=lambda c: (c.lineno, c.col_offset))
            for call in calls[1:]:
                findings.append(Finding(
                    check=CHECK, path=rel, line=call.lineno,
                    col=call.col_offset,
                    message=(f"span name {name!r} already used at "
                             f"line {calls[0].lineno} in this module "
                             f"— one logical span, one call site "
                             f"(extract a helper if two paths stamp "
                             f"it)"),
                    symbol=f"dup-name:{name}"))

    # -- hot-loop modules --------------------------------------------------

    def _check_hot_module(self, rel: str, tree: ast.Module,
                          findings: List[Finding]) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and _call_name(node) == "start_span":
                findings.append(Finding(
                    check=CHECK, path=rel, line=node.lineno,
                    col=node.col_offset,
                    message=("hot-loop module must not create live "
                             "spans — stamp completed spans at drain "
                             "time with record_span(start_perf, "
                             "end_perf) from readings already taken"),
                    symbol="hot-start-span"))

    # -- liveness ----------------------------------------------------------

    def _analyze(self, rel: str, qual: str, fn,
                 findings: List[Finding], depth: int) -> None:
        graph = cfg.build_cfg(fn)
        if graph is None:
            return

        def stmt_effects(stmt) -> Tuple[Set, Set, List]:
            """(gen, kill, rebind-findings-sites) for one leaf stmt."""
            gen: Set = set()
            kill: Set = set()
            rebinds: List[Tuple[str, int]] = []
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = stmt.targets[0]
                if isinstance(target, ast.Name):
                    rebinds.append((target.id, stmt.lineno))
                    kill.add(("var", target.id))
                    if _is_span_start(stmt.value):
                        gen.add(("span", target.id, stmt.lineno))
                else:
                    # Escape: span stored into an attribute, a
                    # subscript, or unpacked — ownership left this
                    # frame.
                    if isinstance(stmt.value, ast.Name):
                        kill.add(("var", stmt.value.id))
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                for sub in ast.walk(stmt.value):
                    if isinstance(sub, ast.Name):
                        kill.add(("var", sub.id))
            for call in ast.walk(stmt):
                if not isinstance(call, ast.Call):
                    continue
                func = call.func
                if isinstance(func, ast.Attribute) \
                        and isinstance(func.value, ast.Name):
                    if func.attr in _END_ATTRS:
                        kill.add(("var", func.value.id))
                    if func.attr in _SINK_ATTRS:
                        for arg in call.args:
                            if isinstance(arg, ast.Name):
                                kill.add(("var", arg.id))
            return gen, kill, rebinds

        rebind_hits: Set[Tuple[str, int, int]] = set()

        def transfer(node, state):
            if node.kind != "stmt":
                return state
            gen, kill, rebinds = stmt_effects(node.stmt)
            for var, line in rebinds:
                for token in state:
                    # A live token reaching its own start line again
                    # means a loop back-edge re-binds it — the
                    # previous iteration's span is orphaned.
                    if token[1] == var:
                        rebind_hits.add((var, token[2], line))
            state = frozenset(
                t for t in state if ("var", t[1]) not in kill)
            return state | gen

        ins = cfg.fixpoint(graph, frozenset(), transfer)
        leaked: Set[Tuple[str, int]] = set()
        for exit_node in (graph.exit, graph.raise_exit):
            for token in ins.get(exit_node, frozenset()):
                leaked.add((token[1], token[2]))
        for var, line in sorted(leaked, key=lambda t: (t[1], t[0])):
            findings.append(Finding(
                check=CHECK, path=rel, line=line, col=0,
                message=(f"span {var!r} started here is not ended on "
                         f"every path out of {qual}() (exception "
                         f"edges included) — the trace never "
                         f"completes and tail sampling never takes "
                         f"its verdict; end it in a finally or on "
                         f"the except path"),
                symbol=f"leak:{var}@{qual}"))
        for var, start_line, line in sorted(rebind_hits,
                                            key=lambda t: t[2]):
            findings.append(Finding(
                check=CHECK, path=rel, line=line, col=0,
                message=(f"span {var!r} started at line {start_line} "
                         f"is re-bound here while still live in "
                         f"{qual}() — the prior span can no longer "
                         f"be ended"),
                symbol=f"rebind:{var}@{qual}"))
        if depth >= _MAX_NESTING:
            return
        for _node, child in cfg.nested_function_nodes(graph):
            self._analyze(rel, f"{qual}.{child.name}", child,
                          findings, depth + 1)
