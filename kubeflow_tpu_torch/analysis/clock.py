"""clock-discipline: policy modules read the skewable policy clock.

The fault harness (testing/faults.py) tests deadlines, backoffs, and
queue aging by SKEWING a policy clock — ``faults.monotonic()`` —
instead of sleeping through wall time.  That only works if policy code
actually reads it: a ``time.monotonic()`` smuggled into a drain loop
is invisible to every seeded clock-skew scenario, which is exactly how
drain and aging sites escape coverage.

Rule: inside the policy packages (serving, fleet, scheduler,
operator) and the tracing runtime (``runtime/tracing.py`` — its
tail-sampling threshold aging and open-trace expiry are policy
decisions), direct calls to ``time.monotonic()`` or ``time.time()``
are findings.  ``time.perf_counter()`` stays legal — measuring a
DURATION (step latency, span duration, scrape cost) is
instrumentation, not policy, and must not bend under an injected
skew.  Wall-clock timestamps that leave the process (CR status
stamps, event logs, the trace store's wall anchor) suppress with
``# kft: allow=clock-discipline`` and say why.
"""

from __future__ import annotations

from typing import List

import ast

from kubeflow_tpu_torch.analysis.core import Finding

CHECK = "clock-discipline"

POLICY_PREFIXES = ("kubeflow_tpu_torch/serving/", "kubeflow_tpu_torch/fleet/",
                   "kubeflow_tpu_torch/scheduler/", "kubeflow_tpu_torch/operator/",
                   # The trace store makes policy decisions too (tail-
                   # sampling threshold aging, open-trace expiry) —
                   # they must bend under seeded clock skew like every
                   # other deadline/backoff site.  Exact file, not a
                   # stem prefix: a future tracing_*.py sibling is not
                   # automatically a policy module.
                   "kubeflow_tpu_torch/runtime/tracing.py",
                   # The training supervisor's restart backoff, stall
                   # thresholds, and heartbeat ages are policy too —
                   # the skewed-clock stall/backoff tests only mean
                   # anything if every deadline here reads the policy
                   # clock.
                   "kubeflow_tpu_torch/runtime/supervisor.py")

_BANNED = {"monotonic", "time"}


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.stack: List[str] = []
        self.findings: List[Finding] = []

    def _qualname(self) -> str:
        return ".".join(self.stack) or "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_func(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "time"
                and func.attr in _BANNED):
            self.findings.append(Finding(
                check=CHECK, path=self.rel, line=node.lineno,
                col=node.col_offset,
                message=(f"policy module calls time.{func.attr}() "
                         f"directly; route through faults.monotonic() "
                         f"so clock-skew fault tests cover this site"),
                symbol=f"time.{func.attr}@{self._qualname()}"))
        self.generic_visit(node)


class ClockDiscipline:
    name = CHECK

    def visit_module(self, rel: str, tree: ast.Module,
                     text: str) -> List[Finding]:
        if not rel.startswith(POLICY_PREFIXES):
            return []
        v = _Visitor(rel)
        v.visit(tree)
        return v.findings

    def finish(self) -> List[Finding]:
        return []
