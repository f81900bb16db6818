"""capture-purity: no host side effects inside captured program bodies.

The port's form of the JAX analyzer's ``jit-purity``.  That checker
guards functions handed to ``jax.jit``: a ``time.time()`` or
``random.random()`` there runs at TRACE time and is frozen into the
compiled program.  The port has no tracer; its compiled programs are
the decode engine's slot programs (``serving/programs.py``), whose
``_body()`` methods run eagerly on the CPU and are recorded as CUDA
graphs on the card.  A capture records device work only, so a host
effect in a body runs once, at capture, and never again on replay:
the eager and the replayed program would then differ, which breaks the
guarantee that one captured program equals its eager run.

Detection (lexical, same-module): in a capture module, every method
named ``_body`` and every function nested in one is a captured body;
inside it, any call whose receiver chain roots at a host-effect module
(time, random, threading, os, socket, subprocess, datetime) or names an
effectful builtin (open, print, input, breakpoint) is a finding.
``torch.*`` and ``np.*`` root elsewhere and stay legal (the bodies'
device RNG is a torch generator).  The walk is not transitive through
helper calls: the bodies call ``models/generate.py``'s slot programs,
which keep no host state; keep it that way.
"""

from __future__ import annotations

from typing import List

import ast

from kubeflow_tpu_torch.analysis.core import Finding

CHECK = "capture-purity"

CAPTURE_MODULES = {"kubeflow_tpu_torch/serving/programs.py"}
BODY_NAME = "_body"

HOST_MODULES = {"time", "random", "threading", "os", "socket",
                "subprocess", "datetime"}
HOST_BUILTINS = {"open", "print", "input", "breakpoint"}


def _root_name(expr: ast.expr):
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.stack: List[str] = []
        self.in_body = 0
        self.findings: List[Finding] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_func(self, node) -> None:
        entered = node.name == BODY_NAME
        self.stack.append(node.name)
        self.in_body += entered
        self.generic_visit(node)
        self.in_body -= entered
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Call(self, node: ast.Call) -> None:
        if self.in_body:
            func = node.func
            root = _root_name(func)
            bad = None
            if isinstance(func, ast.Attribute) and root in HOST_MODULES:
                bad = ast.unparse(func)
            elif isinstance(func, ast.Name) and func.id in HOST_BUILTINS:
                bad = func.id
            if bad is not None:
                self.findings.append(Finding(
                    check=CHECK, path=self.rel, line=node.lineno,
                    col=node.col_offset,
                    message=(f"captured body calls host-effect {bad}(): "
                             f"it runs once at CUDA-graph capture and "
                             f"never on replay, so the replayed program "
                             f"differs from its eager run"),
                    symbol=f"{bad}@{'.'.join(self.stack)}"))
        self.generic_visit(node)


class CapturePurity:
    name = CHECK

    def __init__(self, modules=None):
        self._modules = set(CAPTURE_MODULES if modules is None
                            else modules)

    def visit_module(self, rel: str, tree: ast.Module,
                     text: str) -> List[Finding]:
        if rel not in self._modules:
            return []
        v = _Visitor(rel)
        v.visit(tree)
        return v.findings

    def finish(self) -> List[Finding]:
        return []
