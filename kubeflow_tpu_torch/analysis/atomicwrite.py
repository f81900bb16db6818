"""atomic-write: durable state commits tmp + fsync + rename, always.

The kill-mid-save invariant: a checkpoint manifest, an operator
status artifact — anything a restart reads to decide what survived —
must either exist COMPLETE or not at all.  The only pattern that
guarantees it on POSIX is: write a ``*.tmp`` sibling, ``fsync`` the
file handle, ``os.replace``/``os.rename`` onto the final path (and
fsync the directory for good measure).  A bare ``open(path, "w")`` of
a final path can be killed mid-write and leave a half-file that
PARSES; a rename without the fsync can land an empty file after a
power cut (the rename is durable before the data is).

Flow-sensitive over analysis/cfg.py, scoped to the durable-state
modules (``runtime/checkpoint.py`` and ``operator/*`` — the writers
whose output a recovery path trusts):

  * every ``open(path, mode)`` with a writing mode gens two tokens:
    *unrenamed* (this path has not reached its destination) and
    *unsynced* (its handle has not been fsynced);
  * ``os.fsync(f.fileno())`` (or ``os.fsync(f)``) kills *unsynced*
    for the handle's path; ``os.rename(src, dst)``/``os.replace`` —
    and the ``src.rename(dst)``/``.replace`` Path methods — kill
    *unrenamed* for ``src``;
  * a rename whose in-state still holds *unsynced* for the source is
    a finding ("renamed without fsync on some path");
  * an *unrenamed* token alive at the function's NORMAL exit is a
    finding at the open site — the write never committed onto a
    destination.  (The raise-exit is deliberately exempt: an
    exception abandoning a ``.tmp`` file IS the protocol — the
    missing rename is exactly what makes the dead save detectable.)
  * ``Path.write_text``/``write_bytes`` in a durable module is an
    immediate finding — there is no handle to fsync and no tmp
    sibling to rename.

A deliberate non-durable write (a scratch file, a log) suppresses
with ``# kft: allow=atomic-write`` and a sentence saying why.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import ast

from kubeflow_tpu_torch.analysis import cfg
from kubeflow_tpu_torch.analysis.core import Finding

CHECK = "atomic-write"

DURABLE_PREFIXES = ("kubeflow_tpu_torch/runtime/checkpoint.py",
                    "kubeflow_tpu_torch/operator/")

_MAX_NESTING = 8


def _path_key(expr) -> str:
    name = cfg.dotted(expr)
    if name is not None:
        return name
    return f"<expr@{getattr(expr, 'lineno', 0)}>"


def _write_mode(call: ast.Call) -> bool:
    """True when this ``open(...)`` call writes (w/a/x/+ in mode)."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return False  # default "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return any(c in mode.value for c in "wax+")
    return True  # dynamic mode: assume the worst


def _open_call(call: ast.Call) -> bool:
    return isinstance(call.func, ast.Name) and call.func.id == "open"


class AtomicWrite:
    name = CHECK

    def visit_module(self, rel: str, tree: ast.Module,
                     text: str) -> List[Finding]:
        if not rel.startswith(DURABLE_PREFIXES):
            return []
        findings: List[Finding] = []
        for qual, fn in cfg.top_level_functions(tree):
            self._analyze(rel, qual, fn, findings, depth=0)
        return findings

    def finish(self) -> List[Finding]:
        return []

    def _analyze(self, rel: str, qual: str, fn,
                 findings: List[Finding], depth: int) -> None:
        graph = cfg.build_cfg(fn)
        if graph is None:
            return

        # Syntactic pre-pass: file-handle variable -> opened path key
        # (`with open(p, "w") as f:` and `f = open(p, "w")`), so the
        # later `os.fsync(f.fileno())` resolves to the path's token.
        handle_path: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    call = item.context_expr
                    if isinstance(call, ast.Call) and _open_call(call) \
                            and _write_mode(call) and call.args \
                            and isinstance(item.optional_vars,
                                           ast.Name):
                        handle_path[item.optional_vars.id] = \
                            _path_key(call.args[0])
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and _open_call(node.value) \
                    and _write_mode(node.value) and node.value.args:
                handle_path[node.targets[0].id] = \
                    _path_key(node.value.args[0])

        def fsync_target(call: ast.Call) -> Optional[str]:
            if cfg.dotted(call.func) != "os.fsync" or not call.args:
                return None
            arg = call.args[0]
            if isinstance(arg, ast.Call) \
                    and isinstance(arg.func, ast.Attribute) \
                    and arg.func.attr == "fileno" \
                    and isinstance(arg.func.value, ast.Name):
                return handle_path.get(arg.func.value.id)
            if isinstance(arg, ast.Name):
                return handle_path.get(arg.id)
            return None

        def rename_src(call: ast.Call) -> Optional[str]:
            name = cfg.dotted(call.func)
            if name in ("os.rename", "os.replace") and call.args:
                return _path_key(call.args[0])
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr in ("rename", "replace") \
                    and call.args:
                recv = cfg.dotted(call.func.value)
                if recv is not None and recv != "os":
                    return recv
            return None

        def transfer(node, state):
            gen, kill = set(), set()
            for call in cfg.node_calls(node):
                if _open_call(call) and _write_mode(call) \
                        and call.args:
                    key = _path_key(call.args[0])
                    gen.add(("unrenamed", key, call.lineno))
                    gen.add(("unsynced", key))
                target = fsync_target(call)
                if target is not None:
                    kill.add(("unsynced", target))
                src = rename_src(call)
                if src is not None:
                    kill.update(t for t in state
                                if t[0] == "unrenamed" and t[1] == src)
                    kill.add(("unsynced", src))
            return (state - kill) | gen

        ins = cfg.fixpoint(graph, frozenset(), transfer)

        seen = set()
        for node in graph.nodes:
            state = ins.get(node, frozenset())
            for call in cfg.node_calls(node):
                src = rename_src(call)
                if src is not None and ("unsynced", src) in state \
                        and (call.lineno, src) not in seen:
                    seen.add((call.lineno, src))
                    findings.append(Finding(
                        check=CHECK, path=rel, line=call.lineno,
                        col=call.col_offset,
                        message=(f"{src} is renamed onto its "
                                 f"destination without an fsync of "
                                 f"the written handle on some path "
                                 f"in {qual}() — after a power cut "
                                 f"the rename can be durable before "
                                 f"the data is"),
                        symbol=f"rename-no-fsync:{src}@{qual}"))
                if isinstance(call.func, ast.Attribute) \
                        and call.func.attr in ("write_text",
                                               "write_bytes"):
                    key = (call.lineno, "write_text")
                    if key not in seen:
                        seen.add(key)
                        findings.append(Finding(
                            check=CHECK, path=rel, line=call.lineno,
                            col=call.col_offset,
                            message=("durable-state module writes "
                                     "with Path.write_text/"
                                     "write_bytes — no handle to "
                                     "fsync, no tmp sibling to "
                                     "rename; use the tmp + fsync + "
                                     "os.replace protocol"),
                            symbol=f"bare-write-text@{qual}"))
        leaked = set()
        for token in ins.get(graph.exit, frozenset()):
            if token[0] == "unrenamed":
                leaked.add((token[1], token[2]))
        for key, line in sorted(leaked, key=lambda t: t[1]):
            findings.append(Finding(
                check=CHECK, path=rel, line=line, col=0,
                message=(f"{key} is opened for writing in {qual}() "
                         f"but never os.replace/renamed onto its "
                         f"destination on some normal path — a kill "
                         f"mid-write leaves a half-file that parses; "
                         f"write a .tmp sibling, fsync, then rename"),
                symbol=f"bare-write:{key}@{qual}"))
        if depth >= _MAX_NESTING:
            return
        for _node, child in cfg.nested_function_nodes(graph):
            self._analyze(rel, f"{qual}.{child.name}", child,
                          findings, depth + 1)
