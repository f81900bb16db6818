"""fault-site-registry: code, faults.py docstring, and README agree.

The ``KFT_FAULTS`` grammar addresses hook sites by NAME — a scenario
string targeting a site that no production code fires silently does
nothing (the chaos run "passes" while testing nothing), and a site
planted in code but absent from the registry is undiscoverable (no
operator greps the source for ``faults.fire``).  Three places must
stay in lockstep:

  1. every literal ``faults.fire("<site>")`` in the port's code;
  2. the hook-site table in the port's ``testing/faults.py`` module
     docstring (the registry the grammar documents).  Its "Not ported
     yet" paragraph, which names the JAX package's other sites in
     prose, is not a table and is not read as one;
  3. the **Fault injection (port).** paragraph of ``README.md``'s port
     section (the operator-facing list; ``docs/user_guide.md`` §5.5
     documents the JAX package's sites and is that package's).

Cross-module by construction: sites are collected per module in
``visit_module`` and the symmetric difference is reported in
``finish()`` — a phantom site (in a registry, never fired) anchors at
the registry line; an unregistered site (fired, never documented)
anchors at the ``fire`` call.  Dynamic site names (a variable passed to
``fire``) are invisible here — keep site names literal, the port
already does.
"""

from __future__ import annotations

import pathlib
import re
from typing import Dict, List, Optional, Tuple

import ast

from kubeflow_tpu_torch.analysis.core import Finding

CHECK = "fault-site-registry"

FAULTS_MODULE = "kubeflow_tpu_torch/testing/faults.py"
DOCS_REL = "README.md"
DOCS_MARKER = "**Fault injection (port).**"

_SITE = r"[a-z][a-z0-9_]*(?:\.[a-z][a-z0-9_]*)+"
# Registry rows in the faults.py docstring: a site token at the list
# indent followed by whitespace and prose (grammar examples like
# ``engine.step:sleep=...`` have a ':' glued on and don't match).
_DOCSTRING_ROW = re.compile(rf"^\s{{4}}({_SITE})\s+\S", re.M)
_BACKTICKED = re.compile(rf"`({_SITE})`")


class FaultSiteRegistry:
    """finish()-driven cross-module checker: it compares what every
    module fires with the registry, so it reports only at the end."""

    name = CHECK

    def __init__(self, root: Optional[pathlib.Path] = None):
        self._root = root
        # site -> first (rel, line, col) fire() site seen
        self._fired: Dict[str, Tuple[str, int, int]] = {}
        # site -> docstring line in faults.py
        self._registry: Dict[str, int] = {}
        self._saw_faults_module = False

    def set_root(self, root: pathlib.Path) -> None:
        self._root = root

    def visit_module(self, rel: str, tree: ast.Module,
                     text: str) -> List[Finding]:
        if rel == FAULTS_MODULE:
            self._saw_faults_module = True
            self._collect_registry(text, tree)
            return []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            is_fire = (isinstance(func, ast.Attribute)
                       and func.attr == "fire") \
                or (isinstance(func, ast.Name) and func.id == "fire")
            if not is_fire:
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) \
                    and isinstance(first.value, str):
                self._fired.setdefault(
                    first.value, (rel, node.lineno, node.col_offset))
        return []

    def _collect_registry(self, text: str, tree: ast.Module) -> None:
        doc = ast.get_docstring(tree, clean=False) or ""
        # Line numbers: the docstring opens the module, so its first
        # line is line 1; scan the raw text for each row instead of
        # guessing offsets.
        lines = text.splitlines()
        for m in _DOCSTRING_ROW.finditer(doc):
            site = m.group(1)
            lineno = next(
                (i for i, line in enumerate(lines, 1)
                 if re.match(rf"^\s{{4}}{re.escape(site)}\s+\S", line)),
                1)
            self._registry.setdefault(site, lineno)

    def _docs_sites(self) -> Optional[Dict[str, int]]:
        """Sites named in README's port fault-injection paragraph, or
        None when the file is unavailable (in-memory analyses)."""
        if self._root is None:
            return None
        path = self._root / DOCS_REL
        if not path.is_file():
            return None
        text = path.read_text(encoding="utf-8")
        start = text.find(DOCS_MARKER)
        if start < 0:
            return None
        # The paragraph ends at the first code fence or next heading.
        end_candidates = [text.find(marker, start)
                          for marker in ("```", "\n### ", "\n## ")]
        end = min([e for e in end_candidates if e > 0] or [len(text)])
        para = text[start:end]
        base_line = text[:start].count("\n") + 1
        sites: Dict[str, int] = {}
        for m in _BACKTICKED.finditer(para):
            line = base_line + para[:m.start()].count("\n")
            sites.setdefault(m.group(1), line)
        return sites

    def finish(self) -> List[Finding]:
        if not self._saw_faults_module:
            # In-memory single-module analyses (analyze_source) have
            # no registry to compare against; stay silent rather than
            # reporting every fixture fire() as unregistered.
            return []
        findings: List[Finding] = []
        docs = self._docs_sites()
        for site, (rel, line, col) in sorted(self._fired.items()):
            if site not in self._registry:
                findings.append(Finding(
                    check=CHECK, path=rel, line=line, col=col,
                    message=(f"fault site {site!r} is fired here but "
                             f"missing from the testing/faults.py "
                             f"docstring registry — an undocumented "
                             f"KFT_FAULTS site is undiscoverable"),
                    symbol=f"unregistered:{site}"))
            if docs is not None and site not in docs:
                findings.append(Finding(
                    check=CHECK, path=rel, line=line, col=col,
                    message=(f"fault site {site!r} is fired here but "
                             f"absent from the {DOCS_REL} port fault-"
                             f"injection list — operators discover "
                             f"sites there"),
                    symbol=f"undocumented:{site}"))
        for site, line in sorted(self._registry.items()):
            if site not in self._fired:
                findings.append(Finding(
                    check=CHECK, path=FAULTS_MODULE, line=line, col=0,
                    message=(f"registry lists fault site {site!r} "
                             f"but no production code fires it — a "
                             f"KFT_FAULTS scenario naming it would "
                             f"silently test nothing"),
                    symbol=f"phantom:{site}"))
        if docs is not None:
            for site, line in sorted(docs.items()):
                if site not in self._fired:
                    findings.append(Finding(
                        check=CHECK, path=DOCS_REL, line=line, col=0,
                        message=(f"{DOCS_REL} port section documents "
                                 f"fault site {site!r} but no "
                                 f"production code fires it"),
                        symbol=f"phantom-doc:{site}"))
        return findings
