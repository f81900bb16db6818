"""Checker framework: findings, suppressions, baseline, runner.

The moving parts, in the order a run uses them:

  * every checker is a class with ``visit_module(rel, tree, text)``
    (called once per file) and ``finish()`` (called once per run, for
    cross-module checks like label-set consistency) — both return
    Finding lists;
  * a ``# kft: allow=<check>[,<check>...]`` comment suppresses a
    finding on its own line; a standalone comment line carrying the
    directive suppresses the next code line (for findings on lines
    with no column budget left);
  * the baseline file (``kubeflow_tpu_torch/analysis/baseline.json``)
    is SHRINK-ONLY:
    a finding whose fingerprint is listed is tolerated, but a listed
    fingerprint that no longer fires is an error ("stale baseline
    entry — delete it"), so the file can never quietly grow and can
    only march toward empty.  An entry is removed by hand when its
    finding is fixed.

Fingerprints deliberately omit line numbers — ``check::path::symbol``
where ``symbol`` names the construct (qualified function, attribute,
metric name), so unrelated edits above a grandfathered finding don't
churn the baseline.  When one (check, path, symbol) fires more than
once, each instance is disambiguated by a short content hash of its
own source line (``#a1b2c3d4``) instead of an ordinal — fixing the
first of three findings must not renumber the other two and
invalidate their baseline entries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import re
from typing import (Callable, Dict, Iterator, List, Optional, Set,
                    Tuple)

import ast

SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "artifacts",
             "node_modules", ".claude"}

_ALLOW_RE = re.compile(r"#\s*kft:\s*allow=([A-Za-z0-9_,-]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site.

    ``symbol`` is the stable identity used for baselining (qualified
    name of the enclosing construct plus a disambiguator), never the
    line number."""

    check: str
    path: str
    line: int
    col: int
    message: str
    symbol: str

    def fingerprint(self) -> str:
        return f"{self.check}::{self.path}::{self.symbol}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.check}: "
                f"{self.message}")

    def to_json(self) -> Dict[str, object]:
        return {"check": self.check, "path": self.path,
                "line": self.line, "col": self.col,
                "message": self.message,
                "fingerprint": self.fingerprint()}


def _line_hash(line: str) -> str:
    return hashlib.blake2b(line.strip().encode("utf-8"),
                           digest_size=4).hexdigest()


def dedupe_symbols(findings: List[Finding],
                   line_of: Optional[Callable[[Finding], str]] = None
                   ) -> List[Finding]:
    """Disambiguate repeated (check, path, symbol) triples so every
    fingerprint in a run is unique (two bare ``time.time()`` calls in
    one function must not collapse into one baseline entry).

    The disambiguator is a STABLE content hash of each finding's own
    source line (``#<8 hex>``), not an ordinal: fixing finding #1 of a
    group leaves every other member's fingerprint unchanged, so
    unrelated baseline entries survive the fix.  Identical source
    lines inside one group (the only case a content hash can't split)
    fall back to an ordinal *within that content* (``#<hash>.2``).
    Singleton groups keep the bare symbol.  Without ``line_of``
    (legacy callers) the old pure-ordinal ``#n`` scheme applies."""
    by_fp: Dict[str, int] = {}
    for f in findings:
        by_fp[f.fingerprint()] = by_fp.get(f.fingerprint(), 0) + 1
    out: List[Finding] = []
    ordinal: Dict[str, int] = {}
    content_seen: Dict[Tuple[str, str], int] = {}
    for f in findings:
        fp = f.fingerprint()
        if by_fp[fp] < 2:
            out.append(f)
            continue
        n = ordinal.get(fp, 0)
        ordinal[fp] = n + 1
        if line_of is None:
            if n:
                f = dataclasses.replace(f, symbol=f"{f.symbol}#{n + 1}")
            out.append(f)
            continue
        suffix = _line_hash(line_of(f))
        dup = content_seen.get((fp, suffix), 0)
        content_seen[(fp, suffix)] = dup + 1
        if dup:
            suffix = f"{suffix}.{dup + 1}"
        out.append(dataclasses.replace(
            f, symbol=f"{f.symbol}#{suffix}"))
    return out


def suppressions(text: str) -> Dict[int, Set[str]]:
    """Map line number -> suppressed check names.

    A directive on a code line covers that line; a directive on a
    COMMENT-ONLY line covers that line and the next non-blank,
    non-comment line below it."""
    out: Dict[int, Set[str]] = {}
    pending: Set[str] = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        m = _ALLOW_RE.search(line)
        checks = ({c.strip() for c in m.group(1).split(",") if c.strip()}
                  if m else set())
        if checks:
            out.setdefault(lineno, set()).update(checks)
        if stripped.startswith("#"):
            pending |= checks
            continue
        if stripped and pending:
            out.setdefault(lineno, set()).update(pending)
            pending = set()
    return out


def expand_decorator_suppressions(tree: ast.Module,
                                  supp: Dict[int, Set[str]]
                                  ) -> Dict[int, Set[str]]:
    """Resolve suppressions against decorator-inclusive def spans.

    A directive on the comment line above ``@decorator`` lands on the
    decorator's line (the next code line) — but findings that anchor
    to the ``def`` itself (``node.lineno`` of a FunctionDef excludes
    its decorators) would miss it.  Any suppression attached to a line
    in ``[first decorator, def]`` also covers the def line."""
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            continue
        if not node.decorator_list:
            continue
        first = min(d.lineno for d in node.decorator_list)
        gathered: Set[str] = set()
        for line in range(first, node.lineno + 1):
            gathered |= supp.get(line, set())
        if gathered:
            supp.setdefault(node.lineno, set()).update(gathered)
    return supp


def apply_suppressions(findings: List[Finding],
                       per_file: Dict[str, Dict[int, Set[str]]]
                       ) -> Tuple[List[Finding], int]:
    kept: List[Finding] = []
    suppressed = 0
    for f in findings:
        allowed = per_file.get(f.path, {}).get(f.line, set())
        if f.check in allowed or "all" in allowed:
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed


# -- baseline ---------------------------------------------------------------

def load_baseline(path: pathlib.Path) -> List[str]:
    if not path.exists():
        return []
    data = json.loads(path.read_text(encoding="utf-8"))
    entries = data.get("findings", data if isinstance(data, list) else [])
    if not isinstance(entries, list) or not all(
            isinstance(e, str) for e in entries):
        raise ValueError(f"baseline {path}: want a list of fingerprint "
                         f"strings under 'findings'")
    return list(entries)


def split_by_baseline(findings: List[Finding], baseline: List[str]
                      ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """-> (new findings, baselined findings, stale baseline entries)."""
    known = set(baseline)
    new = [f for f in findings if f.fingerprint() not in known]
    old = [f for f in findings if f.fingerprint() in known]
    fired = {f.fingerprint() for f in findings}
    stale = sorted(known - fired)
    return new, old, stale


# -- runner -----------------------------------------------------------------

def py_files(root: pathlib.Path) -> Iterator[pathlib.Path]:
    """The analyzed set: the kubeflow_tpu_torch package (tests poke at
    internals on purpose; the invariants bind production code)."""
    pkg = root / "kubeflow_tpu_torch"
    base = pkg if pkg.is_dir() else root
    for path in sorted(base.rglob("*.py")):
        parts = path.relative_to(root).parts
        if SKIP_DIRS.intersection(parts):
            continue
        if any(p.startswith(".") for p in parts[:-1]):
            continue
        yield path


def default_checkers() -> List[object]:
    from kubeflow_tpu_torch.analysis.atomicwrite import AtomicWrite
    from kubeflow_tpu_torch.analysis.blocking import BlockingUnderLock
    from kubeflow_tpu_torch.analysis.capture import CapturePurity
    from kubeflow_tpu_torch.analysis.clock import ClockDiscipline
    from kubeflow_tpu_torch.analysis.faultsites import FaultSiteRegistry
    from kubeflow_tpu_torch.analysis.locks import LockGuard
    from kubeflow_tpu_torch.analysis.metrics import MetricHygiene
    from kubeflow_tpu_torch.analysis.spans import SpanDiscipline

    return [ClockDiscipline(), LockGuard(), CapturePurity(),
            MetricHygiene(), BlockingUnderLock(), SpanDiscipline(),
            AtomicWrite(), FaultSiteRegistry()]


@dataclasses.dataclass
class Report:
    findings: List[Finding]            # unsuppressed, not in baseline
    baselined: List[Finding]
    stale: List[str]
    suppressed: int
    files: int

    @property
    def ok(self) -> bool:
        return not self.findings and not self.stale


def _line_lookup(texts: Dict[str, List[str]]
                 ) -> Callable[[Finding], str]:
    def line_of(f: Finding) -> str:
        lines = texts.get(f.path, ())
        return lines[f.line - 1] if 0 < f.line <= len(lines) else ""

    return line_of


def run(root: pathlib.Path,
        baseline: Optional[List[str]] = None,
        checkers: Optional[List[object]] = None) -> Report:
    """Full-tree analysis of ``root``'s ``kubeflow_tpu_torch/``."""
    checkers = default_checkers() if checkers is None else checkers
    for checker in checkers:
        if hasattr(checker, "set_root"):
            checker.set_root(root)
    per_file: Dict[str, Dict[int, Set[str]]] = {}
    texts: Dict[str, List[str]] = {}
    findings: List[Finding] = []
    files = 0
    for path in py_files(root):
        rel = path.relative_to(root).as_posix()
        text = path.read_text(encoding="utf-8")
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue  # ci/lint.py owns the parse gate
        files += 1
        per_file[rel] = expand_decorator_suppressions(
            tree, suppressions(text))
        texts[rel] = text.splitlines()
        for checker in checkers:
            findings.extend(checker.visit_module(rel, tree, text))
    for checker in checkers:
        findings.extend(checker.finish())
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.check))
    findings = dedupe_symbols(findings, _line_lookup(texts))
    findings, suppressed = apply_suppressions(findings, per_file)
    new, old, stale = split_by_baseline(findings, baseline or [])
    return Report(findings=new, baselined=old, stale=stale,
                  suppressed=suppressed, files=files)


def analyze_source(text: str, rel: str = "kubeflow_tpu_torch/mod.py",
                   checkers: Optional[List[object]] = None
                   ) -> List[Finding]:
    """One in-memory module through the full pipeline (checkers +
    suppressions, no baseline) — the test fixture entry point."""
    checkers = default_checkers() if checkers is None else checkers
    tree = ast.parse(text)
    findings: List[Finding] = []
    for checker in checkers:
        findings.extend(checker.visit_module(rel, tree, text))
    for checker in checkers:
        findings.extend(checker.finish())
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.check))
    lines = text.splitlines()
    findings = dedupe_symbols(findings, _line_lookup({rel: lines}))
    findings, _ = apply_suppressions(
        findings, {rel: expand_decorator_suppressions(
            tree, suppressions(text))})
    return findings
