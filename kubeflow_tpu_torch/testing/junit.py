"""JUnit XML result emission — heir of the reference's wrap_test
(testing/test_deploy.py:253-276), which wrapped each E2E step's outcome
into JUnit artifacts for TestGrid/Gubernator.  The port's copy of
kubeflow_tpu/testing/junit.py (stdlib only); ``testing/e2e.py``'s
``main`` writes one suite with a case per scenario.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional
from xml.sax.saxutils import escape


@dataclasses.dataclass
class TestCase:
    name: str
    time_s: float = 0.0
    failure: Optional[str] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.failure is None and self.error is None


class JUnitSuite:
    """Collects cases; writes junit_<name>.xml like the reference's
    artifact convention."""

    def __init__(self, name: str):
        self.name = name
        self.cases: List[TestCase] = []

    def run(self, case_name: str, fn: Callable[[], None]) -> TestCase:
        """Run fn, recording wall time and failure/error classification
        (AssertionError -> <failure>, anything else -> <error>)."""
        t0 = time.monotonic()
        case = TestCase(name=case_name)
        try:
            fn()
        except AssertionError:
            case.failure = traceback.format_exc()
        except Exception:
            case.error = traceback.format_exc()
        case.time_s = time.monotonic() - t0
        self.cases.append(case)
        return case

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.cases)

    def to_xml(self) -> str:
        failures = sum(1 for c in self.cases if c.failure)
        errors = sum(1 for c in self.cases if c.error)
        total_time = sum(c.time_s for c in self.cases)
        lines = [
            '<?xml version="1.0" encoding="utf-8"?>',
            f'<testsuite name="{escape(self.name)}" tests="{len(self.cases)}"'
            f' failures="{failures}" errors="{errors}"'
            f' time="{total_time:.3f}">',
        ]
        for c in self.cases:
            lines.append(
                f'  <testcase name="{escape(c.name)}" time="{c.time_s:.3f}"'
                + ("/>" if c.ok else ">")
            )
            if c.failure is not None:
                lines.append(
                    f'    <failure>{escape(c.failure)}</failure>')
            if c.error is not None:
                lines.append(f'    <error>{escape(c.error)}</error>')
            if not c.ok:
                lines.append("  </testcase>")
        lines.append("</testsuite>")
        return "\n".join(lines)

    def write(self, artifacts_dir: str | Path) -> Path:
        out = Path(artifacts_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"junit_{self.name}.xml"
        path.write_text(self.to_xml())
        return path
