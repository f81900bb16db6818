"""CLI: ``python -m kubeflow_tpu_torch.analysis [--root DIR] [--json]``.

Exit 0 = clean: zero unsuppressed, un-baselined findings AND zero
stale baseline entries over ``kubeflow_tpu_torch/``;
tests/test_torch_analysis.py asserts the port stays clean.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from kubeflow_tpu_torch.analysis import core

DEFAULT_BASELINE = "kubeflow_tpu_torch/analysis/baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".",
                    help="repo root to analyze (default: cwd)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    args = ap.parse_args(argv)

    root = pathlib.Path(args.root).resolve()
    baseline_path = root / DEFAULT_BASELINE
    baseline = core.load_baseline(baseline_path)
    report = core.run(root, baseline=baseline)

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in report.findings],
            "baselined": [f.to_json() for f in report.baselined],
            "stale_baseline": report.stale,
            "suppressed": report.suppressed,
            "files": report.files,
        }, indent=2))
    else:
        for f in report.findings:
            print(f.render())
        for fp in report.stale:
            print(f"{baseline_path}: stale baseline entry {fp!r} — "
                  f"the finding no longer fires; delete the entry "
                  f"(shrink-only)")
    print(f"analysis: {report.files} files, "
          f"{len(report.findings)} finding(s), "
          f"{len(report.baselined)} baselined, "
          f"{report.suppressed} suppressed, "
          f"{len(report.stale)} stale baseline entr(ies)",
          file=sys.stderr)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
