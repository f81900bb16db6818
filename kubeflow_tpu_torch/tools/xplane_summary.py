"""Trace summarizer: per-op device time from a ``torch.profiler`` trace.

The port of kubeflow_tpu/tools/xplane_summary.py (the name is kept so the
counterpart is easy to find; the JAX tool reads ``jax.profiler``'s XPlane
files).  This one reads the Chrome traces ``runtime/profiling.py`` writes
(``*.pt.trace.json``; a directory means its newest trace) and prints,
per GPU, a table of where device time went: busy (leaf ops), by
category, the top ops with their event counts, the range annotations
that cover them, and what overlapped.

The JAX tool's two pitfalls, as they arise on the card:

  * kernels on several CUDA streams cover the same wall time; summing
    every kernel double-counts.  Busy is the UNION of the kernel
    intervals, not their sum (the per-op and per-category rows are
    sums, so they may add up to more than busy);
  * copies and sets (``gpu_memcpy``/``gpu_memset``) that OVERLAP a kernel
    hide behind it; they are reported apart, under "overlapped", and
    are not added to busy.  A copy that overlaps no kernel is device
    time like a kernel's.

Range annotations on the device timeline (``gpu_user_annotation``:
``record_function`` ranges, ``step_marker``'s steps) re-cover the ops
inside them and are listed as containers, never added to busy.  A trace
with no device events (a CPU run) is summarized over its host's CPU ops
instead, each by its self time (less the ops nested in it), busy being
the union of the outermost ops.

Usage:
  python -m kubeflow_tpu_torch.tools.xplane_summary <trace.pt.trace.json> \\
      [top_n] [--steps N]

--steps N divides every number by N (per-step table for a trace that
captured N identical steps).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import re
import sys
from typing import Dict, List, Tuple

KERNEL = "kernel"
COPIES = ("gpu_memcpy", "gpu_memset")
CONTAINER = "gpu_user_annotation"

_MATMUL = re.compile(r"gemm|xmma|cutlass|cublas|nvjet|wgmma|sm90_")
_CONV = re.compile(r"conv|cudnn|winograd|implicit_")
_ELEMENTWISE = re.compile(r"elementwise|reduce|vectorized|unrolled|"
                          r"softmax|norm")


def _categorize(name: str, cat: str) -> str:
    if cat in COPIES:
        return "memcpy/memset"
    low = name.lower()
    if "flash_" in low and "_kernel" in low:
        return "hand-written (flash)"
    if _MATMUL.search(low):
        return "matmul"
    if _CONV.search(low):
        return "conv"
    if _ELEMENTWISE.search(low):
        return "elementwise/reduce"
    return "other"


def union_ms(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals (us), in
    ms."""
    total, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total / 1e3


def _overlaps(lo: float, hi: float, spans: List[Tuple[float, float]]) -> bool:
    """Whether [lo, hi) meets any of ``spans`` (sorted by start)."""
    for s_lo, s_hi in spans:
        if s_lo >= hi:
            return False
        if s_hi > lo:
            return True
    return False


@dataclasses.dataclass
class Plane:
    """One timeline's summary: a GPU's, or the host's when the trace has
    no device events.  Times in ms, counts in events."""

    name: str
    busy_ms: float = 0.0
    ops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    cats: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    containers: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    overlap: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    wall_ms: float = 0.0

    def events(self, needle: str) -> int:
        """Leaf events whose name holds ``needle``."""
        return sum(n for name, n in self.counts.items() if needle in name)


def load_events(path) -> List[dict]:
    """The complete ('X') events of a Chrome trace file, or of the newest
    ``*.pt.trace.json`` under a directory."""
    p = pathlib.Path(path)
    if p.is_dir():
        found = sorted(p.rglob("*.pt.trace.json"),
                       key=lambda f: f.stat().st_mtime)
        if not found:
            raise FileNotFoundError(f"no *.pt.trace.json under {p}")
        p = found[-1]
    with open(p) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _device_planes(events: List[dict]) -> List[Plane]:
    by_dev: Dict[object, List[dict]] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in (KERNEL, CONTAINER) + COPIES:
            by_dev[e.get("args", {}).get("device", e.get("pid"))].append(e)
    planes = []
    for dev, evs in sorted(by_dev.items(), key=lambda kv: str(kv[0])):
        plane = Plane(name=f"GPU {dev}")
        kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                         if e["cat"] == KERNEL)
        busy = list(kernels)
        for e in evs:
            name, dur = e["name"], e["dur"] / 1e3
            if e["cat"] == CONTAINER:
                plane.containers[name] += dur
                continue
            if e["cat"] in COPIES and _overlaps(
                    e["ts"], e["ts"] + e["dur"], kernels):
                plane.overlap[name] += dur
                continue
            if e["cat"] in COPIES:
                busy.append((e["ts"], e["ts"] + e["dur"]))
            plane.ops[name] += dur
            plane.counts[name] += 1
            plane.cats[_categorize(name, e["cat"])] += dur
        plane.busy_ms = union_ms(busy)
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in evs]
        plane.wall_ms = (max(hi for _, hi in spans)
                         - min(lo for lo, _ in spans)) / 1e3
        if plane.ops:
            planes.append(plane)
    return planes


def _host_plane(events: List[dict]) -> Plane:
    """The host's CPU ops: each ``cpu_op`` by its self time (its time
    less that of the ops nested in it on its thread); busy is the union
    of the outermost ops' intervals."""
    plane = Plane(name="host (no device events)")
    threads: Dict[object, List[dict]] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            threads[(e.get("pid"), e.get("tid"))].append(e)
    outer = []
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[list] = []  # [event, children's us]
        for e in evs + [None]:
            while stack and (e is None or e["ts"] >= stack[-1][0]["ts"]
                             + stack[-1][0]["dur"]):
                done, inner = stack.pop()
                plane.ops[done["name"]] += (done["dur"] - inner) / 1e3
                plane.counts[done["name"]] += 1
                plane.cats["cpu op"] += (done["dur"] - inner) / 1e3
                if stack:
                    stack[-1][1] += done["dur"]
                else:
                    outer.append((done["ts"], done["ts"] + done["dur"]))
            if e is not None:
                stack.append([e, 0.0])
    for e in events:
        if e.get("cat") == "user_annotation":
            plane.containers[e["name"]] += e["dur"] / 1e3
    plane.busy_ms = union_ms(outer)
    if outer:
        plane.wall_ms = (max(hi for _, hi in outer)
                         - min(lo for lo, _ in outer)) / 1e3
    return plane


def summarize(path) -> List[Plane]:
    """The trace's planes: one per GPU with device events, else the
    host's."""
    events = load_events(path)
    return _device_planes(events) or [_host_plane(events)]


def device_busy_ms(path) -> float:
    """Leaf-op device busy time (ms) of a trace, the busiest GPU's (the
    host's leaf ops in a trace with no device events): the programmatic
    face of ``summarize_xplane``, with its accounting."""
    return max((p.busy_ms for p in summarize(path)), default=0.0)


def summarize_xplane(path, top_n: int = 25, steps: int = 1) -> List[Plane]:
    """Print the table of each plane of the trace at ``path`` (per step
    with ``steps``) and return the planes."""
    planes = summarize(path)
    div = max(1, steps)
    for p in planes:
        busy = p.busy_ms
        per = "" if div == 1 else f" ({busy / div:.3f} ms/step x {div})"
        share = f", {busy / p.wall_ms:.3f} of its {p.wall_ms:.1f} ms span" \
            if p.wall_ms else ""
        print(f"== {p.name}: busy (leaf ops) {busy:.3f} ms{per}{share}")
        print("  -- by category --")
        for cat, ms in p.cats.most_common():
            pct = 100 * ms / busy if busy else 0.0
            print(f"  {ms / div:9.3f} ms  {pct:5.1f}%  {cat}")
        if p.containers:
            print("  -- containers (cover the ops above) --")
            for name, ms in p.containers.most_common(4):
                print(f"  {ms / div:9.3f} ms  {name[:105]}")
        print(f"  -- top {top_n} ops (ms, events) --")
        for name, ms in p.ops.most_common(top_n):
            print(f"  {ms / div:9.3f} ms  {p.counts[name] / div:7g}  "
                  f"{name[:105]}")
        if p.overlap:
            print("  -- overlapped (copies and sets under kernels) --")
            for name, ms in p.overlap.most_common(min(top_n, 8)):
                print(f"  {ms / div:9.3f} ms  {name[:105]}")
    return planes


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="kubeflow-tpu-torch-xplane-summary", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace", help="a *.pt.trace.json file, or a directory "
                                  "(its newest trace)")
    ap.add_argument("top_n", nargs="?", type=int, default=25)
    ap.add_argument("--steps", type=int, default=1,
                    help="divide every number by N (per-step table)")
    args = ap.parse_args(argv)
    summarize_xplane(args.trace, args.top_n, steps=args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
