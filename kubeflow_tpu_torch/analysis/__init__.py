"""The port's analyzer: kubeflow_tpu/analysis (kft-analyze) copied and
rescoped to ``kubeflow_tpu_torch/`` (stdlib only; the port imports
nothing of the JAX package).

``ci/lint.py`` enforces *formatting* rules over the whole repo; this
package enforces the *semantic* invariants the JAX package keeps by
design, over the port's own code:

  clock-discipline  policy modules (serving, fleet, scheduler,
                    operator) never read ``time.monotonic()`` /
                    ``time.time()`` directly — deadline, backoff, and
                    aging decisions route through the skewable
                    ``testing.faults.monotonic()`` policy clock so the
                    seeded clock-skew fault tests actually cover them
  lock-guard        an attribute written under ``with self._lock`` in
                    any method of a class is *guarded*: writing it
                    outside the lock anywhere else in the class is the
                    lost-update bug class (the cycle-profile bug)
  capture-purity    the bodies ``serving/programs.py`` captures as
                    CUDA graphs must not call host-effect modules
                    (time, random, threading, ...) — a capture records
                    device work only, so a host effect runs once at
                    capture and never on replay (the port's form of
                    the JAX analyzer's ``jit-purity``)
  metric-hygiene    every Prometheus name literal starts ``kft_``,
                    counters end ``_total`` (and only counters do),
                    and one metric name keeps ONE label set across
                    every call site

Four more checkers are FLOW-SENSITIVE, built on the intraprocedural
CFG + forward dataflow core in ``cfg.py`` (exception edges from every
statement in a protected body, ``with`` enter/exit, escapes routed
through ``finally``):

  blocking-under-lock  no ``time.sleep``/backoff/socket I/O/
                       subprocess/``Future.result``/blocking queue
                       get/HTTP round-trip on any path where a
                       ``self.*lock*`` is held — the router/engine/
                       scheduler stall class
  span-discipline      a live span (``x = tracing.start_span(...)``)
                       ends on EVERY path out of the function,
                       exception edges included; hot-loop modules
                       (serving/engine.py, models/generate.py) stamp
                       with drain-time ``record_span`` only; span
                       names are unique per module
  atomic-write         durable-state modules (runtime/checkpoint.py,
                       operator/*) commit files tmp + fsync +
                       ``os.replace`` — a bare write of a final path
                       or a rename without fsync is the
                       kill-mid-save bug
  fault-site-registry  every literal ``faults.fire("<site>")`` in
                       code appears in the port's testing/faults.py
                       docstring registry AND README's port fault-
                       injection list, and vice versa — no phantom or
                       undocumented KFT_FAULTS sites

Run ``python -m kubeflow_tpu_torch.analysis [--json]``; it analyzes
the whole package every time.  Per-line suppressions use
``# kft: allow=<check>``; known pre-existing findings live in the
shrink-only baseline ``kubeflow_tpu_torch/analysis/baseline.json`` (see
``core.py``), which is empty.
"""

from kubeflow_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    analyze_source,
    load_baseline,
    run,
)

__all__ = ["Finding", "analyze_source", "load_baseline", "run"]
