"""Deterministic fault-injection harness: a copy of the JAX package's
kubeflow_tpu/testing/faults.py (host-only; the port imports nothing of
the JAX package).  Of the hook sites listed below, the port plants
``train.step`` (runtime/train.py ``Trainer.fit``), ``checkpoint.save`` and
``checkpoint.restore`` (runtime/checkpoint.py) and ``data.next``
(data/loader.py), where the JAX package fires them; the others come with
the modules that hold them.

The reference stack's failure paths were exercised only by real cluster
weather (SURVEY.md §4); ours are driven deterministically: named hook
sites in production code call :func:`fire`, which is a no-op until a
:class:`FaultInjector` is installed — from a test, or from the
``KFT_FAULTS`` env var at process start (serving/main.py installs it),
so the same scripted chaos runs in-process, in the e2e harness, and
against a deployed container.

Hook sites planted in production code (grep for ``faults.fire``):

    engine.step       before each DecodeEngine step-program call
                      (sleep = slow/wedged step, raise = device death)
    engine.admit      before each prefill admission call
    engine.alloc_block before paged-KV pages are taken from a slot's
                      admission reservation as its frontier grows
                      (sleep = slow allocator under pool pressure,
                      raise = allocation failure — engine death at
                      the growth site, every waiter resolved)
    batcher.dispatch  MicroBatcher batch dispatch (sleep = queue stall)
    loader.load       ModelServer.reload before load_version
                      (raise = corrupt checkpoint directory)
    kube.request      HttpKube transport attempt (raise = apiserver
                      connection failure, before the retry layer)
    router.forward    fleet router upstream attempt (raise = replica
                      connection failure, before the socket — the
                      retry/ejection layer sees it as a refused
                      connect)
    router.replay     each replay/failover attempt the router grants
                      for an idempotent POST — after the cap and the
                      retry-budget withdrawal, before the new replica
                      is picked (raise = failure of the failover path
                      itself; the chaos e2e's deterministic replay
                      observation point)
    engine.resume     DecodeEngine admission of a resume request
                      (prompt + tokens a prior attempt delivered,
                      the router's mid-generation failover payload;
                      sleep = slow failover, raise = resume rejected)
    engine.kv_handoff disaggregated prefill/decode page transfer —
                      fired on the prefill tier's export gather and
                      the decode tier's import scatter (sleep = slow
                      cross-replica transfer, raise = handoff
                      failure; the router surfaces it rather than
                      hanging the tiered dispatch)
    router.tier_dispatch
                      the router's tiered prefill-then-decode
                      dispatch decision for a :generate (raise =
                      tier routing failure — the request must fall
                      back to the untiered path, never hang or 500)
    engine.spill      hierarchical-KV host-tier traffic: the spill-out
                      gather (raise = spill abandoned, the record
                      stays device-resident and destructive eviction
                      remains the fallback), the park gather (raise =
                      the session parks device-resident only), and
                      the spill-in re-import at admission (raise =
                      typed Overloaded shed, no page leaked in
                      either tier; sleep = slow host copy)
    engine.fetch      the :fetch_kv host-tier read a failover peer
                      asks for a session's pages (raise = fetch
                      failure — the router falls back to
                      recompute-resume, sleep = slow fetch)
    adapter.load      AdapterRegistry cold-load of a requested
                      adapter from disk, before the artifact read
                      (raise = corrupt/missing adapter: the request
                      sheds 404, the breaker opens, and resident
                      last-good adapters KEEP serving; sleep = slow
                      hot-load under traffic)
    adapter.evict     LRU eviction of an idle resident adapter to
                      free a slot (raise = eviction failure — the
                      incoming load sheds, nothing in-flight is
                      touched)
    fleet.probe       endpoint registry readiness probe attempt
    scheduler.admit   cluster scheduler admission-plan pass (skew =
                      age the queue / expire preemption windows,
                      raise = wedged policy pass — the reconcile
                      error path must contain it)
    scheduler.preempt each eviction wave the policy commits (before
                      victims are marked)
    scheduler.fuse    each fused gang the fold pass forms from
                      fusable queued singletons (scheduler/fuse.py;
                      raise = wedged fold — contained like a wedged
                      admission pass, members stay queued singletons)
    scheduler.colocate
                      each serving-claim view the colocation fold
                      splits or admits into the shared pool
                      (scheduler/colocate.py; raise = wedged fold —
                      contained, the claim stays pending and training
                      is untouched)
    autoscaler.claim  each ServingClaimClient.sync of the desired
                      replica count into the claim CR (raise =
                      apiserver blip — the autoscaler loop absorbs it
                      and the next level-triggered pass repairs;
                      sleep = slow claim write)
    train.step        each Trainer.fit loop iteration, before the
                      dispatch (raise = step fault the supervisor
                      restarts from, skew = ages stall/backoff
                      deadlines)
    checkpoint.save   background checkpoint finalize, between the
                      step's commit and the manifest write (raise =
                      kill mid-save: step left unverified, error
                      surfaces at the next save()/wait())
    checkpoint.restore each CheckpointManager.restore attempt
    data.next         each TensorBatches batch pull (raise = one
                      transient read error, retried with backoff)

Clock skips: deadline/backoff code reads :func:`monotonic` instead of
``time.monotonic`` — a ``skew`` action (or ``advance_clock`` from a
test) jumps that clock forward so deadline expiry and circuit-breaker
cool-downs are tested in microseconds of wall time.  Perf timings keep
using the real clock; only *policy* clocks are skewable.

Spec grammar (``KFT_FAULTS``), ``;``-separated entries::

    seed=N                          RNG seed for @prob draws (default 0)
    site:action[=value][*times][@prob]

    engine.step:sleep=0.05*3        first 3 steps take +50 ms
    loader.load:raise               every reload attempt raises
    batcher.dispatch:stall=0.2@0.5  ~half of dispatches stall 200 ms
    engine.step:skew=5*1            one step jumps the policy clock 5 s

Actions: ``raise`` (FaultInjected), ``sleep``/``stall`` (block value
seconds), ``skew`` (advance the policy clock value seconds).  ``*times``
bounds firings (default unlimited); ``@prob`` fires each encounter with
that probability from the seeded RNG — the whole scenario is a pure
function of the spec string, so a chaos run is replayable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
import time
from typing import Dict, List, Optional

ENV = "KFT_FAULTS"


class FaultInjected(RuntimeError):
    """The scripted failure a ``raise`` action throws at its hook site."""


@dataclasses.dataclass
class FaultSpec:
    site: str
    action: str            # raise | sleep | stall | skew
    value: float = 0.0
    times: int = -1        # firings remaining; -1 = unlimited
    prob: float = 1.0

    _ACTIONS = ("raise", "sleep", "stall", "skew")

    def __post_init__(self):
        if self.action not in self._ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r} for site "
                f"{self.site!r}; known: {self._ACTIONS}")


def parse(spec: str) -> "FaultInjector":
    """Parse a ``KFT_FAULTS`` string into an injector (see grammar)."""
    seed = 0
    specs: List[FaultSpec] = []
    for raw in spec.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            seed = int(entry[5:])
            continue
        site, sep, rest = entry.partition(":")
        if not sep or not rest:
            raise ValueError(
                f"bad fault entry {entry!r}: want site:action[=value]"
                f"[*times][@prob]")
        prob = 1.0
        if "@" in rest:
            rest, _, p = rest.rpartition("@")
            prob = float(p)
        times = -1
        if "*" in rest:
            rest, _, t = rest.rpartition("*")
            times = int(t)
        action, _, value = rest.partition("=")
        specs.append(FaultSpec(site=site, action=action,
                               value=float(value) if value else 0.0,
                               times=times, prob=prob))
    return FaultInjector(specs, seed=seed)


class FaultInjector:
    """Seeded, scripted fault firing at named hook sites.

    Thread-safe: hook sites fire from server/dispatch/loop threads while
    tests read counts.  The RNG and remaining-times bookkeeping live
    under one lock; the sleep itself runs outside it (a stalled dispatch
    must not stall every other site)."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self._lock = threading.Lock()
        self._specs: Dict[str, List[FaultSpec]] = {}
        for s in specs:
            self._specs.setdefault(s.site, []).append(
                dataclasses.replace(s))
        self._rng = random.Random(seed)
        self._fired: Dict[str, int] = {}
        self._skew = 0.0

    # -- hook-site surface -------------------------------------------------

    def fire(self, site: str) -> None:
        """Run the scripted actions for one encounter of ``site``.

        Every encounter is COUNTED (fired()), with or without a spec at
        the site — tests use the count to prove production code did or
        did NOT reach a hook (e.g. the reload breaker skipping the
        loader entirely while open)."""
        sleep_s = 0.0
        boom: Optional[FaultInjected] = None
        with self._lock:
            self._fired[site] = self._fired.get(site, 0) + 1
            for s in self._specs.get(site, ()):
                if s.times == 0:
                    continue
                if s.prob < 1.0 and self._rng.random() >= s.prob:
                    continue
                if s.times > 0:
                    s.times -= 1
                if s.action in ("sleep", "stall"):
                    sleep_s += s.value
                elif s.action == "skew":
                    self._skew += s.value
                elif boom is None:
                    boom = FaultInjected(
                        f"injected fault at {site}")
        if sleep_s:
            time.sleep(sleep_s)
        if boom is not None:
            raise boom

    def monotonic(self) -> float:
        """The policy clock: real monotonic time plus accumulated skew."""
        with self._lock:
            return time.monotonic() + self._skew

    # -- test surface ------------------------------------------------------

    def advance_clock(self, seconds: float) -> None:
        """Jump the policy clock forward (deadlines/backoffs expire)."""
        with self._lock:
            self._skew += float(seconds)

    def fired(self, site: str) -> int:
        """Hook-site ENCOUNTERS while this injector was installed (a
        site with no spec still counts — see fire())."""
        with self._lock:
            return self._fired.get(site, 0)


# The installed injector.  Hook sites read the module global once per
# encounter — when nothing is installed the cost is one attribute load
# and an ``is None`` branch, cheap enough for the engine step loop.
_ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def fire(site: str) -> None:
    inj = _ACTIVE
    if inj is not None:
        inj.fire(site)


def monotonic() -> float:
    """Policy clock for deadline and backoff decisions (skewable)."""
    inj = _ACTIVE
    return inj.monotonic() if inj is not None else time.monotonic()


def policy_backoff(attempt: int, base_s: float, cap_s: float,
                   rng: random.Random, poll_s: float = 0.05) -> None:
    """The repo's one capped-jittered retry backoff, expired on the
    POLICY clock: delay = min(base * 2^(attempt-1), cap) jittered to
    [0.8, 1.2]x, waited by polling :func:`monotonic` in short wall
    sleeps — a seeded ``skew`` (or ``advance_clock``) expires it in
    microseconds of wall time.  Shared by the training supervisor's
    restart backoff and the data loader's transient-read retry."""
    base = min(base_s * (2 ** (max(attempt, 1) - 1)), cap_s)
    delay = base * (0.8 + 0.4 * rng.random())
    deadline = monotonic() + delay
    while monotonic() < deadline:
        time.sleep(min(poll_s, max(0.0, delay)))


def install(injector: Optional[FaultInjector]) -> None:
    global _ACTIVE
    _ACTIVE = injector


def install_from_env(environ=os.environ) -> Optional[FaultInjector]:
    """Install the ``KFT_FAULTS`` scenario, if any (serving/main.py
    calls this at startup so deployed containers honor the env var)."""
    spec = environ.get(ENV, "").strip()
    if not spec:
        return None
    inj = parse(spec)
    install(inj)
    return inj


@contextlib.contextmanager
def injected(spec: str):
    """Test-scoped installation: ``with faults.injected("site:raise"):``
    installs the parsed scenario and restores the previous injector on
    exit (exception-safe; scenarios must not leak across tests)."""
    prev = _ACTIVE
    inj = parse(spec)
    install(inj)
    try:
        yield inj
    finally:
        install(prev)
