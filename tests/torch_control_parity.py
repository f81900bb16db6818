"""Differential runs of the JAX package's control-plane tests on both
packages.

A JAX test module (``tests/test_scheduler.py``, ``tests/test_operator.py``
and the reconciler cases of ``test_prom.py`` and ``test_tracing.py``) is
loaded twice: as it is, and with its imports pointed at
``kubeflow_tpu_torch`` and its TPU slice names mapped onto the port's GPU
shapes (``SLICE_MAP``).  Each test then runs once on each package, with
its own assertions, under a frozen policy clock (``faults.monotonic``
reads a virtual 1000 s plus the injector's skew), and ``Recorder`` logs what the
control plane did: every admission plan (order, decisions, victims,
fused gangs, grace overrides), every FakeKube write (pods, services,
claim CRs, status updates, events, deployment scale patches), the final
CRs, pods, services and events, the gang claims, and the deltas of the
``kft_scheduler_*``, ``kft_operator_*``, ``kft_autoscaler_*`` and
``kft_gang_*`` samples (gauges zeroed first), and the traces of every
trace store the test enabled (span names, tree, status and attributes),
and how often each control-plane fault site (``scheduler.*``,
``autoscaler.claim``, ``kube.request``) fired under each injector.  The two logs must be
equal once the JAX log's slice names are mapped, with two exceptions
that are the hardware's: a pod's accelerator request (``google.com/tpu``
against ``nvidia.com/gpu``, each checked against its own package's
topology) and its node selector (each package's ``k8s_node_selector``);
and chip counts, which are compared per slice of the shape (``h100-32``
holds 32 GPUs where ``v5p-32`` holds 16 chips, on the same 4 hosts).
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import json
import re
import types
from pathlib import Path

import kubeflow_tpu.operator.gang as jax_gang
import kubeflow_tpu.operator.kube as jax_kube
import kubeflow_tpu.runtime.prom as jax_prom
import kubeflow_tpu.runtime.topology as jax_topology
import kubeflow_tpu.runtime.tracing as jax_tracing
import kubeflow_tpu.scheduler.colocate as jax_colocate
import kubeflow_tpu.scheduler.policy as jax_policy
import kubeflow_tpu.scheduler.queue as jax_queue
import kubeflow_tpu.testing.faults as jax_faults
import kubeflow_tpu_torch.operator.gang as port_gang
import kubeflow_tpu_torch.operator.kube as port_kube
import kubeflow_tpu_torch.runtime.prom as port_prom
import kubeflow_tpu_torch.runtime.topology as port_topology
import kubeflow_tpu_torch.runtime.tracing as port_tracing
import kubeflow_tpu_torch.scheduler.colocate as port_colocate
import kubeflow_tpu_torch.scheduler.policy as port_policy
import kubeflow_tpu_torch.scheduler.queue as port_queue
import kubeflow_tpu_torch.testing.faults as port_faults

REPO = Path(__file__).resolve().parents[1]

# JAX slice name -> the port's shape with as many hosts (pods a slice):
# equal chip counts too for the one-host shapes.  ``h100-4x8`` names
# four hosts of eight GPUs, the ``h100-32`` topology, as its own
# inventory key.
SLICE_MAP = {"v5e-1": "h100-1", "v5e-8": "h100-8", "v5e-16": "h100-4x8",
             "v5p-32": "h100-32"}
_SLICE_RE = re.compile(r"(?<![\w.-])(%s)(?![\w-])" % "|".join(
    re.escape(k) for k in sorted(SLICE_MAP, key=len, reverse=True)))
_PACKAGE_RE = re.compile(r"\bkubeflow_tpu\b(?=\.[a-z_]|\s+import\b)")

PACKAGES = {
    "jax": types.SimpleNamespace(
        faults=jax_faults, prom=jax_prom, kube=jax_kube, gang=jax_gang,
        queue=jax_queue, policy=jax_policy, colocate=jax_colocate,
        topology=jax_topology, tracing=jax_tracing,
        accel="google.com/tpu"),
    "port": types.SimpleNamespace(
        faults=port_faults, prom=port_prom, kube=port_kube, gang=port_gang,
        queue=port_queue, policy=port_policy, colocate=port_colocate,
        topology=port_topology, tracing=port_tracing,
        accel="nvidia.com/gpu"),
}
FAULT_SITE_PREFIXES = ("scheduler.", "autoscaler.", "kube.")
METRIC_PREFIXES = ("kft_scheduler_", "kft_operator_", "kft_autoscaler_",
                   "kft_gang_")


def map_slices(text: str) -> str:
    return _SLICE_RE.sub(lambda m: SLICE_MAP[m.group(1)], text)


def port_source(src: str, rewrites=()) -> str:
    """The JAX test source pointed at the port: its imports, its slice
    names, then the file's own ``(old, new)`` rewrites, each of which
    must apply."""
    src = map_slices(_PACKAGE_RE.sub("kubeflow_tpu_torch", src))
    for old, new in rewrites:
        assert old in src, old
        src = src.replace(old, new)
    return src


def load_variants(test_file: str, rewrites=()) -> dict:
    """{package: module} of ``tests/<test_file>`` as it is and pointed
    at the port."""
    src = (REPO / "tests" / test_file).read_text()
    out = {}
    for name, text in (("jax", src), ("port", port_source(src, rewrites))):
        mod = types.ModuleType(f"{name}_{Path(test_file).stem}")
        mod.__file__ = str(REPO / "tests" / test_file)
        exec(compile(text, f"<{name}:{test_file}>", "exec"), mod.__dict__)
        out[name] = mod
    return out


def jax_test_names(mod) -> list:
    """``Class::method`` and ``function`` names of a module's tests, in
    source order."""
    names = []
    for attr, obj in vars(mod).items():
        if attr.startswith("Test") and inspect.isclass(obj):
            names += [f"{attr}::{m}" for m in vars(obj)
                      if m.startswith("test_")]
        elif attr.startswith("test_") and inspect.isfunction(obj):
            names.append(attr)
    return names


class _FrozenTime:
    """``time`` as the faults module sees it: a virtual monotonic clock
    at 1000 s (the injector adds its skew) that only a sleep through
    the faults module moves, by the sleep's length, without waiting (a
    policy backoff then ends after its delay in no wall time)."""

    def __init__(self, real):
        self._real = real
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.now += max(0.0, float(seconds))

    def __getattr__(self, name):
        return getattr(self._real, name)


def _plain(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, set):
        return sorted(_plain(v) for v in obj)
    return obj


class Recorder:
    """Hooks one package's control plane for one test run."""

    _KUBE_WRITES = ("create_pod", "delete_pod", "set_pod_phase",
                    "set_pod_node", "create_service", "delete_service",
                    "create_deployment", "patch_deployment_scale",
                    "create_custom", "delete_custom",
                    "update_custom_status", "record_event")

    def __init__(self, pkg_name, monkeypatch):
        self.name = pkg_name
        self.p = PACKAGES[pkg_name]
        self.log = []
        self.kubes = []
        self.gangs = []
        self.stores = []
        self.injectors = []
        mp = monkeypatch
        mp.setattr(self.p.faults, "time", _FrozenTime(
            self.p.faults.time if not isinstance(
                self.p.faults.time, _FrozenTime)
            else self.p.faults.time._real))
        rec = self

        def hook_init(cls, into):
            orig = cls.__init__

            def __init__(self, *a, **kw):
                orig(self, *a, **kw)
                into.append(self)
            mp.setattr(cls, "__init__", __init__)

        enable = self.p.tracing.enable

        def enable_and_keep(*a, **kw):
            store = enable(*a, **kw)
            rec.stores.append(store)
            return store
        mp.setattr(self.p.tracing, "enable", enable_and_keep)
        parse = self.p.faults.parse

        def parse_and_keep(spec):
            inj = parse(spec)
            rec.injectors.append(inj)
            return inj
        mp.setattr(self.p.faults, "parse", parse_and_keep)
        hook_init(self.p.kube.FakeKube, self.kubes)
        hook_init(self.p.gang.GangScheduler, self.gangs)
        for meth in self._KUBE_WRITES:
            orig = getattr(self.p.kube.FakeKube, meth)

            def write(self, *a, _orig=orig, _meth=meth, **kw):
                out = _orig(self, *a, **kw)
                rec.log.append((_meth, rec.norm(copy.deepcopy(a)),
                                rec.norm(copy.deepcopy(kw))))
                return out
            mp.setattr(self.p.kube.FakeKube, meth, write)
        for cls, tag in ((self.p.queue.ClusterScheduler, "cluster.plan"),
                         (self.p.policy.SchedulingPolicy, "policy.plan")):
            orig = cls.plan

            def plan(self, *a, _orig=orig, _tag=tag, **kw):
                try:
                    out = _orig(self, *a, **kw)
                except Exception as e:
                    rec.log.append((_tag, "raised", type(e).__name__))
                    raise
                rec.log.append((_tag, _plain(out)))
                return out
            mp.setattr(cls, "plan", plan)
        client = self.p.colocate.ServingClaimClient
        for meth in ("sync", "observe"):
            orig = getattr(client, meth)

            def claim(self, *a, _orig=orig, _meth=meth, **kw):
                out = _orig(self, *a, **kw)
                rec.log.append((f"claim.{_meth}", a, _plain(out)))
                return out
            mp.setattr(client, meth, claim)
        self._zero_gauges()
        self.before = self._samples()

    # -- normalization ------------------------------------------------------

    def _topology(self, slice_type):
        try:
            return self.p.topology.parse_slice_type(slice_type)
        except ValueError:
            return None

    def norm_pod(self, pod):
        """A worker pod with its accelerator request and node selector
        checked against this package's topology and replaced by tokens."""
        spec = pod.get("spec") or {}
        containers = spec.get("containers") or []
        env = {e["name"]: e["value"] for c in containers
               for e in c.get("env", ())}
        topo = self._topology(env.get("KFT_SLICE_TYPE", ""))
        if topo is None:
            return pod
        for c in containers:
            res = c.get("resources")
            if topo.is_cpu:
                assert res == {"requests": {"cpu": "1", "memory": "1Gi"}}
            else:
                want = {self.p.accel: str(topo.chips_per_host)}
                assert res == {"limits": want, "requests": want}, res
                c["resources"] = "ACCELERATOR"
        if "nodeSelector" in spec:
            assert spec["nodeSelector"] == topo.k8s_node_selector()
            spec["nodeSelector"] = "SELECTOR" if spec["nodeSelector"] \
                else {}
        return pod

    def norm(self, obj):
        if isinstance(obj, dict):
            if obj.get("kind") == "Pod":
                obj = self.norm_pod(obj)
            # Wall-clock stamps: an event's, a status transition's.
            obj.pop("ts", None)
            obj.pop("lastTransition", None)
            return {k: self.norm(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [self.norm(v) for v in obj]
        return obj

    # -- metrics ------------------------------------------------------------

    def _metrics(self):
        reg = self.p.prom.REGISTRY
        with reg._lock:
            return dict(reg._metrics)

    def _zero_gauges(self):
        for name, m in self._metrics().items():
            if m.kind == "gauge" and name.startswith(METRIC_PREFIXES):
                for labels in m.labelsets():
                    m.set(0.0, **labels)

    def _samples(self):
        out = {}
        parsed = self.p.prom.parse_metrics(self.p.prom.REGISTRY.render())
        for name, series in parsed.items():
            if not name.startswith(METRIC_PREFIXES):
                continue
            for labels, value in series:
                out[(name, tuple(sorted(labels.items())))] = value
        return out

    def _per_slice(self, name, labels, value):
        """Chip samples of one slice shape, per slice of that shape."""
        slice_type = dict(labels).get("slice_type")
        if "chips" in name and slice_type:
            topo = self._topology(slice_type)
            if topo is not None and not topo.is_cpu:
                return value / topo.chips
        return value

    # -- the run's record -----------------------------------------------------

    def finish(self):
        after = self._samples()
        deltas = {}
        for key, value in after.items():
            d = value - self.before.get(key, 0.0)
            if d:
                deltas[f"{key[0]}{dict(key[1])}"] = self._per_slice(
                    key[0], key[1], d)
        kubes = []
        for kube in self.kubes:
            kubes.append(self.norm(copy.deepcopy({
                "custom": sorted(kube.list_custom(),
                                 key=lambda c: (c["metadata"].get(
                                     "namespace", ""),
                                     c["metadata"]["name"])),
                "pods": [kube.pods[k] for k in sorted(kube.pods)],
                "services": [kube.services[k]
                             for k in sorted(kube.services)],
                "events": list(kube.events),
            })))
        gangs = [{"claims": _plain(g.claims), "queue": _plain(g.queue),
                  "metrics": _plain(g.metrics)} for g in self.gangs]
        traces = [[_trace(t) for t in store.traces()]
                  for store in self.stores]
        fired = [{site: inj.fired(site) for site in sorted(inj._fired)
                  if site.startswith(FAULT_SITE_PREFIXES)}
                 for inj in self.injectors]
        return {"log": self.log, "kubes": kubes, "gangs": gangs,
                "metrics": deltas, "traces": traces, "fired": fired}


def _trace(trace):
    """A retained trace without its ids and times: each span's name,
    its parent's name, its status and attributes."""
    names = {s["span_id"]: s["name"] for s in trace["spans"]}
    return {"root": trace["root"], "status": trace["status"],
            "retained": trace["retained"],
            "spans": sorted((
                (s["name"], names.get(s.get("parent_id"), ""),
                 s.get("status"), _plain(s.get("attrs") or {}))
                for s in trace["spans"]),
                key=lambda row: json.dumps(row, sort_keys=True,
                                           default=repr))}


# An InvalidSpec message lists the package's registered shapes.
_KNOWN_SHAPES = re.compile(r"known: \[[^\]]*\]")


def jax_as_port(record):
    """The JAX run's record with its slice names mapped onto the port's."""
    return port_as_json(record, map_slices)


def port_as_json(record, mapping=lambda text: text):
    text = json.dumps(record, sort_keys=True, default=repr)
    return json.loads(_KNOWN_SHAPES.sub("known: [shapes]", mapping(text)))


def _fixture_value(mod, inst, name, request_env, finalizers):
    if name in request_env:
        return request_env[name]
    fix = getattr(inst, name, None) if inst is not None else None
    bound = fix is not None
    if fix is None:
        fix = getattr(mod, name)
    fn = fix._get_wrapped_function()
    args = [inst] if bound else []
    params = list(inspect.signature(fn).parameters)[len(args):]
    kwargs = {p: _fixture_value(mod, inst, p, request_env, finalizers)
              for p in params}
    value = fn(*args, **kwargs)
    if inspect.isgenerator(value):
        gen = value
        value = next(gen)
        finalizers.append(lambda: next(gen, None))
    return value


def run_case(mod, case, env):
    """Run test ``case`` (``Class::method`` or ``function``) of ``mod``,
    with its fixtures built from the module (``env`` supplies
    ``tmp_path`` and ``monkeypatch``)."""
    cls_name, _, meth = case.rpartition("::")
    inst = getattr(mod, cls_name)() if cls_name else None
    fn = getattr(inst, meth) if inst is not None else getattr(mod, meth)
    finalizers = []
    try:
        kwargs = {p: _fixture_value(mod, inst, p, env, finalizers)
                  for p in inspect.signature(fn).parameters}
        fn(**kwargs)
    finally:
        for fin in reversed(finalizers):
            fin()


def differential(variants, case, tmp_path, monkeypatch):
    """Run test ``case`` of each package's variant; returns {package:
    record}."""
    def run(name, mp):
        path = tmp_path / name
        path.mkdir()
        run_case(variants[name], case, {"tmp_path": path,
                                        "monkeypatch": mp})
    return differential_calls(run, monkeypatch)


def differential_calls(run, monkeypatch):
    """Call ``run(package, monkeypatch)`` for each package under its
    recorder; returns {package: record}."""
    out = {}
    for name in PACKAGES:
        with monkeypatch.context() as mp:
            rec = Recorder(name, mp)
            run(name, mp)
            out[name] = rec.finish()
    return out


def first_difference(a, b, path="$"):
    """Where two JSON values first differ, as (path, a's, b's), or None."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b:
                return (f"{path}.{k}", a.get(k, "<absent>"),
                        b.get(k, "<absent>"))
            d = first_difference(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list):
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_difference(x, y, f"{path}[{i}]")
            if d:
                return d
        if len(a) != len(b):
            return (f"{path}.length", len(a), len(b))
        return None
    return None if a == b else (path, a, b)


def assert_same(out):
    """The port's record equals the JAX record, slice names mapped."""
    jax = jax_as_port(out["jax"])
    port = port_as_json(out["port"])
    for part in ("log", "kubes", "gangs", "metrics", "traces", "fired"):
        diff = first_difference(port[part], jax[part], part)
        assert diff is None, f"port != jax at {diff[0]}: {diff[1]!r} " \
            f"!= {diff[2]!r}"
