"""The port's Kubernetes transport against the JAX package's: FakeKube
on the same operation sequences, HttpKube over real sockets against both
packages' fake apiservers (label selectors, 404/409, the scale and
status merge-patches, Retry-After, the ``kube.request`` site), RealKube
over a stubbed ``kubernetes`` client (as tests/test_kube_real.py does
for the JAX package's), and the TPUJob wire format: both packages'
``to_custom_resource`` give the same dict on ``cpu-N`` shapes, and the
port's H100 shapes derive ``hosts`` and ``chips``."""

import copy
import sys
import types

import pytest

from kubeflow_tpu.operator import crd as jax_crd
from kubeflow_tpu.operator import kube as jax_kube
from kubeflow_tpu.operator import kube_http as jax_kube_http
from kubeflow_tpu.testing import fake_apiserver as jax_apiserver
from kubeflow_tpu.testing import faults as jax_faults
from kubeflow_tpu_torch.operator import crd, kube, kube_http, kube_real
from kubeflow_tpu_torch.testing import fake_apiserver, faults

PACKAGES = {
    "jax": (jax_kube, jax_kube_http, jax_apiserver, jax_faults),
    "port": (kube, kube_http, fake_apiserver, faults),
}


def _pod(ns, name, labels=None, port=None):
    spec = {"containers": []}
    if port is not None:
        spec["containers"] = [{"ports": [{"name": "http",
                                          "containerPort": port}]}]
    return {"metadata": {"namespace": ns, "name": name,
                         "labels": labels or {}}, "spec": spec}


def _cr(name, ns="ns1", slice_type="cpu-2"):
    return {"apiVersion": "kubeflow-tpu.org/v1alpha1", "kind": "TPUJob",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"sliceType": slice_type}}


# One operation sequence, run against any kube surface: each step is
# (method, args); the record keeps each answer (or the exception's class
# name), with event timestamps dropped.
SEQUENCE = [
    ("create_pod", (_pod("ns1", "a", {"app": "x", "tier": "1"}),)),
    ("create_pod", (_pod("ns1", "b", {"app": "x", "tier": "2"}),)),
    ("create_pod", (_pod("ns2", "c", {"app": "x"}),)),
    ("create_pod", (_pod("ns1", "a"),)),
    ("list_pods", ("ns1", {"app": "x"})),
    ("list_pods", ("ns1", {"app": "x", "tier": "2"})),
    ("list_pods", ("ns1", None)),
    ("get_pod", ("ns1", "b")),
    ("get_pod", ("ns1", "ghost")),
    ("delete_pod", ("ns1", "b")),
    ("delete_pod", ("ns1", "b")),
    ("create_service", ({"metadata": {"namespace": "ns1",
                                      "name": "svc"}},)),
    ("delete_service", ("ns1", "svc")),
    ("delete_service", ("ns1", "svc")),
    ("create_deployment", ({"metadata": {"namespace": "ns1",
                                         "name": "srv",
                                         "labels": {"app": "s"}},
                            "spec": {"replicas": 2}},)),
    ("create_deployment", ({"metadata": {"namespace": "ns1",
                                         "name": "srv"}},)),
    ("get_deployment", ("ns1", "srv")),
    ("list_deployments", ("ns1", {"app": "s"})),
    ("patch_deployment_scale", ("ns1", "srv", 5)),
    ("patch_deployment_scale", ("ns1", "ghost", 1)),
    ("get_deployment", ("ns1", "ghost")),
    ("create_custom", (_cr("job-a"),)),
    ("create_custom", (_cr("job-a"),)),
    ("create_custom", (_cr("job-b", ns="ns2"),)),
    ("list_custom", ("ns1",)),
    ("get_custom", ("ns1", "job-a")),
    ("update_custom_status", ("ns1", "job-a", {"phase": "Running"})),
    ("get_custom", ("ns1", "job-a")),
    ("update_custom_status", ("ns1", "ghost", {"phase": "x"})),
    ("delete_custom", ("ns1", "job-a")),
    ("get_custom", ("ns1", "job-a")),
    ("record_event", ("ns1", "TPUJob/job-a", "Created", "made it")),
]


def _run(client, sequence=SEQUENCE):
    out = []
    for method, args in sequence:
        try:
            answer = getattr(client, method)(*copy.deepcopy(args))
        except Exception as e:  # noqa: BLE001 — the class is the answer
            answer = type(e).__name__
        out.append((method, answer))
    return out


def _strip(record):
    """Drop what differs by transport, not by semantics: the fake
    apiserver's empty bodies for DELETE/PATCH come back as {}."""
    return [(m, None if a == {} else a) for m, a in record]


def _events(store):
    return [{k: v for k, v in e.items() if k != "ts"} for e in store.events]


def test_fake_kube_matches_jax_on_one_sequence():
    jax_store, port_store = jax_kube.FakeKube(), kube.FakeKube()
    assert _run(port_store) == _run(jax_store)
    for attr in ("pods", "services", "deployments", "custom",
                 "deleted_pods"):
        assert getattr(port_store, attr) == getattr(jax_store, attr), attr
    assert _events(port_store) == _events(jax_store)
    assert [e for e in _events(port_store)] == [{
        "namespace": "ns1", "involvedObject": "TPUJob/job-a",
        "reason": "Created", "message": "made it", "type": "Normal"}]


def test_fake_kube_test_hooks_match_jax():
    stores = [jax_kube.FakeKube(), kube.FakeKube()]
    for store in stores:
        store.create_pod(_pod("ns1", "p"))
        store.set_pod_phase("ns1", "p", kube.RUNNING)
        store.set_pod_node("ns1", "p", "node-7")
        store.nodes.append({"metadata": {"name": "node-7"}})
    assert stores[1].pods == stores[0].pods
    assert stores[1].list_nodes() == stores[0].list_nodes()
    assert (kube.PENDING, kube.RUNNING, kube.SUCCEEDED, kube.FAILED) == (
        jax_kube.PENDING, jax_kube.RUNNING, jax_kube.SUCCEEDED,
        jax_kube.FAILED)


@pytest.fixture()
def servers():
    """Both packages' fake apiservers on localhost, shut on exit."""
    started = {}
    try:
        for name, (_, _, apiserver, _) in PACKAGES.items():
            started[name] = apiserver.make_fake_apiserver()
        yield started
    finally:
        for httpd, _, _ in started.values():
            httpd.shutdown()
            httpd.server_close()


def _client(pkg, httpd, **kw):
    kw.setdefault("retry_backoff_s", 0.002)
    return PACKAGES[pkg][1].HttpKube(
        base_url=f"http://127.0.0.1:{httpd.server_address[1]}", **kw)


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_http_kube_sequence_matches_jax_over_the_wire(
        servers, client_pkg, server_pkg):
    """The port's HttpKube against the port's apiserver, and each
    package's client against the other's server, give the answers JAX's
    client gives against JAX's server, and leave the same store; the
    typed errors (NotFound, Conflict) come back as each client's own."""
    want_httpd, _, want_store = servers["jax"]
    jax_client = _client("jax", want_httpd)
    want = _strip(_run(jax_client))
    httpd, _, store = servers[server_pkg]
    if server_pkg == "jax":
        # A fresh JAX server: the fixture's was used for the reference.
        httpd, _, store = jax_apiserver.make_fake_apiserver()
    try:
        got = _strip(_run(_client(client_pkg, httpd)))
        assert got == want
        for attr in ("pods", "services", "deployments", "custom"):
            assert getattr(store, attr) == getattr(want_store, attr), attr
        assert [{k: v for k, v in e.items() if k != "ts"}
                for e in store.events] == _events(want_store)
    finally:
        if server_pkg == "jax":
            httpd.shutdown()
            httpd.server_close()


def test_http_kube_label_selector_and_pod_discovery(servers):
    httpd, _, store = servers["port"]
    client = _client("port", httpd)
    for name, labels in (("a", {"app": "x", "tier": "1"}),
                         ("b", {"app": "x", "tier": "2"}),
                         ("c", {"app": "y"})):
        store.create_pod(_pod("ns1", name, labels))
    names = [p["metadata"]["name"] for p in client.list_pods(
        "ns1", {"tier": "2", "app": "x"})]
    assert names == ["b"]
    assert client._selector({"b": "2", "a": "1"}) == {
        "labelSelector": "a=1,b=2"}


@pytest.mark.parametrize("code", [503, 429, (503, "0.001")])
def test_http_kube_retries_weather_like_jax(servers, code):
    """5xx and 429 are weather for GETs and PATCHes on both clients (one
    injected failure, then success); a POST is never retried."""
    for pkg in ("jax", "port"):
        httpd, _, store = servers[pkg]
        client = _client(pkg, httpd, retries=2)
        store.create_pod(_pod("ns1", f"p-{pkg}"))
        httpd.fail_queue.append(code)
        assert [p["metadata"]["name"] for p in client.list_pods("ns1")] \
            == [f"p-{pkg}"]
        assert httpd.fail_queue == []
        httpd.fail_queue.append(code)
        with pytest.raises(RuntimeError, match="injected failure"):
            client.create_pod(_pod("ns1", f"q-{pkg}"))
        assert ("ns1", f"q-{pkg}") not in store.pods


def test_http_kube_retry_after_overrides_and_is_capped(servers,
                                                       monkeypatch):
    """The server's Retry-After sets the backoff (jittered up to +10%),
    capped by ``retry_backoff_cap_s``; without a hint the local
    schedule holds; semantic 4xx are never retried."""
    sleeps = []

    class _Time:
        def __init__(self, real):
            self._real = real

        def sleep(self, s):
            sleeps.append(s)

        def __getattr__(self, name):
            return getattr(self._real, name)

    monkeypatch.setattr(kube_http, "time", _Time(kube_http.time))
    httpd, _, store = servers["port"]
    store.create_pod(_pod("ns1", "p0"))
    client = _client("port", httpd, retry_backoff_s=0.001,
                     retry_backoff_cap_s=10.0)
    httpd.fail_queue.append((503, "2.5"))
    client.list_pods("ns1")
    assert len(sleeps) == 1 and 2.5 <= sleeps[0] <= 2.75 + 1e-9
    capped = _client("port", httpd, retry_backoff_cap_s=0.05)
    httpd.fail_queue.append((503, "3600"))
    capped.list_pods("ns1")
    assert len(sleeps) == 2 and sleeps[1] <= 0.055 + 1e-9
    httpd.fail_queue.append(503)
    client.list_pods("ns1")
    assert len(sleeps) == 3 and sleeps[2] <= 0.001 + 1e-9
    httpd.fail_queue.append(403)
    with pytest.raises(RuntimeError, match="403"):
        client.list_pods("ns1")
    assert len(sleeps) == 3


def test_kube_request_site_fires_before_the_socket(servers):
    """``kube.request`` fires on every transport attempt of the port's
    client, before the socket: a raise is retried like a refused
    connect, and exhausting the retries raises; JAX's client fires its
    own site on its own injector, so the counts match."""
    counts = {}
    for pkg in ("jax", "port"):
        httpd, _, store = servers[pkg]
        pkg_faults = PACKAGES[pkg][3]
        store.create_pod(_pod("ns1", "p0"))
        client = _client(pkg, httpd, retries=2)
        with pkg_faults.injected("kube.request:raise*2") as inj:
            assert len(client.list_pods("ns1")) == 1
            fired = inj.fired("kube.request")
        with pkg_faults.injected("kube.request:raise*3"):
            with pytest.raises(RuntimeError, match="after 3 attempts"):
                client.list_pods("ns1")
        counts[pkg] = fired
    assert counts == {"jax": 3, "port": 3}


def test_http_kube_needs_a_base_url_outside_a_cluster(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(RuntimeError, match="not in-cluster"):
        kube_http.HttpKube()


class _ApiException(Exception):
    def __init__(self, status):
        super().__init__(str(status))
        self.status = status


def _stub_kubernetes(state):
    """A minimal ``kubernetes`` module over plain dicts: the calls
    RealKube makes, 404/409 as ApiException, and the label selector."""

    def table(name):
        return state.setdefault(name, {})

    def create(name):
        def call(namespace, body):
            key = (namespace, body["metadata"]["name"])
            if key in table(name):
                raise _ApiException(409)
            table(name)[key] = copy.deepcopy(body)
            return body
        return call

    def read(name):
        def call(obj_name, namespace):
            try:
                return table(name)[(namespace, obj_name)]
            except KeyError:
                raise _ApiException(404) from None
        return call

    def delete(name):
        def call(obj_name, namespace):
            if table(name).pop((namespace, obj_name), None) is None:
                raise _ApiException(404)
        return call

    def list_(name):
        def call(namespace, label_selector=None):
            state.setdefault("selectors", []).append(label_selector)
            want = dict(kv.split("=", 1) for kv in
                        (label_selector or "").split(",") if kv)
            return types.SimpleNamespace(items=[
                o for (ns, _), o in table(name).items() if ns == namespace
                and all(o["metadata"].get("labels", {}).get(k) == v
                        for k, v in want.items())])
        return call

    def patch_deployment(obj_name, namespace, body):
        dep = read("deployments")(obj_name, namespace)
        dep.setdefault("spec", {}).update(body["spec"])
        return dep

    def custom(op):
        def call(group, version, *rest):
            assert (group, version) == (crd.GROUP, crd.VERSION)
            state.setdefault("custom_calls", []).append((op, rest))
            if op == "list_cluster":
                assert rest == (crd.PLURAL,)
                return {"items": list(table("custom").values())}
            namespace, plural, *more = rest
            assert plural == crd.PLURAL
            if op == "list":
                return {"items": [o for (ns, _), o in
                                  table("custom").items()
                                  if ns == namespace]}
            key = (namespace, more[0])
            if key not in table("custom"):
                raise _ApiException(404)
            if op == "get":
                return table("custom")[key]
            if op == "status":
                table("custom")[key]["status"] = more[1]["status"]
                return None
            del table("custom")[key]
            return None
        return call

    core = types.SimpleNamespace(
        api_client=types.SimpleNamespace(
            sanitize_for_serialization=lambda o: o),
        create_namespaced_pod=create("pods"),
        read_namespaced_pod=read("pods"),
        delete_namespaced_pod=delete("pods"),
        list_namespaced_pod=list_("pods"),
        list_node=lambda: types.SimpleNamespace(items=[{"n": 1}]),
        create_namespaced_service=create("services"),
        delete_namespaced_service=delete("services"),
        create_namespaced_event=lambda ns, ev: state.setdefault(
            "events", []).append((ns, ev)))
    apps = types.SimpleNamespace(
        create_namespaced_deployment=create("deployments"),
        read_namespaced_deployment=read("deployments"),
        list_namespaced_deployment=list_("deployments"),
        patch_namespaced_deployment=patch_deployment)
    objects = types.SimpleNamespace(
        list_namespaced_custom_object=custom("list"),
        list_cluster_custom_object=custom("list_cluster"),
        get_namespaced_custom_object=custom("get"),
        patch_namespaced_custom_object_status=custom("status"),
        delete_namespaced_custom_object=custom("delete"))

    def load_incluster_config():
        raise RuntimeError("not in a cluster")

    mod = types.ModuleType("kubernetes")
    mod.config = types.SimpleNamespace(
        load_incluster_config=load_incluster_config,
        load_kube_config=lambda config_file=None: state.update(
            kubeconfig=config_file))
    mod.client = types.SimpleNamespace(
        CoreV1Api=lambda: core, AppsV1Api=lambda: apps,
        CustomObjectsApi=lambda: objects,
        rest=types.SimpleNamespace(ApiException=_ApiException))
    return mod


def test_real_kube_over_a_stub_client(monkeypatch):
    state = {}
    monkeypatch.setitem(sys.modules, "kubernetes", _stub_kubernetes(state))
    rk = kube_real.RealKube(kubeconfig="/tmp/kc")
    assert state["kubeconfig"] == "/tmp/kc"
    rk.create_pod(_pod("ns1", "a", {"app": "x", "tier": "1"}))
    rk.create_pod(_pod("ns1", "b", {"app": "y"}))
    with pytest.raises(kube.Conflict):
        rk.create_pod(_pod("ns1", "a"))
    assert rk.get_pod("ns1", "a")["metadata"]["name"] == "a"
    with pytest.raises(kube.NotFound):
        rk.get_pod("ns1", "ghost")
    assert [p["metadata"]["name"] for p in rk.list_pods(
        "ns1", {"app": "x", "tier": "1"})] == ["a"]
    assert state["selectors"][-1] == "app=x,tier=1"
    rk.delete_pod("ns1", "b")
    with pytest.raises(kube.NotFound):
        rk.delete_pod("ns1", "b")
    assert rk.list_nodes() == [{"n": 1}]
    rk.create_service({"metadata": {"namespace": "ns1", "name": "s"}})
    rk.delete_service("ns1", "s")
    rk.create_deployment({"metadata": {"namespace": "ns1", "name": "d"},
                          "spec": {"replicas": 1}})
    assert rk.patch_deployment_scale("ns1", "d", 4)["spec"]["replicas"] == 4
    assert rk.get_deployment("ns1", "d")["spec"]["replicas"] == 4
    assert len(rk.list_deployments("ns1")) == 1
    state["custom"] = {("ns1", "j"): _cr("j")}
    assert [o["metadata"]["name"] for o in rk.list_custom("ns1")] == ["j"]
    assert len(rk.list_custom()) == 1
    rk.update_custom_status("ns1", "j", {"phase": "Running"})
    assert rk.get_custom("ns1", "j")["status"] == {"phase": "Running"}
    rk.delete_custom("ns1", "j")
    with pytest.raises(kube.NotFound):
        rk.get_custom("ns1", "j")
    rk.record_event("ns1", "TPUJob/j", "Created", "ok")
    ns, event = state["events"][0]
    assert ns == "ns1" and event["involvedObject"] == {
        "kind": "TPUJob", "name": "j", "namespace": "ns1"}


def test_real_kube_without_the_client_raises_import_error(monkeypatch):
    """As in the JAX package: no ``kubernetes`` client installed is an
    ImportError at construction, not at import."""
    monkeypatch.setitem(sys.modules, "kubernetes", None)
    with pytest.raises(ImportError):
        kube_real.RealKube()


@pytest.mark.parametrize("shape", ["cpu-1", "cpu-2", "cpu-4", "cpu-8"])
def test_crd_wire_format_matches_jax_on_cpu_shapes(shape):
    kwargs = dict(name="job", namespace="ns1", slice_type=shape,
                  num_slices=2, queue="q",
                  mesh_kw={"data": -1, "fsdp": 2 if shape != "cpu-1"
                           else 1})
    made = []
    for mod in (jax_crd, crd):
        mesh_kw = kwargs["mesh_kw"]
        spec = mod.TPUJobSpec(
            name=kwargs["name"], namespace=kwargs["namespace"],
            slice_type=shape, num_slices=2, queue="q",
            mesh=mod.MeshSpec(**mesh_kw),
            worker=mod.WorkerSpec(image="img", args=["--x"],
                                  env={"A": "1"}),
            storage=mod.StorageSpec(kind="nfs", nfs_claim="c"))
        made.append(spec)
    jax_cr, port_cr = (s.to_custom_resource() for s in made)
    assert port_cr == jax_cr
    assert (made[1].num_workers, made[1].num_devices) == (
        made[0].num_workers, made[0].num_devices)
    back = crd.TPUJobSpec.from_custom_resource(jax_cr)
    assert back.to_custom_resource() == jax_cr
    assert jax_crd.TPUJobSpec.from_custom_resource(
        port_cr).to_custom_resource() == port_cr


@pytest.mark.parametrize("shape,hosts,chips", [
    ("h100-1", 1, 1), ("h100-8", 1, 8), ("h100-16", 2, 16),
    ("a3-highgpu-4g", 1, 4), ("h100-4x8", 4, 32)])
def test_crd_h100_shapes_derive_hosts_and_chips(shape, hosts, chips):
    spec = crd.TPUJobSpec(name="j", slice_type=shape, num_slices=2)
    assert spec.topology.hosts == hosts and spec.topology.chips == chips
    assert (spec.num_workers, spec.num_devices) == (2 * hosts, 2 * chips)
    assert spec.mesh.resolve(spec.num_devices)["data"] == 2 * chips
    cr = spec.to_custom_resource()
    assert cr["apiVersion"] == f"{jax_crd.GROUP}/{jax_crd.VERSION}"
    assert cr["kind"] == jax_crd.KIND
    assert crd.TPUJobSpec.from_custom_resource(cr) == spec


def test_crd_refuses_a_tpu_shape_and_a_mesh_mismatch():
    with pytest.raises(ValueError, match="unknown slice type"):
        crd.TPUJobSpec(name="j", slice_type="v5e-8")
    with pytest.raises(crd.SpecError, match="devices"):
        crd.TPUJobSpec(name="j", slice_type="h100-8",
                       mesh=crd.MeshSpec(data=3))
    with pytest.raises(crd.SpecError, match="unknown field"):
        crd.WorkerSpec.from_dict({"imagee": "x"})
    assert (crd.GROUP, crd.VERSION, crd.KIND, crd.PLURAL) == (
        jax_crd.GROUP, jax_crd.VERSION, jax_crd.KIND, jax_crd.PLURAL)


def test_crd_folds_tfjob_replicas_like_jax():
    cr = {"metadata": {"name": "legacy", "namespace": "ns1"},
          "spec": {"sliceType": "cpu-2", "replicaSpecs": [
              {"tfReplicaType": "PS", "replicas": 2},
              {"tfReplicaType": "MASTER", "template": {"spec": {
                  "containers": [{"image": "master", "args": ["m"]}]}}},
              {"tfReplicaType": "WORKER", "template": {"spec": {
                  "containers": [{"image": "worker", "command": ["py"],
                                  "env": [{"name": "K", "value": "v"}]}]}}},
          ]}}
    port = crd.TPUJobSpec.from_custom_resource(cr)
    assert port.to_custom_resource() == \
        jax_crd.TPUJobSpec.from_custom_resource(cr).to_custom_resource()
    assert port.worker.image == "worker" and port.worker.env == {"K": "v"}
    bad = copy.deepcopy(cr)
    bad["spec"]["replicaSpecs"] = [{"tfReplicaType": "EVALUATOR"}]
    with pytest.raises(crd.SpecError, match="unknown replica type"):
        crd.TPUJobSpec.from_custom_resource(bad)
