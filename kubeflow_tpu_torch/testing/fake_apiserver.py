"""A real-HTTP Kubernetes API server emulation for hermetic tests (the
port's copy of kubeflow_tpu/testing/fake_apiserver.py).

A ``ThreadingHTTPServer`` that speaks the slice of the Kubernetes REST
contract the control plane uses (pods, services, nodes, deployments and
their scale patch, the TPUJob custom resource + /status merge-patch,
events, label selectors, and the 404/409 error shapes), backed by the
same FakeKube store the unit tests drive directly.  With it,
``operator/kube_http.py`` and the fleet's pod discovery run over real
sockets; the FakeKube store doubles as the test's state handle (flip pod
phases, read events).
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from kubeflow_tpu_torch.operator import crd
from kubeflow_tpu_torch.operator.kube import Conflict, FakeKube, NotFound

_POD = re.compile(r"^/api/v1/namespaces/(?P<ns>[^/]+)/pods(?:/(?P<name>[^/]+))?$")
_SVC = re.compile(
    r"^/api/v1/namespaces/(?P<ns>[^/]+)/services(?:/(?P<name>[^/]+))?$")
_EVT = re.compile(r"^/api/v1/namespaces/(?P<ns>[^/]+)/events$")
_DEP = re.compile(
    r"^/apis/apps/v1/namespaces/(?P<ns>[^/]+)/deployments"
    r"(?:/(?P<name>[^/]+))?$")
_NODES = re.compile(r"^/api/v1/nodes$")
_CR = re.compile(
    rf"^/apis/{re.escape(crd.GROUP)}/{crd.VERSION}"
    r"(?:/namespaces/(?P<ns>[^/]+))?"
    rf"/{crd.PLURAL}(?:/(?P<name>[^/]+))?(?P<status>/status)?$")


def _parse_selector(qs: str) -> Optional[dict]:
    params = urllib.parse.parse_qs(qs)
    sel = params.get("labelSelector", [""])[0]
    if not sel:
        return None
    out = {}
    for clause in sel.split(","):
        k, _, v = clause.partition("=")
        out[k] = v
    return out


class _Handler(BaseHTTPRequestHandler):
    kube: FakeKube  # set by make_fake_apiserver
    fail_queue: list  # injected failure codes; set by make_fake_apiserver

    def log_message(self, fmt, *args):
        pass

    # -- plumbing ---------------------------------------------------------

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n)) if n else {}

    def _send(self, code: int, payload=None, headers=None) -> None:
        data = json.dumps(payload if payload is not None else {}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _dispatch(self, method: str) -> None:
        # Injected-failure queue (httpd.fail_queue): each entry is an
        # HTTP status code — or a (code, retry_after_s) pair, served
        # with a Retry-After header — handed verbatim to one request,
        # before any routing; how the retry layer in
        # operator/kube_http.py is integration-tested against real
        # 5xx/429 weather (and its backoff-hint honoring) over sockets.
        if self.fail_queue:
            try:
                code = self.fail_queue.pop(0)
            except IndexError:
                code = None  # raced another handler thread; serve real
            if code is not None:
                headers = None
                if isinstance(code, tuple):
                    code, retry_after = code
                    headers = {"Retry-After": str(retry_after)}
                self._send(int(code), {
                    "kind": "Status", "code": int(code),
                    "message": "injected failure"}, headers=headers)
                return
        path, _, qs = self.path.partition("?")
        try:
            handled = self._route(method, path, qs)
        except NotFound as e:
            self._send(404, {"kind": "Status", "code": 404,
                             "message": str(e)})
            return
        except Conflict as e:
            self._send(409, {"kind": "Status", "code": 409,
                             "message": str(e)})
            return
        if not handled:
            self._send(404, {"kind": "Status", "code": 404,
                             "message": f"no route {method} {path}"})

    # -- routes -----------------------------------------------------------

    def _route(self, method: str, path: str, qs: str) -> bool:
        kube = self.kube

        m = _NODES.match(path)
        if m and method == "GET":
            self._send(200, {"items": kube.list_nodes()})
            return True

        m = _EVT.match(path)
        if m and method == "POST":
            body = self._body()
            kube.record_event(
                m["ns"],
                f"{body.get('involvedObject', {}).get('kind', '?')}/"
                f"{body.get('involvedObject', {}).get('name', '?')}",
                body.get("reason", ""), body.get("message", ""),
                body.get("type", "Normal"))
            self._send(201, body)
            return True

        m = _POD.match(path)
        if m:
            ns, name = m["ns"], m["name"]
            if method == "POST" and not name:
                self._send(201, kube.create_pod(self._body()))
                return True
            if method == "GET" and name:
                self._send(200, kube.get_pod(ns, name))
                return True
            if method == "GET":
                self._send(200, {"items": kube.list_pods(
                    ns, _parse_selector(qs))})
                return True
            if method == "DELETE" and name:
                kube.delete_pod(ns, name)
                self._send(200)
                return True

        m = _SVC.match(path)
        if m:
            ns, name = m["ns"], m["name"]
            if method == "POST" and not name:
                self._send(201, kube.create_service(self._body()))
                return True
            if method == "DELETE" and name:
                kube.delete_service(ns, name)
                self._send(200)
                return True

        m = _DEP.match(path)
        if m:
            ns, name = m["ns"], m["name"]
            if method == "POST" and not name:
                self._send(201, kube.create_deployment(self._body()))
                return True
            if method == "GET" and name:
                self._send(200, kube.get_deployment(ns, name))
                return True
            if method == "GET":
                self._send(200, {"items": kube.list_deployments(
                    ns, _parse_selector(qs))})
                return True
            if method == "PATCH" and name:
                # Scale patches ride the deployment object itself as a
                # merge-patch {"spec": {"replicas": N}} — same content
                # type discipline as the CR /status subresource.
                if self.headers.get("Content-Type") != \
                        "application/merge-patch+json":
                    self._send(415, {"message": "merge-patch required"})
                    return True
                replicas = self._body().get("spec", {}).get("replicas")
                if replicas is None:
                    self._send(422, {"message": "spec.replicas required"})
                    return True
                self._send(200, kube.patch_deployment_scale(
                    ns, name, int(replicas)))
                return True

        m = _CR.match(path)
        if m:
            ns, name, status = m["ns"], m["name"], m["status"]
            if method == "POST" and not name:
                self._send(201, kube.create_custom(self._body()))
                return True
            if method == "GET" and name and not status:
                self._send(200, kube.get_custom(ns, name))
                return True
            if method == "GET" and not name:
                self._send(200, {"items": kube.list_custom(ns)})
                return True
            if method == "PATCH" and name and status:
                if self.headers.get("Content-Type") != \
                        "application/merge-patch+json":
                    self._send(415, {"message": "merge-patch required"})
                    return True
                kube.update_custom_status(
                    ns, name, self._body().get("status", {}))
                self._send(200)
                return True
            if method == "DELETE" and name and not status:
                # Existence check through the store's own locked
                # accessor (raises NotFound): iterating kube.custom here
                # would race concurrent handler threads.
                kube.get_custom(ns, name)
                kube.delete_custom(ns, name)
                self._send(200)
                return True
        return False

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_PATCH(self):
        self._dispatch("PATCH")

    def do_DELETE(self):
        self._dispatch("DELETE")


def make_fake_apiserver(
    kube: Optional[FakeKube] = None, port: int = 0,
) -> Tuple[ThreadingHTTPServer, threading.Thread, FakeKube]:
    """Start the emulated API server on localhost.

    Returns (httpd, thread, store): ``store`` is the backing FakeKube —
    drive pod phases / read events through it while clients talk HTTP.
    ``httpd.fail_queue`` is the injected-failure queue: append HTTP
    status codes and the server serves each to exactly one upcoming
    request (any route) before handling resumes — apiserver weather on
    demand for retry/backoff tests.
    """
    store = kube or FakeKube()

    class Handler(_Handler):
        pass

    Handler.kube = store
    Handler.fail_queue = []
    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    httpd.fail_queue = Handler.fail_queue
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="fake-apiserver")
    thread.start()
    return httpd, thread, store
