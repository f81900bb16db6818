"""gRPC PredictionService — the reference's primary serving wire contract.
The port's copy of kubeflow_tpu/serving/grpc_server.py.

The reference exposed C++ TF-Serving's gRPC PredictionService on :9000
(kubeflow/tf-serving/tf-serving.libsonnet:118-132) with the REST proxy in
front; here the same split: serving/http.py is the REST face, this module
the gRPC face, both over one ModelServer.

Service stubs are hand-rolled with grpc's generic-handler API (the image
has protoc for messages but no grpc codegen plugin); the method table
mirrors protos/prediction.proto.
"""

from __future__ import annotations

import json
import logging
from concurrent import futures
from typing import Optional

import grpc
import numpy as np

from kubeflow_tpu_torch.runtime import tracing
from kubeflow_tpu_torch.serving.errors import DeadlineExceeded, Overloaded
from kubeflow_tpu_torch.serving.model_server import ModelServer
from kubeflow_tpu_torch.serving.protos import prediction_pb2 as pb
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)


def _deadline_from(context: grpc.ServicerContext):
    """Client-supplied gRPC deadline -> the absolute policy-clock
    instant the batching planes enforce.  gRPC carries deadlines in the
    transport (grpc-timeout header), so unlike REST no body field is
    needed — whatever deadline the client set on the call propagates
    into queues and the engine's mid-generation sweep."""
    remaining = context.time_remaining()
    if remaining is None:
        return None
    return faults.monotonic() + remaining

SERVICE = "kft.serving.PredictionService"
GRPC_PORT = 9000  # same port the reference's model server bound

# Idempotency key metadata (the gRPC analogue of the REST header):
# retried calls carrying the same key are answered from the model
# server's dedup cache instead of re-executing (docs §5.6).
IDEMPOTENCY_METADATA = "x-kft-idempotency-key"


def _idem_key_from(context: grpc.ServicerContext):
    for key, value in (context.invocation_metadata() or ()):
        if key == IDEMPOTENCY_METADATA:
            return value
    return None

# grpc.health.v1 readiness parity (the standard Health service wire
# contract, hand-rolled like the rest of this module — the image has no
# grpc_health codegen).  Check mirrors /readyz: SERVING while models
# are loaded and the server is not draining, NOT_SERVING during a
# SIGTERM drain — so the fleet router can probe gRPC-only replicas with
# any stock health checker.  The answer is server-wide (one serving
# process = one readiness), whatever ``service`` name the request asks
# about; mirroring /readyz exactly is the point.
HEALTH_SERVICE = "grpc.health.v1.Health"
HEALTH_SERVING = 1      # HealthCheckResponse.ServingStatus.SERVING
HEALTH_NOT_SERVING = 2  # HealthCheckResponse.ServingStatus.NOT_SERVING


def _health_response(status: int) -> bytes:
    """Serialize HealthCheckResponse{status}: field 1 varint (single
    byte for the two statuses this server emits)."""
    return bytes([0x08, status])


def _health_status(data: bytes) -> int:
    """Parse HealthCheckResponse bytes back to the status enum (client
    side of the same hand-rolled contract)."""
    if len(data) >= 2 and data[0] == 0x08:
        return data[1]
    return 0  # UNKNOWN (empty message = all defaults)


def tensor_to_numpy(t: pb.Tensor) -> np.ndarray:
    # A writable copy: ``np.frombuffer`` views the immutable protobuf
    # bytes, and ``torch.from_numpy`` of read-only memory (the loaders'
    # host staging) is undefined behaviour in torch.
    return np.frombuffer(t.data, dtype=np.dtype(t.dtype)).reshape(
        tuple(t.shape)).copy()


def numpy_to_tensor(arr: np.ndarray) -> pb.Tensor:
    arr = np.ascontiguousarray(arr)
    return pb.Tensor(dtype=str(arr.dtype), shape=list(arr.shape),
                     data=arr.tobytes())


class PredictionServicer:
    def __init__(self, server: ModelServer):
        self.server = server

    def _resolve(self, spec: pb.ModelSpec):
        version = spec.version if spec.version > 0 else None
        return self.server.get(spec.name, version)

    def Predict(self, request: pb.PredictRequest,
                context: grpc.ServicerContext) -> pb.PredictResponse:
        model = self._resolve(request.model_spec)
        inputs = {k: tensor_to_numpy(t) for k, t in request.inputs.items()}
        # Through ModelServer.predict (not model.predict) so request
        # batching (enable_batching) applies to gRPC traffic exactly as
        # it does to REST.
        version = request.model_spec.version \
            if request.model_spec.version > 0 else None
        outputs = self.server.predict(model.name, inputs, version,
                                      deadline=_deadline_from(context),
                                      idem_key=_idem_key_from(context))
        resp = pb.PredictResponse()
        resp.model_spec.name = model.name
        resp.model_spec.version = model.version
        for key, value in outputs.items():
            resp.outputs[key].CopyFrom(numpy_to_tensor(np.asarray(value)))
        return resp

    def Classify(self, request: pb.ClassifyRequest,
                 context: grpc.ServicerContext) -> pb.ClassifyResponse:
        model = self._resolve(request.model_spec)
        inputs = {k: tensor_to_numpy(t) for k, t in request.inputs.items()}
        version = request.model_spec.version \
            if request.model_spec.version > 0 else None
        outputs = {k: np.asarray(v) for k, v in
                   self.server.predict(
                       model.name, inputs, version,
                       deadline=_deadline_from(context),
                       idem_key=_idem_key_from(context)).items()}
        resp = pb.ClassifyResponse()
        resp.model_spec.name = model.name
        resp.model_spec.version = model.version
        if "top_k_classes" in outputs:
            classes, scores = outputs["top_k_classes"], outputs["top_k_scores"]
        else:
            scores = outputs["scores"]
            k = request.top_k or scores.shape[-1]
            idx = np.argsort(-scores, axis=-1)[:, :k]
            classes = idx
            scores = np.take_along_axis(scores, idx, axis=-1)
        for row_c, row_s in zip(classes, scores):
            result = resp.results.add()
            result.classes.extend(str(c) for c in row_c)
            result.scores.extend(float(s) for s in row_s)
        return resp

    def GetModelMetadata(
        self, request: pb.GetModelMetadataRequest,
        context: grpc.ServicerContext,
    ) -> pb.GetModelMetadataResponse:
        model = self._resolve(request.model_spec)
        resp = pb.GetModelMetadataResponse()
        resp.model_spec.name = model.name
        resp.model_spec.version = model.version
        meta = dict(model.meta)
        # Live batching-plane stats ride the metadata face (the REST
        # side serves the same snapshot on /model/<name>:stats) — gRPC
        # clients monitoring engine occupancy need no extra RPC.
        batcher_stats = self.server.batcher_stats(model.name)
        if batcher_stats is not None:
            meta["batcher_stats"] = batcher_stats
        resp.metadata_json = json.dumps(meta)
        return resp


_METHODS = {
    "Predict": (pb.PredictRequest, pb.PredictResponse),
    "Classify": (pb.ClassifyRequest, pb.ClassifyResponse),
    "GetModelMetadata": (pb.GetModelMetadataRequest,
                         pb.GetModelMetadataResponse),
}


def _wrap(servicer: PredictionServicer, name: str):
    method = getattr(servicer, name)
    route = f"grpc_{name.lower()}"

    def handler(request, context):
        # Every method counted + timed centrally (the REST face records
        # the same series); only KNOWN model names become label values —
        # client-supplied names must not grow /metrics series.
        import time as _time

        from kubeflow_tpu_torch.runtime.prom import REGISTRY
        from kubeflow_tpu_torch.serving.model_server import (
            LATENCY_HELP,
            LATENCY_SECONDS,
            REQUESTS_HELP,
            REQUESTS_TOTAL,
        )

        spec_name = request.model_spec.name
        model_label = spec_name \
            if servicer.server.has_model(spec_name) else "_unknown_"
        # gRPC carries trace context in invocation metadata (the
        # transport's header analogue); the server span mirrors the
        # REST face's and feeds the same tail-sampled store.
        parent = None
        if tracing.enabled():
            parent = tracing.extract(
                dict(context.invocation_metadata() or ()))
        span = tracing.start_span(
            f"server.{route}", parent=parent,
            attrs={"model": model_label, "transport": "grpc"})
        # `outcome` keeps the metric vocabulary; `span_status` names
        # client faults so a 404/400 answer samples like ok traffic
        # instead of riding tail sampling's always-keep error tier.
        outcome = span_status = "error"
        t0 = _time.perf_counter()
        try:
            with tracing.use_span(span):
                resp = method(request, context)
            outcome = span_status = "ok"
            return resp
        except KeyError as e:
            span_status = "not_found"
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except ValueError as e:
            span_status = "invalid_argument"
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except Overloaded as e:
            # Same status pair as the REST face's 429/504: one failure
            # semantics across transports.  The Retry-After hint rides
            # STRUCTURED trailing metadata (the gRPC analogue of the
            # REST header) — clients must not parse prose.
            outcome = span_status = "shed"
            context.set_trailing_metadata(
                (("retry-after", f"{e.retry_after_s}"),))
            context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"{e} (retry after {e.retry_after_s:.1f}s)")
        except DeadlineExceeded as e:
            outcome = span_status = "deadline_exceeded"
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        finally:
            REGISTRY.counter(REQUESTS_TOTAL, REQUESTS_HELP).inc(
                model=model_label, route=route, outcome=outcome)
            REGISTRY.histogram(
                LATENCY_SECONDS, LATENCY_HELP,
            ).observe(_time.perf_counter() - t0, route=route)
            span.end(status=span_status)

    return handler


def make_grpc_server(
    model_server: ModelServer,
    port: int = GRPC_PORT,
    host: str = "0.0.0.0",
    max_workers: int = 8,
) -> grpc.Server:
    """Build + start the gRPC server; returns it (call .stop() to halt).
    Pass port=0 for an ephemeral port (read it from .bound_port)."""
    servicer = PredictionServicer(model_server)
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            _wrap(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
        for name, (req, resp) in _METHODS.items()
    }
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE, handlers),))
    # Standard health face (readiness parity with /readyz): raw-bytes
    # serializers — the request's optional ``service`` field is
    # irrelevant to a server-wide answer, so no message parse at all.
    def health_check(request: bytes, context) -> bytes:
        return _health_response(
            HEALTH_SERVING if model_server.is_ready()
            else HEALTH_NOT_SERVING)

    health_handlers = {
        "Check": grpc.unary_unary_rpc_method_handler(
            health_check,
            request_deserializer=bytes,
            response_serializer=bytes,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(HEALTH_SERVICE,
                                              health_handlers),))
    # TF-Serving compat face on the SAME port: reference-era clients
    # address /tensorflow.serving.PredictionService/Predict with TF
    # TensorProto payloads and run unchanged (serving/tf_compat.py).
    from kubeflow_tpu_torch.serving import tf_compat
    from kubeflow_tpu_torch.serving.protos import tf_compat_pb2

    tf_servicer = tf_compat.TFPredictServicer(model_server)
    tf_handlers = {
        "Predict": grpc.unary_unary_rpc_method_handler(
            _wrap(tf_servicer, "Predict"),
            request_deserializer=tf_compat_pb2.PredictRequest.FromString,
            response_serializer=(
                tf_compat_pb2.PredictResponse.SerializeToString),
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(
            tf_compat.TF_SERVICE, tf_handlers),))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.bound_port = bound
    server.start()
    log.info("gRPC PredictionService on :%d (+ tf-serving compat)", bound)
    return server


def retry_call(fn, *, retries: int = 2, backoff_s: float = 0.05,
               backoff_cap_s: float = 2.0, rng=None,
               sleep=None):
    """Bounded client-side retry for idempotent calls to a serving
    replica (``fn`` is a zero-arg closure over one PredictionClient
    method call).

    Backoff honors the SERVER's hint first: an ``Overloaded`` carries
    the Retry-After the server attached (trailing metadata -> the typed
    ``retry_after_s`` field), and that number — the server's own
    estimate of when it will have room — overrides the local jittered
    exponential schedule, capped at ``backoff_cap_s`` so a confused
    server cannot park the client.  Transport UNAVAILABLE (replica
    restarting) falls back to the local schedule.  DeadlineExceeded and
    semantic errors never retry: the deadline is spent, and answers are
    answers."""
    import random as _random
    import time as _time

    rng = rng or _random.Random()
    sleep = sleep or _time.sleep
    attempt = 0
    while True:
        try:
            return fn()
        except Overloaded as e:
            if attempt >= retries:
                raise
            hint = getattr(e, "retry_after_s", None)
            if hint is not None:
                delay = min(backoff_cap_s, max(0.0, float(hint)))
                delay *= 1.0 + 0.1 * rng.random()
            else:
                delay = min(backoff_cap_s, backoff_s * (2 ** attempt))
                delay *= 0.5 + 0.5 * rng.random()
            sleep(delay)
            attempt += 1
        except grpc.RpcError as e:
            code = e.code() if callable(getattr(e, "code", None)) else None
            if code != grpc.StatusCode.UNAVAILABLE or attempt >= retries:
                raise
            delay = min(backoff_cap_s, backoff_s * (2 ** attempt))
            sleep(delay * (0.5 + 0.5 * rng.random()))
            attempt += 1


class PredictionClient:
    """Minimal client — heir of inception-client/label.py:40-57.

    ``timeout`` is the CLIENT-SUPPLIED deadline, in seconds, propagated
    on the wire (gRPC grpc-timeout): the server enforces it in its
    queues and — for the decode engine — mid-generation, so the default
    is None (no deadline) rather than an arbitrary hard-coded number;
    pass what your caller can actually afford.  Transport-level
    deadline/overload statuses come back as the typed serving errors
    (DeadlineExceeded / Overloaded), matching what in-process callers
    of ModelServer.predict see."""

    def __init__(self, target: str):
        self._channel = grpc.insecure_channel(target)
        self._methods = {
            name: self._channel.unary_unary(
                f"/{SERVICE}/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            )
            for name, (req, resp) in _METHODS.items()
        }

    def _call(self, name: str, req, timeout: Optional[float],
              idem_key: Optional[str] = None):
        metadata = ((IDEMPOTENCY_METADATA, idem_key),) \
            if idem_key else None
        try:
            return self._methods[name](req, timeout=timeout,
                                       metadata=metadata)
        except grpc.RpcError as e:
            code = e.code() if callable(getattr(e, "code", None)) else None
            details = e.details() if callable(
                getattr(e, "details", None)) else str(e)
            if code == grpc.StatusCode.DEADLINE_EXCEEDED:
                # Covers both: the server's typed expiry AND a pure
                # transport timeout (request never completed in time).
                raise DeadlineExceeded(f"{name}: {details}") from e
            if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                # Recover the server's Retry-After hint from the
                # trailing metadata _wrap attaches (falling back to the
                # 1.0 s default against servers that sent none) so
                # clients backing off via the typed field honor the
                # server's number.
                retry_after = 1.0
                trailing = getattr(e, "trailing_metadata", None)
                for key, value in (trailing() if callable(trailing)
                                   else None) or ():
                    if key == "retry-after":
                        try:
                            retry_after = float(value)
                        except ValueError:
                            pass
                raise Overloaded(
                    f"{name}: {details}", retry_after_s=retry_after,
                ) from e
            raise

    def predict(self, model: str, inputs: dict,
                version: int = 0, timeout: Optional[float] = None,
                idem_key: Optional[str] = None):
        """``idem_key`` rides the x-kft-idempotency-key metadata: a
        retry with the same key is answered from the server's dedup
        cache (attached in flight / cached result), never re-run."""
        req = pb.PredictRequest()
        req.model_spec.name = model
        req.model_spec.version = version
        for key, value in inputs.items():
            req.inputs[key].CopyFrom(numpy_to_tensor(np.asarray(value)))
        resp = self._call("Predict", req, timeout, idem_key=idem_key)
        return {k: tensor_to_numpy(t) for k, t in resp.outputs.items()}

    def classify(self, model: str, inputs: dict, top_k: int = 5,
                 timeout: Optional[float] = None):
        req = pb.ClassifyRequest(top_k=top_k)
        req.model_spec.name = model
        for key, value in inputs.items():
            req.inputs[key].CopyFrom(numpy_to_tensor(np.asarray(value)))
        resp = self._call("Classify", req, timeout)
        return [list(zip(r.classes, r.scores)) for r in resp.results]

    def metadata(self, model: str,
                 timeout: Optional[float] = None) -> dict:
        req = pb.GetModelMetadataRequest()
        req.model_spec.name = model
        resp = self._call("GetModelMetadata", req, timeout)
        return json.loads(resp.metadata_json)

    def ready(self, timeout: Optional[float] = 5.0) -> bool:
        """grpc.health.v1 Check against this channel: True iff the
        server answers SERVING (mirrors GET /readyz == 200).  Transport
        errors are False, not raised — a probe's job is a verdict."""
        method = self._channel.unary_unary(
            f"/{HEALTH_SERVICE}/Check",
            request_serializer=bytes,
            response_deserializer=bytes)
        try:
            return _health_status(method(b"", timeout=timeout)) \
                == HEALTH_SERVING
        except grpc.RpcError:
            return False

    def close(self) -> None:
        self._channel.close()


def check_health(target: str, timeout: Optional[float] = 5.0) -> bool:
    """One-shot grpc.health.v1 readiness probe of ``target``
    (host:port) — what the fleet endpoint registry uses for gRPC-only
    replicas; the REST twin is GET /readyz."""
    client = PredictionClient(target)
    try:
        return client.ready(timeout=timeout)
    finally:
        client.close()
