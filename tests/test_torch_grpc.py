"""The port's gRPC face (serving/grpc_server.py, serving/tf_compat.py,
``--grpc_port`` of serving/main.py) against the JAX package's.

Twins of tests/test_serving.py ``TestGRPC`` and
``TestRetryCallHonorsServerHint``, of tests/test_tf_compat.py (whose
payloads come from tensorflow, absent here: the twins build the same
TensorProto encodings by hand and hold the port's converters to the JAX
package's on the same bytes) and of the gRPC test of
tests/test_serving_process.py, plus one test that serves the same
exports from both packages' ``make_grpc_server`` and compares answers,
status codes and metric and span names.

Two JAX exports: a narrow ResNet-18 under the ``classifier`` loader
("tiny", bfloat16 in both packages, so its scores are held at the
classifier twin's 5e-3 with the top class equal) and a float32 LM under
the ``lm`` loader ("lm", logits within 1e-5 of JAX's).
"""

import io
import json
import os
import random
import re
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import grpc
import jax
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models.resnet import ResNet18 as JaxResNet18
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving import grpc_server as jax_gs
from kubeflow_tpu.serving import tf_compat as jax_tf_compat
from kubeflow_tpu.serving.export import export as jax_export
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu.serving.model_server import ModelServer as JaxModelServer
from kubeflow_tpu_torch.runtime import prom, tracing
from kubeflow_tpu_torch.runtime.prom import Registry, parse_metrics
from kubeflow_tpu_torch.serving import grpc_server as gs
from kubeflow_tpu_torch.serving import main as serving_main
from kubeflow_tpu_torch.serving import tf_compat
from kubeflow_tpu_torch.serving.errors import DeadlineExceeded, Overloaded
from kubeflow_tpu_torch.serving.model_server import ModelServer
from kubeflow_tpu_torch.serving.protos import tf_compat_pb2 as pb
from test_torch_resnet import random_variables

REPO = Path(__file__).resolve().parents[1]
CLASSES, IMG = 4, 32
CLASSIFIER = "kubeflow_tpu.serving.loaders:classifier"
LM_LOADER = "kubeflow_tpu.serving.loaders:lm"
LM = {"vocab_size": 64, "d_model": 32, "n_layers": 2, "n_heads": 4,
      "n_kv_heads": 2, "d_ff": 64, "head_dim": 8, "max_seq_len": 32,
      "dtype": "float32"}
SCORES_ATOL = 5e-3
LOGITS_ATOL = 1e-5


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{"tiny": ResNet-18 classifier base, "lm": float32 lm base}."""
    root = tmp_path_factory.mktemp("grpc_models")
    variables = random_variables(
        JaxResNet18(num_classes=CLASSES, num_filters=8), (1, IMG, IMG, 3),
        train=False)
    jax_export(root / "tiny", 1, variables, loader=CLASSIFIER,
               config={"family": "resnet18", "num_classes": CLASSES,
                       "top_k": 2, "num_filters": 8},
               signature={"inputs": ["image"],
                          "outputs": ["scores", "top_k_scores",
                                      "top_k_classes"]})
    lm = JaxTransformer(jax_model_config(LM)).init(
        jax.random.key(0), np.zeros((1, 4), np.int32))
    jax_export(root / "lm", 1, jax.tree.map(np.asarray, nn.unbox(lm)),
               loader=LM_LOADER, config=LM,
               signature={"inputs": ["tokens"], "outputs": ["logits"]})
    return {"tiny": root / "tiny", "lm": root / "lm"}


def _port_server(exported, *names):
    srv = ModelServer(device="cpu")
    for name in names or ("tiny",):
        srv.add_model(name, str(exported[name]))
    return srv


def _image(seed=9, n=2):
    return np.random.RandomState(seed).randn(n, IMG, IMG, 3).astype(
        np.float32)


def _tokens(seed=4, shape=(2, 12)):
    return np.random.default_rng(seed).integers(
        0, LM["vocab_size"], shape).astype(np.int32)


def _jpeg(rng, size=IMG):
    from PIL import Image

    img = Image.fromarray(rng.randint(0, 255, (size, size, 3),
                                      dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return buf.getvalue()


def _string_tensor(blobs):
    """A DT_STRING TensorProto as tf.make_tensor_proto(blobs) writes it."""
    t = pb.TensorProto(dtype=tf_compat.DT_STRING, string_val=blobs)
    t.tensor_shape.dim.add(size=len(blobs))
    return t


class TestGRPC:
    def test_predict_classify_metadata_roundtrip(self, exported):
        srv = _port_server(exported)
        server = gs.make_grpc_server(srv, port=0, host="127.0.0.1")
        try:
            client = gs.PredictionClient(f"127.0.0.1:{server.bound_port}")
            img = _image()
            out = client.predict("tiny", {"image": img})
            assert out["scores"].shape == (2, CLASSES)
            np.testing.assert_allclose(out["scores"].sum(-1), 1.0,
                                       atol=1e-3)
            direct = srv.predict("tiny", {"image": img})
            np.testing.assert_array_equal(out["scores"],
                                          np.asarray(direct["scores"]))

            pairs = client.classify("tiny", {"image": img})
            assert len(pairs) == 2 and len(pairs[0]) == 2  # top_k=2

            meta = client.metadata("tiny")
            assert meta["version"] == 1

            with pytest.raises(grpc.RpcError) as err:
                client.predict("missing", {"image": img})
            assert err.value.code() == grpc.StatusCode.NOT_FOUND
            client.close()
        finally:
            server.stop(0)
            srv.stop()

    def test_server_span_continues_client_traceparent(self, exported):
        srv = _port_server(exported)
        server = gs.make_grpc_server(srv, port=0, host="127.0.0.1")
        store = tracing.enable(sample_rate=1.0)
        try:
            channel = grpc.insecure_channel(
                f"127.0.0.1:{server.bound_port}")
            method = channel.unary_unary(
                f"/{gs.SERVICE}/Predict",
                request_serializer=gs.pb.PredictRequest.SerializeToString,
                response_deserializer=gs.pb.PredictResponse.FromString)
            req = gs.pb.PredictRequest()
            req.model_spec.name = "tiny"
            req.inputs["image"].CopyFrom(gs.numpy_to_tensor(_image(n=1)))
            trace_id = tracing.new_trace_id()
            parent_id = tracing.new_span_id()
            header = tracing.format_traceparent(trace_id, parent_id)
            method(req, timeout=60, metadata=(("traceparent", header),))
            channel.close()
            traces = [t for t in store.traces()
                      if t["trace_id"] == trace_id]
            assert len(traces) == 1, store.traces()
            spans = {s["name"]: s for s in traces[0]["spans"]}
            assert spans["server.grpc_predict"]["parent_id"] == parent_id
            assert spans["server.admission"]["parent_id"] \
                == spans["server.grpc_predict"]["span_id"]
        finally:
            tracing.disable()
            server.stop(0)
            srv.stop()

    def test_health_check_mirrors_readyz(self, exported):
        srv = _port_server(exported)
        server = gs.make_grpc_server(srv, port=0, host="127.0.0.1")
        try:
            target = f"127.0.0.1:{server.bound_port}"
            assert gs.check_health(target) is True
            client = gs.PredictionClient(target)
            assert client.ready() is True
            srv.begin_drain()
            assert client.ready() is False
            assert gs.check_health(target) is False
            client.close()
        finally:
            server.stop(0)
            srv.stop()

    def test_health_check_unreachable_is_false_not_raise(self):
        assert gs.check_health("127.0.0.1:1", timeout=0.5) is False


class TestRetryCallHonorsServerHint:
    def test_overloaded_waits_server_retry_after(self):
        sleeps, calls = [], []

        def fn():
            calls.append(1)
            if len(calls) < 3:
                raise Overloaded("full", retry_after_s=2.0)
            return "ok"

        out = gs.retry_call(fn, retries=3, backoff_s=0.001,
                            backoff_cap_s=10.0, rng=random.Random(0),
                            sleep=sleeps.append)
        assert out == "ok" and len(calls) == 3
        assert all(2.0 <= s <= 2.2 + 1e-9 for s in sleeps), sleeps

    def test_hint_capped_and_deadline_never_retried(self):
        sleeps = []

        def overloaded():
            raise Overloaded("full", retry_after_s=3600.0)

        with pytest.raises(Overloaded):
            gs.retry_call(overloaded, retries=1, backoff_cap_s=0.05,
                          rng=random.Random(0), sleep=sleeps.append)
        assert sleeps and sleeps[0] <= 0.055 + 1e-9

        calls = []

        def expired():
            calls.append(1)
            raise DeadlineExceeded("spent")

        with pytest.raises(DeadlineExceeded):
            gs.retry_call(expired, retries=5, sleep=sleeps.append)
        assert len(calls) == 1

    def test_unavailable_retries_on_the_local_schedule(self):
        """A replica restarting (UNAVAILABLE) is retried with the local
        backoff; any other status is an answer, raised at once."""

        class _Rpc(grpc.RpcError):
            def __init__(self, code):
                self._code = code

            def code(self):
                return self._code

        for mod in (gs, jax_gs):
            sleeps, calls = [], []

            def flaky():
                calls.append(1)
                if len(calls) < 2:
                    raise _Rpc(grpc.StatusCode.UNAVAILABLE)
                return "ok"

            assert mod.retry_call(flaky, retries=2, backoff_s=0.01,
                                  rng=random.Random(0),
                                  sleep=sleeps.append) == "ok"
            assert len(sleeps) == 1 and sleeps[0] <= 0.01
            with pytest.raises(grpc.RpcError):
                mod.retry_call(
                    lambda: (_ for _ in ()).throw(
                        _Rpc(grpc.StatusCode.INVALID_ARGUMENT)),
                    retries=3, sleep=sleeps.append)
            assert len(sleeps) == 1


# -- TF-Serving compat: the converters on the encodings clients emit ------

ARRAYS = [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.arange(6, dtype=np.int64).reshape(2, 3),
    (np.arange(24) % 255).astype(np.uint8).reshape(2, 3, 4),
    np.asarray([[True, False]]),
    np.linspace(-2, 2, 6).astype(np.float16).reshape(3, 2),
]


class TestTensorProtoWireCompat:
    @pytest.mark.parametrize("arr", ARRAYS,
                             ids=["f32", "i64", "u8", "bool", "f16"])
    def test_tensor_content_round_trips_like_jax(self, arr):
        ours = tf_compat.numpy_to_tensorproto(arr)
        theirs = jax_tf_compat.numpy_to_tensorproto(arr)
        assert ours.SerializeToString() == theirs.SerializeToString()
        wire = pb.TensorProto.FromString(ours.SerializeToString())
        out = tf_compat.tensorproto_to_numpy(wire)
        assert out.dtype == arr.dtype
        np.testing.assert_array_equal(out, arr)
        np.testing.assert_array_equal(
            out, jax_tf_compat.tensorproto_to_numpy(wire))

    @pytest.mark.parametrize("field,dtype,values,shape", [
        ("float_val", 1, [3.5], [2, 2]),
        ("int_val", 3, [1, 2, 3, 4, 5, 6], [2, 3]),
        ("int64_val", 9, [7], [3]),
        ("bool_val", 10, [True, False], [2]),
        ("half_val", 19, [0x3C00, 0xC000], [2]),
    ])
    def test_typed_val_fields_decode_like_jax(self, field, dtype, values,
                                              shape):
        """tf.make_tensor_proto's small-tensor encoding: the typed
        ``*_val`` list, one value broadcast over the shape."""
        t = pb.TensorProto(dtype=dtype)
        getattr(t, field).extend(values)
        for size in shape:
            t.tensor_shape.dim.add(size=size)
        out = tf_compat.tensorproto_to_numpy(t)
        want = jax_tf_compat.tensorproto_to_numpy(t)
        assert out.shape == tuple(shape) and out.dtype == want.dtype
        np.testing.assert_array_equal(out, want)

    def test_decoded_arrays_are_writable(self):
        """Both request encodings hand predict a writable array, as the
        JAX copy does (it copies the read-only ``np.frombuffer`` view and
        the broadcast)."""
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        packed = pb.TensorProto.FromString(
            tf_compat.numpy_to_tensorproto(arr).SerializeToString())
        out = tf_compat.tensorproto_to_numpy(packed)
        assert out.flags.writeable
        out *= 2.0
        broadcast = pb.TensorProto(dtype=1, float_val=[3.5])
        broadcast.tensor_shape.dim.add(size=4)
        out = tf_compat.tensorproto_to_numpy(broadcast)
        assert out.flags.writeable
        out += 1.0

    def test_parses_string_tensor(self):
        blobs = [b"raw-jpeg-1", b"raw-jpeg-2"]
        wire = pb.TensorProto.FromString(
            _string_tensor(blobs).SerializeToString())
        assert tf_compat.tensorproto_to_numpy(wire) == blobs

    def test_unsupported_dtype_is_a_value_error(self):
        for mod in (tf_compat, jax_tf_compat):
            with pytest.raises(ValueError, match="unsupported"):
                mod.tensorproto_to_numpy(pb.TensorProto(dtype=8))
            with pytest.raises(ValueError, match="unsupported"):
                mod.numpy_to_tensorproto(np.zeros(2, np.complex64))

    def test_request_wrapper_round_trips_model_spec(self):
        req = pb.PredictRequest()
        req.model_spec.name = "inception"
        req.model_spec.signature_name = "predict_images"
        req.model_spec.version.value = 7
        back = pb.PredictRequest.FromString(req.SerializeToString())
        assert back.model_spec.name == "inception"
        assert back.model_spec.version.value == 7

    def test_protos_are_the_jax_packages_bytes(self):
        """The port's generated modules describe the same files (the same
        serialized descriptors) as the JAX package's, so both share one
        message class per type in a process that loads both."""
        from kubeflow_tpu.serving.protos import prediction_pb2 as jp
        from kubeflow_tpu.serving.protos import tf_compat_pb2 as jt

        assert gs.pb.DESCRIPTOR.serialized_pb == jp.DESCRIPTOR.serialized_pb
        assert pb.DESCRIPTOR.serialized_pb == jt.DESCRIPTOR.serialized_pb
        for ours, theirs in ((gs.pb, jp), (pb, jt)):
            for name in ours.DESCRIPTOR.message_types_by_name:
                assert getattr(ours, name) is getattr(theirs, name)
        for proto in ("prediction.proto", "tf_compat.proto"):
            assert (REPO / "kubeflow_tpu_torch/serving/protos" / proto
                    ).read_bytes() == (
                REPO / "kubeflow_tpu/serving/protos" / proto).read_bytes()


class TestImageDecode:
    def test_decode_image_bytes(self):
        rng = np.random.RandomState(0)
        blobs = [_jpeg(rng), _jpeg(rng)]
        batch = tf_compat.decode_image_bytes(blobs)
        assert batch.shape == (2, IMG, IMG, 3) and batch.dtype == np.uint8
        np.testing.assert_array_equal(
            batch, jax_tf_compat.decode_image_bytes(blobs))

    def test_undecodable_or_mixed_images_are_value_errors(self):
        rng = np.random.RandomState(1)
        with pytest.raises(ValueError, match="not a decodable image"):
            tf_compat.decode_image_bytes([b"not an image"])
        with pytest.raises(ValueError, match="share a shape"):
            tf_compat.decode_image_bytes([_jpeg(rng), _jpeg(rng, 16)])

    def test_images_key_aliased_and_decoded(self):
        rng = np.random.RandomState(1)
        req = pb.PredictRequest()
        req.inputs["images"].CopyFrom(_string_tensor([_jpeg(rng)]))
        inputs = tf_compat.request_inputs_to_numpy(req)
        assert set(inputs) == {"image"}
        assert inputs["image"].shape == (1, IMG, IMG, 3)


class TestEndToEndReferenceShapedPredict:
    def test_reference_client_request_runs_unchanged(self, exported):
        """A reference-era request (DT_STRING raw JPEG, inputs['images'],
        signature predict_images, output_filter) served end to end
        through the port's live gRPC port."""
        srv = _port_server(exported)
        grpc_srv = gs.make_grpc_server(srv, port=0, host="127.0.0.1")
        try:
            req = pb.PredictRequest()
            req.model_spec.name = "tiny"
            req.model_spec.signature_name = "predict_images"
            req.inputs["images"].CopyFrom(
                _string_tensor([_jpeg(np.random.RandomState(2))]))
            req.output_filter.append("scores")
            channel = grpc.insecure_channel(
                f"127.0.0.1:{grpc_srv.bound_port}")
            call = channel.unary_unary(
                f"/{tf_compat.TF_SERVICE}/Predict",
                request_serializer=pb.PredictRequest.SerializeToString,
                response_deserializer=pb.PredictResponse.FromString)
            resp = call(req, timeout=120)
            assert set(resp.outputs) == {"scores"}
            scores = tf_compat.tensorproto_to_numpy(resp.outputs["scores"])
            assert scores.shape == (1, CLASSES)
            np.testing.assert_allclose(scores.sum(), 1.0, atol=1e-3)
            assert resp.model_spec.version.value == 1
            channel.close()
        finally:
            grpc_srv.stop(grace=None)
            srv.stop()


# -- Both packages' servers on the same exports -----------------------------


class _Calls:
    """Raw calls to one server: native and TF-compat Predict, Classify,
    metadata and health, each answering (response, status code)."""

    def __init__(self, target):
        self.channel = grpc.insecure_channel(target)

    def call(self, service, method, req, resp_cls, metadata=None):
        fn = self.channel.unary_unary(
            f"/{service}/{method}",
            request_serializer=type(req).SerializeToString,
            response_deserializer=resp_cls.FromString)
        try:
            return fn(req, timeout=120, metadata=metadata), \
                grpc.StatusCode.OK, ()
        except grpc.RpcError as e:
            return None, e.code(), tuple(e.trailing_metadata() or ())

    def predict(self, name, inputs, metadata=None):
        req = gs.pb.PredictRequest()
        req.model_spec.name = name
        for key, value in inputs.items():
            req.inputs[key].CopyFrom(gs.numpy_to_tensor(value))
        return self.call(gs.SERVICE, "Predict", req, gs.pb.PredictResponse,
                         metadata)

    def health(self):
        fn = self.channel.unary_unary(
            f"/{gs.HEALTH_SERVICE}/Check", request_serializer=bytes,
            response_deserializer=bytes)
        return fn(b"", timeout=30)


def _drive(servicer_mod, srv, errors):
    """One request sequence against ``srv`` behind ``servicer_mod``'s
    gRPC server.  Returns the answers, status codes and retry-after
    metadata, in order."""
    server = servicer_mod.make_grpc_server(srv, port=0, host="127.0.0.1")
    calls = _Calls(f"127.0.0.1:{server.bound_port}")
    out = {}
    try:
        tp = "00-" + "12" * 16 + "-" + "34" * 8 + "-01"
        resp, out["predict_code"], _ = calls.predict(
            "lm", {"tokens": _tokens()}, metadata=(("traceparent", tp),))
        out["logits"] = gs.tensor_to_numpy(resp.outputs["logits"])
        out["predict_spec"] = (resp.model_spec.name,
                               resp.model_spec.version)

        creq = gs.pb.ClassifyRequest(top_k=2)
        creq.model_spec.name = "tiny"
        creq.inputs["image"].CopyFrom(gs.numpy_to_tensor(_image()))
        cresp, out["classify_code"], _ = calls.call(
            gs.SERVICE, "Classify", creq, gs.pb.ClassifyResponse)
        out["classes"] = [list(r.classes) for r in cresp.results]
        out["scores"] = np.asarray([list(r.scores) for r in cresp.results])

        mreq = gs.pb.GetModelMetadataRequest()
        mreq.model_spec.name = "lm"
        mresp, out["metadata_code"], _ = calls.call(
            gs.SERVICE, "GetModelMetadata", mreq,
            gs.pb.GetModelMetadataResponse)
        out["metadata"] = json.loads(mresp.metadata_json)

        treq = pb.PredictRequest()
        treq.model_spec.name = "lm"
        treq.inputs["tokens"].CopyFrom(
            tf_compat.numpy_to_tensorproto(_tokens(5)))
        tresp, out["tf_code"], _ = calls.call(
            tf_compat.TF_SERVICE, "Predict", treq, pb.PredictResponse)
        out["tf_logits"] = tf_compat.tensorproto_to_numpy(
            tresp.outputs["logits"])
        out["tf_version"] = tresp.model_spec.version.value

        out["health"] = calls.health()

        codes = []
        codes.append(calls.predict("missing", {"tokens": _tokens()})[1])
        bad = gs.pb.PredictRequest()
        bad.model_spec.name = "lm"
        bad.inputs["tokens"].CopyFrom(gs.pb.Tensor(
            dtype="int32", shape=[2, 5], data=b"\0" * 12))
        codes.append(calls.call(gs.SERVICE, "Predict", bad,
                                gs.pb.PredictResponse)[1])
        plain = srv.predict
        try:
            srv.predict = lambda *a, **k: (_ for _ in ()).throw(
                errors.Overloaded("full", retry_after_s=2.5))
            _, code, trailing = calls.predict("lm", {"tokens": _tokens()})
            codes.append(code)
            out["retry_after"] = dict(trailing).get("retry-after")
            client = servicer_mod.PredictionClient(
                f"127.0.0.1:{server.bound_port}")
            with pytest.raises(errors.Overloaded) as err:
                client.predict("lm", {"tokens": _tokens()})
            out["typed_retry_after"] = err.value.retry_after_s
            srv.predict = lambda *a, **k: (_ for _ in ()).throw(
                errors.DeadlineExceeded("late"))
            codes.append(calls.predict("lm", {"tokens": _tokens()})[1])
            with pytest.raises(errors.DeadlineExceeded):
                client.predict("lm", {"tokens": _tokens()})
            client.close()
        finally:
            srv.predict = plain
        out["codes"] = codes
        srv.begin_drain()
        out["health_draining"] = calls.health()
    finally:
        calls.channel.close()
        server.stop(0)
    return out


def test_both_packages_serve_the_same_answers(exported, monkeypatch):
    """One request sequence to a JAX gRPC server and to a port gRPC
    server over the same exports (each on a fresh metric registry and
    trace store): Predict and TF-compat Predict logits within 1e-5,
    Classify's top class equal and scores within 5e-3, equal metadata,
    health bytes and status codes (NOT_FOUND, INVALID_ARGUMENT,
    RESOURCE_EXHAUSTED with its ``retry-after`` trailing metadata,
    DEADLINE_EXCEEDED), and the same (metric name, label keys) pairs and
    span names."""
    from kubeflow_tpu.runtime import prom as jax_prom
    from kubeflow_tpu.runtime import tracing as jax_tracing
    from kubeflow_tpu.serving import errors as jax_errors
    from kubeflow_tpu_torch.serving import errors as port_errors
    from kubeflow_tpu_torch.serving import model_server as port_ms

    jax_reg, port_reg = jax_prom.Registry(), Registry()
    monkeypatch.setattr(jax_prom, "REGISTRY", jax_reg)
    monkeypatch.setattr(jax_tracing, "REGISTRY", jax_reg)
    for mod in (prom, tracing, port_ms):
        monkeypatch.setattr(mod, "REGISTRY", port_reg)
    jax_store = jax_tracing.enable(sample_rate=1.0, capacity=64)
    port_store = tracing.enable(sample_rate=1.0, capacity=64)
    jsrv = JaxModelServer()
    psrv = ModelServer(device="cpu")
    for name in ("tiny", "lm"):
        jsrv.add_model(name, str(exported[name]))
        psrv.add_model(name, str(exported[name]))
    try:
        want = _drive(jax_gs, jsrv, jax_errors)
        got = _drive(gs, psrv, port_errors)
        jax_spans = {s["name"] for t in jax_store.traces()
                     for s in t["spans"]}
        port_spans = {s["name"] for t in port_store.traces()
                      for s in t["spans"]}
    finally:
        jax_tracing.disable()
        tracing.disable()
        jsrv.stop()
        psrv.stop()
    ok = grpc.StatusCode.OK
    for key in ("predict_code", "classify_code", "metadata_code",
                "tf_code"):
        assert got[key] == want[key] == ok, key
    assert got["logits"].dtype == want["logits"].dtype == np.float32
    assert got["logits"].shape == (2, 12, LM["vocab_size"])
    np.testing.assert_allclose(got["logits"], want["logits"],
                               atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    np.testing.assert_allclose(got["tf_logits"], want["tf_logits"],
                               atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    assert got["predict_spec"] == want["predict_spec"] == ("lm", 1)
    assert got["tf_version"] == want["tf_version"] == 1
    assert [c[0] for c in got["classes"]] == [c[0] for c in want["classes"]]
    assert all(len(c) == 2 for c in got["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"],
                               atol=SCORES_ATOL)
    assert got["metadata"] == want["metadata"]
    assert got["health"] == want["health"] == bytes([0x08, 1])
    assert got["health_draining"] == want["health_draining"] \
        == bytes([0x08, 2])
    assert got["codes"] == want["codes"] == [
        grpc.StatusCode.NOT_FOUND, grpc.StatusCode.INVALID_ARGUMENT,
        grpc.StatusCode.RESOURCE_EXHAUSTED,
        grpc.StatusCode.DEADLINE_EXCEEDED]
    assert got["retry_after"] == want["retry_after"] == "2.5"
    assert got["typed_retry_after"] == want["typed_retry_after"] == 2.5

    def pairs(reg):
        return {(name, tuple(sorted(labels)))
                for name, samples in parse_metrics(reg.render()).items()
                for labels, _ in samples}

    grpc_pairs = {p for p in pairs(port_reg)
                  if p[0].startswith("kft_serving_request")}
    assert grpc_pairs == {p for p in pairs(jax_reg)
                          if p[0].startswith("kft_serving_request")}
    assert ("kft_serving_requests_total",
            ("model", "outcome", "route")) in grpc_pairs
    assert port_spans == jax_spans
    assert {"server.grpc_predict", "server.grpc_classify",
            "server.grpc_getmodelmetadata", "server.admission"} \
        <= port_spans


# -- The entry point --------------------------------------------------------


def test_manifest_args_parse_and_default_to_port_9000():
    """The serving manifest starts the container with
    ``--grpc_port=9000``; the parser takes it, its default is the JAX
    entry point's 9000, and -1 turns gRPC off."""
    base = ["--model_name", "m", "--model_base_path", "/models/m"]
    parse = serving_main._parser().parse_args
    assert parse(base + ["--port=8000", "--grpc_port=9000"]).grpc_port \
        == 9000
    assert parse(base).grpc_port == 9000
    assert parse(base + ["--grpc_port", "-1"]).grpc_port == -1


def test_start_serves_both_protocols_and_shutdown_stops_grpc(exported):
    server, httpd = serving_main.start([
        "--model_name", "tiny", "--model_base_path", str(exported["tiny"]),
        "--port", "0", "--grpc_port", "0", "--host", "127.0.0.1",
        "--device", "cpu", "--poll_interval_s", "60"])
    target = f"127.0.0.1:{httpd.grpc_server.bound_port}"
    try:
        assert httpd.grpc_server.bound_port > 0
        client = gs.PredictionClient(target)
        img = _image(n=1)
        out = client.predict("tiny", {"image": img}, timeout=120.0)
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}"
                "/model/tiny:predict",
                data=json.dumps({"instances": [
                    {"image": img[0].tolist()}]}).encode(),
                headers={"Content-Type": "application/json"}),
                timeout=120) as resp:
            rest = json.loads(resp.read())["predictions"][0]["scores"]
        np.testing.assert_allclose(out["scores"][0], rest, atol=1e-6)
        client.close()
    finally:
        serving_main.shutdown(server, httpd)
    assert gs.check_health(target, timeout=0.5) is False


def test_grpc_port_minus_one_serves_rest_only(exported):
    server, httpd = serving_main.start([
        "--model_name", "tiny", "--model_base_path", str(exported["tiny"]),
        "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
        "--device", "cpu", "--poll_interval_s", "60"])
    try:
        assert httpd.grpc_server is None
        with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.server_address[1]}/healthz",
                timeout=30) as resp:
            assert json.loads(resp.read())["models"] == {"tiny": [1]}
    finally:
        serving_main.shutdown(server, httpd)


def test_grpc_without_grpcio_fails_at_start(exported, monkeypatch):
    """A server asked for gRPC on a machine without grpcio fails at start
    with the ImportError, before it loads or serves anything; it never
    serves REST alone."""
    monkeypatch.setitem(sys.modules, "grpc", None)
    monkeypatch.delitem(sys.modules,
                        "kubeflow_tpu_torch.serving.grpc_server")
    started = []
    monkeypatch.setattr(ModelServer, "add_model",
                        lambda *a, **k: started.append(1))
    with pytest.raises(ImportError):
        serving_main.start([
            "--model_name", "tiny", "--model_base_path",
            str(exported["tiny"]), "--port", "0", "--grpc_port", "0",
            "--device", "cpu"])
    assert started == []


@pytest.fixture(scope="module")
def served_process(exported):
    """The port's entry point as its own process on the CPU, both
    protocols on ephemeral ports.  Its drain deadline is short, so the
    teardown's SIGTERM ends it well inside the bounded wait."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving.main",
         "--device", "cpu", "--model_name", "tiny", "--model_base_path",
         str(exported["tiny"]), "--port", "0", "--grpc_port", "0",
         "--host", "127.0.0.1", "--drain_deadline_s", "1"],
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
        env=env, cwd=REPO)
    found, ready = {}, threading.Event()

    def scan():
        for line in proc.stderr:
            m = re.search(r"KFT_SERVING_READY rest=(\d+) grpc=(\d+)", line)
            if m:
                found["ports"] = int(m.group(1)), int(m.group(2))
                ready.set()
        ready.set()  # EOF: the process ended

    threading.Thread(target=scan, daemon=True).start()
    try:
        if not ready.wait(timeout=180) or "ports" not in found:
            pytest.fail("serving process never became ready")
        yield proc, found["ports"]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


class TestServingProcess:
    def test_rest_predict_and_health(self, served_process):
        _, (rest_port, _) = served_process
        body = json.dumps({"instances": [
            {"image": _image(seed=0, n=1)[0].tolist()}]}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{rest_port}/model/tiny:predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert len(out["predictions"][0]["scores"]) == CLASSES
        with urllib.request.urlopen(
                f"http://127.0.0.1:{rest_port}/healthz", timeout=60) as r:
            assert json.loads(r.read())["models"] == {"tiny": [1]}

    def test_grpc_predict_classify_metadata_health(self, served_process):
        _, (_, grpc_port) = served_process
        target = f"127.0.0.1:{grpc_port}"
        client = gs.PredictionClient(target)
        img = _image(seed=1)
        out = client.predict("tiny", {"image": img}, timeout=120.0)
        assert out["scores"].shape == (2, CLASSES)
        np.testing.assert_allclose(out["scores"].sum(-1), 1.0, atol=1e-3)
        pairs = client.classify("tiny", {"image": img}, timeout=120.0)
        assert [p[0][0] for p in pairs] == [
            str(c) for c in out["scores"].argmax(-1)]
        assert client.metadata("tiny", timeout=60.0)["version"] == 1
        assert client.ready() and gs.check_health(target)
        client.close()

    def test_tf_compat_predict(self, served_process):
        _, (_, grpc_port) = served_process
        req = pb.PredictRequest()
        req.model_spec.name = "tiny"
        req.inputs["image"].CopyFrom(
            tf_compat.numpy_to_tensorproto(_image(seed=1)))
        channel = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
        try:
            resp = channel.unary_unary(
                f"/{tf_compat.TF_SERVICE}/Predict",
                request_serializer=pb.PredictRequest.SerializeToString,
                response_deserializer=pb.PredictResponse.FromString,
            )(req, timeout=120)
        finally:
            channel.close()
        client = gs.PredictionClient(f"127.0.0.1:{grpc_port}")
        native = client.predict("tiny", {"image": _image(seed=1)},
                                timeout=120.0)
        client.close()
        np.testing.assert_array_equal(
            tf_compat.tensorproto_to_numpy(resp.outputs["scores"]),
            native["scores"])
