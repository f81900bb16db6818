"""TF-Serving Predict compatibility: reference clients run unchanged.
The port's copy of kubeflow_tpu/serving/tf_compat.py.

The reference's gRPC clients called
``/tensorflow.serving.PredictionService/Predict`` with TF
``TensorProto`` inputs — raw image BYTES for the Inception flagship
(inception-client/label.py:40-57: ``tf.make_tensor_proto(raw_images)``,
DT_STRING), decoded inside the served TF graph.  This module gives the
first-party server that exact wire face:

  * protos/tf_compat.proto — field-number clones of the public
    predict/model/tensor protos (wire-identical; see its header);
  * TensorProto <-> numpy converters for the encodings real clients
    emit (tensor_content, typed ``*_val`` lists, DT_STRING bytes);
  * server-side image decode (PIL) for DT_STRING inputs, standing in
    for the decode_jpeg the reference's TF graph did;
  * a Predict servicer registered under the tensorflow.serving service
    name next to the native kft.serving one (grpc_server.py).

The native ``kft.serving`` surface remains the primary contract; this
is the unchanged-client on-ramp.
"""

from __future__ import annotations

import io
from typing import Any, Dict, List

import numpy as np

from kubeflow_tpu_torch.serving.protos import tf_compat_pb2 as pb

TF_SERVICE = "tensorflow.serving.PredictionService"

# tensorflow DataType enum values <-> numpy dtypes (tensor.proto /
# types.proto; integers cloned so no tf import is needed at runtime).
DT_STRING = 7
_DT_TO_NUMPY = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
    5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
    17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64,
}
_NUMPY_TO_DT = {np.dtype(v): k for k, v in _DT_TO_NUMPY.items()}

# Which repeated field carries values for each dtype when
# tensor_content is empty (tf.make_tensor_proto's small-tensor path).
_VAL_FIELD = {
    1: "float_val", 2: "double_val", 3: "int_val", 4: "int_val",
    5: "int_val", 6: "int_val", 9: "int64_val", 10: "bool_val",
    17: "int_val", 19: "half_val", 22: "uint32_val", 23: "uint64_val",
}


def tensorproto_to_numpy(t: pb.TensorProto):
    """tensorflow.TensorProto bytes -> numpy array (or list of bytes
    for DT_STRING).  Handles both encodings clients produce:
    ``tensor_content`` (packed little-endian) and the typed ``*_val``
    repeated fields, including the broadcast-one-value shorthand."""
    shape = tuple(d.size for d in t.tensor_shape.dim)
    if t.dtype == DT_STRING:
        return list(t.string_val)
    np_dtype = _DT_TO_NUMPY.get(t.dtype)
    if np_dtype is None:
        raise ValueError(f"unsupported TensorProto dtype {t.dtype}")
    if t.tensor_content:
        # frombuffer views the (immutable) protobuf bytes read-only; a
        # consumer normalizing/padding the input dict in place would
        # hit 'assignment destination is read-only' only on THIS
        # encoding, a payload-dependent failure.  Inputs are request-
        # sized: the copy is cheap next to the decode.
        arr = np.frombuffer(t.tensor_content, dtype=np_dtype)
        return arr.reshape(shape).copy()
    vals = np.asarray(
        list(getattr(t, _VAL_FIELD[t.dtype])))
    if t.dtype == 19:  # half_val carries raw uint16 bit patterns
        vals = vals.astype(np.uint16).view(np.float16)
    vals = vals.astype(np_dtype)
    n = int(np.prod(shape)) if shape else vals.size
    if vals.size == 1 and n > 1:
        # broadcast_to also yields a read-only view; same contract.
        vals = np.broadcast_to(vals, (n,)).copy()
    return vals.reshape(shape)


def numpy_to_tensorproto(arr: np.ndarray) -> pb.TensorProto:
    arr = np.ascontiguousarray(arr)
    dt = _NUMPY_TO_DT.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported response dtype {arr.dtype}")
    t = pb.TensorProto(dtype=dt, tensor_content=arr.tobytes())
    for size in arr.shape:
        t.tensor_shape.dim.add(size=size)
    return t


def decode_image_bytes(blobs: List[bytes]) -> np.ndarray:
    """Raw encoded image bytes -> uint8 [n, h, w, 3] — the server-side
    stand-in for the decode_jpeg node the reference's TF graph ran on
    its DT_STRING inputs.  All images in one request must decode to one
    shape (they share a batch)."""
    from PIL import Image

    rows = []
    for i, blob in enumerate(blobs):
        try:
            img = Image.open(io.BytesIO(blob)).convert("RGB")
        except Exception as e:
            # Client-supplied bytes: surface as INVALID_ARGUMENT (the
            # gRPC wrapper maps ValueError), not a bare UNKNOWN —
            # PIL raises UnidentifiedImageError/OSError, neither of
            # which the status mapping knows.
            raise ValueError(
                f"inputs string tensor element {i} is not a decodable "
                f"image: {e}") from e
        rows.append(np.asarray(img, dtype=np.uint8))
    try:
        return np.stack(rows)
    except ValueError as e:
        raise ValueError(
            f"images in one request must share a shape: {e}") from e


def request_inputs_to_numpy(
    request: pb.PredictRequest,
) -> Dict[str, Any]:
    """Convert a TF-shaped request's inputs for ModelServer.predict.

    DT_STRING inputs are decoded as images; the reference's canonical
    input key ``images`` is aliased to the first-party loaders' singular
    ``image`` (label.py sent ``inputs['images']``)."""
    inputs: Dict[str, Any] = {}
    for key, t in request.inputs.items():
        value = tensorproto_to_numpy(t)
        if isinstance(value, list):  # DT_STRING -> decoded image batch
            value = decode_image_bytes(value)
        if key == "images":
            key = "image"
        inputs[key] = value
    return inputs


class TFPredictServicer:
    """Predict (and GetModelMetadata-free) face of the compat service —
    registered under the tensorflow.serving service name."""

    def __init__(self, server):
        self.server = server

    def Predict(self, request: pb.PredictRequest, context):
        spec = request.model_spec
        version = (spec.version.value
                   if spec.HasField("version") and spec.version.value > 0
                   else None)
        # Resolve BEFORE predicting (same order as the native
        # servicer): resolving after could report a version a
        # concurrent hot-swap installed mid-request.
        model = self.server.get(spec.name, version)
        inputs = request_inputs_to_numpy(request)
        outputs = self.server.predict(spec.name, inputs, version)
        resp = pb.PredictResponse()
        resp.model_spec.name = spec.name
        resp.model_spec.version.value = model.version
        keep = set(request.output_filter)
        for key, value in outputs.items():
            if keep and key not in keep:
                continue
            resp.outputs[key].CopyFrom(
                numpy_to_tensorproto(np.asarray(value)))
        return resp
