"""The port's classifier serving (serving/loaders.py ``classifier``, the
``:classify`` route, the MicroBatcher path) against the JAX package's.

A narrow ResNet-18 is exported by the JAX package's ``export`` under the
JAX loader name, every leaf drawn from numpy, and the same directory is
served by the JAX ``ServingAPI`` and by the port's ``ModelServer`` and
``ServingAPI`` on the CPU.  Both compute in bfloat16; the port's answers
are held to the JAX server's within 5e-3 (scores), with the top class
equal.  The golden twin of tests/test_serving_golden.py serves the
JAX-initialised Inception-v3 and matches the committed golden at that
test's own atol 5e-3.
"""

import http.client
import json
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.inception import InceptionV3 as JaxInceptionV3
from kubeflow_tpu.models.resnet import ResNet18 as JaxResNet18
from kubeflow_tpu.serving.export import export as jax_export
from kubeflow_tpu.serving.http import ServingAPI as JaxServingAPI
from kubeflow_tpu.serving.model_server import ModelServer as JaxModelServer
from kubeflow_tpu_torch.serving import loaders
from kubeflow_tpu_torch.serving.http import ServingAPI, make_http_server
from kubeflow_tpu_torch.serving.main import batcher_factory
from kubeflow_tpu_torch.serving.model_server import (
    LoadedModel,
    MicroBatcher,
    ModelServer,
)
from test_torch_resnet import random_variables

JAX_LOADER = "kubeflow_tpu.serving.loaders:classifier"
CONFIG = {"family": "resnet18", "num_classes": 10, "num_filters": 8,
          "top_k": 3}
SIZE = 32
ATOL = 5e-3
GOLDEN = Path(__file__).parent / "golden" / "inception_predict.json"
GOLDEN_SEED = 20260730


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(port ServingAPI, JAX ServingAPI, port batching ServingAPI) over one
    JAX-exported directory."""
    base = tmp_path_factory.mktemp("models") / "resnet"
    variables = random_variables(
        JaxResNet18(num_classes=10, num_filters=8), (1, SIZE, SIZE, 3),
        train=False)
    jax_export(base, 1, variables, loader=JAX_LOADER, config=CONFIG,
               signature={"inputs": {"image": [None, SIZE, SIZE, 3]},
                          "outputs": {"scores": [None, 10]}})
    jserver = JaxModelServer()
    jserver.add_model("resnet", str(base))
    port = ModelServer(device="cpu")
    port.add_model("resnet", str(base))
    batched = ModelServer(device="cpu")
    batched.add_model("resnet", str(base))
    batched.enable_batching("resnet", batcher_factory(
        micro_batch_size=4, batch_timeout_s=0.2))
    yield ServingAPI(port), JaxServingAPI(jserver), ServingAPI(batched)
    batched.stop()


def _instances(kind, n=2, seed=3):
    rng = np.random.default_rng(seed)
    shape = (n, SIZE, SIZE, 3)
    if kind == "float32":
        return rng.uniform(-1, 1, shape).astype(np.float32).tolist()
    if kind == "uint8":
        return rng.integers(0, 256, shape).tolist()
    assert kind == "out_of_range"  # integers past 0..255: float32, unscaled
    return rng.integers(-300, 300, shape).tolist()


def _assert_close_to_jax(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"scores", "top_k_scores",
                                    "top_k_classes"}
        np.testing.assert_allclose(g["scores"], w["scores"], atol=ATOL)
        np.testing.assert_allclose(g["top_k_scores"], w["top_k_scores"],
                                   atol=ATOL)
        assert g["top_k_classes"][0] == w["top_k_classes"][0]
        assert len(g["top_k_classes"]) == CONFIG["top_k"]
        np.testing.assert_allclose(sum(g["scores"]), 1.0, atol=1e-5)


@pytest.mark.parametrize("kind", ["float32", "uint8", "out_of_range"])
def test_predict_matches_the_jax_server(served, kind):
    port, jax_api, _ = served
    body = {"instances": _instances(kind)}
    got = port.predict("resnet", body)["predictions"]
    want = jax_api.predict("resnet", body)["predictions"]
    _assert_close_to_jax(got, want)


def test_the_wire_dtype_decides_the_scaling(served):
    """uint8 pixels are scaled by 1/255 on the device: the same image as
    0..255 integers and as float32 in [0, 1] gives the same answer."""
    port, _, _ = served
    pixels = np.asarray(_instances("uint8", n=1))
    a = port.predict("resnet", {"instances": pixels.tolist()})
    b = port.predict("resnet", {"instances": (pixels.astype(np.float32)
                                              / 255.0).tolist()})
    np.testing.assert_allclose(a["predictions"][0]["scores"],
                               b["predictions"][0]["scores"], atol=1e-6)


def test_a_three_dim_image_gets_a_batch_axis(served):
    port, jax_api, _ = served
    image = np.asarray(_instances("float32", n=1)[0], np.float32)
    got = port.server.predict("resnet", {"image": image})
    want = jax_api.server.predict("resnet", {"image": image})
    assert got["scores"].shape == (1, 10)
    assert got["top_k_classes"].dtype == np.int32
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]),
                               atol=ATOL)
    assert got["top_k_classes"][0, 0] == int(want["top_k_classes"][0, 0])


def test_classify_gives_the_top_k_pairs(served):
    port, jax_api, _ = served
    body = {"instances": _instances("float32", n=3)}
    got = port.classify("resnet", body)
    want = jax_api.classify("resnet", body)
    preds = port.predict("resnet", body)["predictions"]
    rows = got["result"]["classifications"]
    assert len(rows) == 3
    for row, pred, jrow in zip(rows, preds, want["result"]["classifications"]):
        assert row == [[str(c), s] for c, s in zip(pred["top_k_classes"],
                                                   pred["top_k_scores"])]
        assert row[0][0] == jrow[0][0]
        np.testing.assert_allclose([s for _, s in row],
                                   [s for _, s in jrow], atol=ATOL)


def test_co_batched_answers_equal_single_calls(served):
    port, _, batched = served
    rows = _instances("float32", n=4, seed=9)
    results = [None] * 4

    def call(i):
        results[i] = batched.predict("resnet", {"instances": [rows[i]]})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats = batched.server.batcher_stats("resnet")
    assert stats["requests"] == 4 and stats["batches"] < 4  # co-batched
    for i in range(4):
        single = port.predict("resnet", {"instances": [rows[i]]})
        # Within float32 rounding: the CPU's conv kernels differ by batch
        # size in the last bits of the bf16 logits' softmax.
        np.testing.assert_allclose(
            results[i]["predictions"][0]["scores"],
            single["predictions"][0]["scores"], atol=1e-6)
        assert results[i]["predictions"][0]["top_k_classes"] == \
            single["predictions"][0]["top_k_classes"]


def test_rest_routes_classify_and_version(served):
    port, _, _ = served
    httpd, _ = make_http_server(port.server, port=0, host="127.0.0.1")
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1])
        body = json.dumps({"instances": _instances("uint8", n=1)})
        for path in ("/model/resnet:classify",
                     "/model/resnet/version/1:classify"):
            conn.request("POST", path, body)
            reply = json.loads(conn.getresponse().read())
            pairs = reply["result"]["classifications"][0]
            assert len(pairs) == 3 and all(isinstance(c, str)
                                           for c, _ in pairs)
        conn.request("POST", "/model/resnet/version/7:classify", body)
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_ties_go_to_the_lowest_class(tmp_path):
    """A zero head gives equal scores: the top k is classes 0..k-1, as
    jax.lax.top_k orders ties."""
    variables = jax.tree.map(np.asarray, random_variables(
        JaxResNet18(num_classes=10, num_filters=8), (1, SIZE, SIZE, 3),
        train=False))
    variables["params"]["head"]["kernel"][:] = 0.0
    variables["params"]["head"]["bias"][:] = 0.0
    predict = loaders.classifier(CONFIG, device="cpu")(
        _torch_tree(variables))
    out = predict({"image": np.zeros((2, SIZE, SIZE, 3), np.float32)})
    np.testing.assert_allclose(out["scores"], 0.1, atol=1e-6)
    np.testing.assert_array_equal(out["top_k_classes"], [[0, 1, 2]] * 2)


def _torch_tree(variables):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), variables)


def test_the_loader_runs_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loaders.classifier(CONFIG)
    with pytest.raises(ValueError, match="unknown classifier family"):
        loaders.classifier({"family": "vgg16"}, device="cpu")


def test_a_classifier_is_served_through_the_micro_batcher():
    build = batcher_factory(micro_batch_size=8, batch_timeout_s=0.01)
    model = LoadedModel(name="resnet", version=1,
                        predict=lambda inputs: inputs,
                        meta={"loader": JAX_LOADER})
    batcher = build(model)
    try:
        assert isinstance(batcher, MicroBatcher)
        assert batcher.allowed == [1, 2, 4, 8]
    finally:
        batcher.close()


def test_golden_inception_served_by_the_port(tmp_path):
    """The twin of tests/test_serving_golden.py: the JAX-initialised
    Inception-v3 (seed 20260730, 96 x 96, 16 classes), exported by the
    JAX package, served by the port, against the committed golden."""
    base = tmp_path / "inception"
    model = JaxInceptionV3(num_classes=16)
    x = np.zeros((1, 96, 96, 3), np.float32)
    # Jitted, the init draws the same values as the golden test's eager
    # one, in half the time.
    variables = jax.jit(lambda key: model.init(key, x, train=False))(
        jax.random.key(GOLDEN_SEED))
    jax_export(base, 1, variables, loader=JAX_LOADER,
               config={"family": "inception_v3", "num_classes": 16,
                       "top_k": 5},
               signature={"inputs": {"image": [None, 96, 96, 3]},
                          "outputs": {"scores": [None, 16]}})
    api = ServingAPI(_server(base))
    image = np.random.RandomState(GOLDEN_SEED).uniform(
        -1, 1, size=(1, 96, 96, 3)).astype(np.float32)
    pred = api.predict("inception", {"instances": [
        {"image": image[0].tolist()}]})["predictions"][0]
    want = json.loads(GOLDEN.read_text())
    np.testing.assert_allclose(np.asarray(pred["scores"]).round(6),
                               np.asarray(want["scores"]), atol=5e-3)
    assert pred["top_k_classes"][0] == want["top_k_classes"][0]
    assert np.asarray(pred["scores"]).shape == (16,)


def _server(base):
    server = ModelServer(device="cpu")
    server.add_model("inception", str(base))
    return server
