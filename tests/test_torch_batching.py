"""The port's batching plane and REST helpers against the JAX package's.

Pure host logic: the same inputs go through kubeflow_tpu's and the
port's BucketedLMBatcher band partition, collate and strip, and the REST
column/row helpers, and must give equal results.  The failure paths of
the port's MicroBatcher and ModelServer (deadline, overload, close, the
direct-path fallback) are checked on their own, with a fake predict.
"""

import threading
import time

import numpy as np
import pytest

from kubeflow_tpu.serving import http as jax_http
from kubeflow_tpu.serving.model_server import (
    BucketedLMBatcher as JaxBucketedLMBatcher,
)
from kubeflow_tpu_torch.serving import http
from kubeflow_tpu_torch.serving.errors import (
    BatcherClosed,
    DeadlineExceeded,
    Overloaded,
)
from kubeflow_tpu_torch.serving.model_server import (
    BucketedLMBatcher,
    LoadedModel,
    MicroBatcher,
    ModelServer,
)


def _echo(inputs):
    """Fake LM predict: the prompt followed by two tokens per row."""
    tokens = np.asarray(inputs["tokens"])
    tail = np.full((tokens.shape[0], 2), 7, tokens.dtype)
    return {"tokens": np.concatenate([tokens, tail], axis=1)}


@pytest.fixture
def batchers():
    made = []

    def make(cls, **kwargs):
        b = cls(_echo, **kwargs)
        made.append(b)
        return b

    yield make
    for b in made:
        b.close()


@pytest.mark.parametrize("factor", [None, 2.0, 4.0])
def test_bands_match_jax(batchers, factor):
    buckets = [8, 16, 32, 64, 128, 512]
    ours = batchers(BucketedLMBatcher, buckets=buckets,
                    max_promotion_factor=factor)
    theirs = batchers(JaxBucketedLMBatcher, buckets=buckets,
                      max_promotion_factor=factor)
    assert ours._band == theirs._band
    for n in (1, 8, 9, 100, 512):
        assert ours.bucket_for(n) == theirs.bucket_for(n)


def test_collate_and_strip_match_jax(batchers):
    buckets = [8, 16, 32]
    ours = batchers(BucketedLMBatcher, buckets=buckets)
    theirs = batchers(JaxBucketedLMBatcher, buckets=buckets)
    rng = np.random.default_rng(0)
    rows = [{"tokens": rng.integers(1, 100, (1, n)).astype(np.int32)}
            for n in (3, 11, 7)]
    rows[1]["max_new_tokens"] = np.asarray(1)
    got, got_meta = ours._collate(rows)
    want, want_meta = theirs._collate(rows)
    assert got_meta == want_meta
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    out = _echo(got)
    for i, meta in enumerate(got_meta):
        row = {"tokens": out["tokens"][i:i + 1]}
        np.testing.assert_array_equal(ours._strip(row, meta)["tokens"],
                                      theirs._strip(row, meta)["tokens"])


def test_rest_helpers_match_jax():
    instances = [{"tokens": [1, 2, 3], "seed": 4},
                 {"tokens": [5, 6, 7], "seed": 8}]
    got = http.instances_to_inputs(instances)
    want = jax_http.instances_to_inputs(instances)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    bare = [[1, 2], [3, 4]]
    np.testing.assert_array_equal(
        http.instances_to_inputs(bare, ["tokens"])["tokens"],
        jax_http.instances_to_inputs(bare, ["tokens"])["tokens"])
    outputs = {"tokens": np.arange(6).reshape(2, 3)}
    assert http.outputs_to_predictions(outputs) == \
        jax_http.outputs_to_predictions(outputs)
    b64 = {"b64": "AAEC"}
    np.testing.assert_array_equal(http.decode_b64_if_needed(b64),
                                  jax_http.decode_b64_if_needed(b64))
    with pytest.raises(ValueError):
        http.instances_to_inputs([])


def test_mixed_lengths_share_one_padded_batch(batchers):
    seen = []

    def predict(inputs):
        seen.append({k: np.asarray(v).copy() for k, v in inputs.items()})
        return _echo(inputs)

    b = batchers(BucketedLMBatcher, buckets=[8, 16], max_batch_size=4,
                 batch_timeout_s=5.0, allowed_batch_sizes=[4])
    b._inner._predict = predict
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (3, 12, 5, 16)]
    results = [None] * 4
    threads = [threading.Thread(
        target=lambda i=i: results.__setitem__(
            i, b.submit({"tokens": prompts[i]}))) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(seen) == 1 and seen[0]["tokens"].shape == (4, 16)
    assert sorted(seen[0]["prompt_len"].tolist()) == [3, 5, 12, 16]
    for prompt, out in zip(prompts, results):
        assert out["tokens"].tolist() == [prompt.tolist() + [7, 7]]


def test_microbatcher_groups_by_shape_and_pads(batchers):
    sizes = []

    def predict(inputs):
        sizes.append(np.asarray(inputs["x"]).shape)
        return {"y": np.asarray(inputs["x"]) * 2}

    b = batchers(MicroBatcher, max_batch_size=4, batch_timeout_s=0.2,
                 allowed_batch_sizes=[4])
    b._predict = predict
    inputs = [np.ones((1, 3)), np.ones((1, 3)) * 2, np.ones((1, 5))]
    out = [None] * 3
    threads = [threading.Thread(
        target=lambda i=i: out.__setitem__(i, b.submit({"x": inputs[i]})))
        for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sorted(sizes) == [(4, 3), (4, 5)]
    for x, y in zip(inputs, out):
        np.testing.assert_array_equal(y["y"], x * 2)
    assert b.stats()["requests"] == 3
    with pytest.raises(ValueError, match="one row"):
        b.submit({"x": np.ones((2, 3))})


def test_deadline_expires_in_queue(batchers):
    # A lone row waits for its batch window; its deadline passes first.
    b = batchers(MicroBatcher, max_batch_size=2, batch_timeout_s=30.0,
                 in_flight=1)
    row = {"tokens": np.ones((1, 2), np.int32)}
    with pytest.raises(DeadlineExceeded, match="admission"):
        b.submit(row, deadline=time.monotonic() - 1)
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded, match="queue"):
        b.submit(row, deadline=time.monotonic() + 0.2)
    assert time.monotonic() - t0 < 10
    assert b.stats()["deadline_expired"] == 2


def test_overload_then_close(batchers):
    b = batchers(MicroBatcher, max_batch_size=2, batch_timeout_s=30.0,
                 in_flight=1, max_queue_depth=1)
    row = {"tokens": np.ones((1, 2), np.int32)}
    errors = []

    def submit():
        try:
            b.submit(row)
        except BatcherClosed as e:
            errors.append(e)

    queued = threading.Thread(target=submit)
    queued.start()
    deadline = time.monotonic() + 30
    while b.stats()["queue_depth"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(Overloaded) as shed:
        b.submit(row)
    assert shed.value.retry_after_s == 1.0
    b.close()  # fails the queued entry rather than dropping it
    queued.join(timeout=30)
    assert not queued.is_alive() and len(errors) == 1
    with pytest.raises(BatcherClosed):
        b.submit(row)


def test_server_falls_back_to_direct_path_and_caps_inflight():
    server = ModelServer(device="cpu", max_inflight=1)
    calls = []

    def predict(inputs):
        calls.append(np.asarray(inputs["tokens"]).shape)
        return _echo(inputs)

    server._models["lm"] = {1: LoadedModel("lm", 1, predict, {})}
    closed = MicroBatcher(predict)
    closed.close()
    server._batchers["lm"] = closed
    out = server.predict("lm", {"tokens": np.ones((1, 3), np.int32)})
    assert out["tokens"].shape == (1, 5) and calls == [(1, 3)]
    server._inflight_by_model["lm"] = 1
    with pytest.raises(Overloaded):
        server.predict("lm", {"tokens": np.ones((1, 3), np.int32)})
    server._inflight_by_model["lm"] = 0
    with pytest.raises(KeyError):
        server.predict("nope", {"tokens": np.ones((1, 3), np.int32)})
    with pytest.raises(DeadlineExceeded):
        server.predict("lm", {"tokens": np.ones((1, 3), np.int32)},
                       deadline=time.monotonic() - 1)
    server.stop()
