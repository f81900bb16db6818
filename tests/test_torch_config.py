"""Unit tests for the port's typed param system: the twins of
tests/test_config.py on ``kubeflow_tpu_torch.config``.

Heir of kubeflow/core/tests/util_test.jsonnet:1-22 (toBool/toArray coercion
assertions) — same coverage, plus the error cases jsonnet silently passed.
"""

import pytest
import torch

from kubeflow_tpu_torch.config import (
    Param,
    ParamError,
    Prototype,
    Registry,
    param,
    to_bool,
    to_list,
)

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)


class TestCoercions:
    def test_to_bool_truthy(self):
        for v in (True, "true", "True", "TRUE", "yes", "1", 1, 2.5, "on"):
            assert to_bool(v) is True

    def test_to_bool_falsy(self):
        for v in (False, "false", "False", "no", "0", 0, 0.0, "", "off"):
            assert to_bool(v) is False

    def test_to_bool_garbage_raises(self):
        with pytest.raises(ParamError):
            to_bool("maybe")

    def test_to_list(self):
        assert to_list("a,b,c") == ["a", "b", "c"]
        assert to_list("a, b , c") == ["a", "b", "c"]
        assert to_list("") == []
        assert to_list(None) == []
        assert to_list(["x", 1]) == ["x", "1"]


class TestParam:
    def test_default(self):
        p = param("replicas", int, 3)
        assert p.coerce(None) == 3

    def test_string_to_int(self):
        assert param("replicas", int, 3).coerce("7") == 7

    def test_required_missing(self):
        with pytest.raises(ParamError, match="required"):
            param("name", str, required=True).coerce(None)

    def test_choices(self):
        p = param("cloud", str, "gke", choices=["gke", "minikube"])
        assert p.coerce("minikube") == "minikube"
        with pytest.raises(ParamError, match="not in"):
            p.coerce("aws")

    def test_bad_coercion(self):
        with pytest.raises(ParamError, match="coerce"):
            param("n", int).coerce("not-a-number")


def _echo_proto():
    return Prototype(
        name="echo",
        params=[param("namespace", str, "default"),
                param("replicas", int, 1)],
        generate=lambda name, namespace, replicas: [
            {"kind": "Echo", "metadata": {"name": name,
                                          "namespace": namespace},
             "spec": {"replicas": replicas}}],
    )


class TestPrototype:
    def test_generate_with_defaults(self):
        objs = _echo_proto().generate("mine")
        assert objs == [{"kind": "Echo",
                         "metadata": {"name": "mine", "namespace": "default"},
                         "spec": {"replicas": 1}}]

    def test_unknown_param_rejected(self):
        with pytest.raises(ParamError, match="unknown parameters"):
            _echo_proto().generate("mine", nope=1)

    def test_describe_lists_params(self):
        text = _echo_proto().describe()
        assert "--namespace" in text and "--replicas" in text


class TestRegistry:
    def test_register_and_generate(self):
        reg = Registry()
        reg.register(_echo_proto())
        assert reg.names() == ["echo"]
        objs = reg.generate("echo", "x", replicas="5")
        assert objs[0]["spec"]["replicas"] == 5

    def test_duplicate_rejected(self):
        reg = Registry()
        reg.register(_echo_proto())
        with pytest.raises(ParamError, match="already registered"):
            reg.register(_echo_proto())

    def test_unknown_prototype(self):
        with pytest.raises(ParamError, match="unknown prototype"):
            Registry().get("nope")


class TestApp:
    def test_render_flow(self):
        from kubeflow_tpu_torch.config.registry import App

        reg = Registry()
        reg.register(_echo_proto())
        app = App(namespace="kubeflow", registry=reg)
        app.add("echo", "one").add("echo", "two", replicas=2)
        app.set_param("two", "replicas", 9)
        objs = app.render()
        assert [o["metadata"]["name"] for o in objs] == ["one", "two"]
        # App namespace flows into components that declare a namespace param.
        assert objs[0]["metadata"]["namespace"] == "kubeflow"
        assert objs[1]["spec"]["replicas"] == 9

    def test_add_validates_eagerly(self):
        from kubeflow_tpu_torch.config.registry import App

        reg = Registry()
        reg.register(_echo_proto())
        with pytest.raises(ParamError):
            App(registry=reg).add("echo", "x", bogus=True)
