"""Golden-manifest tests of the port's renderers: the twins of
tests/test_manifests.py in GPU form (``h100-N`` gang shapes,
``nvidia.com/gpu``, never ``google.com/tpu``).

Heir of the reference's jsonnet test tier (kubeflow/core/tests/*.jsonnet,
runner testing/test_jsonnet.py:39-62): assert exact generated objects for
each component, field-by-field rather than blob-compare, "because if you
just compare to a big blob of text its much harder to know where they
differ" (kubeflow/core/tests/jupyterhub_test.jsonnet comment).
"""

import pytest
import torch

import kubeflow_tpu_torch.manifests  # registers prototypes  # noqa: F401
from kubeflow_tpu_torch.config import ParamError, default_registry
from kubeflow_tpu_torch.config.registry import App
from kubeflow_tpu_torch.manifests import base

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)


class TestBase:
    def test_service_headless(self):
        svc = base.service("w", "ns", {"app": "w"}, [base.port(22, "ssh")],
                           headless=True)
        assert svc["spec"]["clusterIP"] == "None"

    def test_container_drops_empty_fields(self):
        c = base.container("c", "img")
        assert set(c) == {"name", "image"}

    def test_crd_shape(self):
        obj = base.crd("tpujobs", "kubeflow-tpu.org", "TPUJob", ["v1alpha1"])
        assert obj["metadata"]["name"] == "tpujobs.kubeflow-tpu.org"
        assert obj["spec"]["versions"][0]["storage"] is True

    def test_gpu_resources_no_tpu(self):
        res = base.gpu_resource_limits("h100-8", 8)
        assert res == {"limits": {"nvidia.com/gpu": 8}}

    def test_to_yaml_roundtrip(self):
        text = base.to_yaml([{"kind": "ConfigMap", "metadata": {"name": "x"}}])
        assert "kind: ConfigMap" in text or '"kind": "ConfigMap"' in text


class TestTPUJobPrototypes:
    def test_tpu_job_cr_golden(self):
        objs = default_registry.generate(
            "tpu-job", "myjob", slice_type="h100-32", command=["python", "-m", "me"],
        )
        assert len(objs) == 1
        cr = objs[0]
        assert cr["apiVersion"] == "kubeflow-tpu.org/v1alpha1"
        assert cr["kind"] == "TPUJob"
        assert cr["metadata"] == {"name": "myjob", "namespace": "kubeflow"}
        assert cr["spec"]["sliceType"] == "h100-32"
        assert cr["spec"]["worker"]["command"] == ["python", "-m", "me"]
        assert cr["spec"]["restartPolicy"]["maxRestarts"] == 3
        # Optional fields are omitted, not null.
        assert "storage" not in cr["spec"] and "queue" not in cr["spec"]

    def test_cnn_benchmark_args(self):
        (cr,) = default_registry.generate(
            "tpu-cnn-benchmark", "bench", model="resnet50",
            batch_size="256", num_batches=10)
        args = cr["spec"]["worker"]["args"]
        assert "--model=resnet50" in args
        assert "--batch-size-per-device=256" in args
        assert "--dtype=bfloat16" in args
        # The PS-era flags must NOT leak into the SPMD world.
        assert not any("parameter_server" in a for a in args)
        assert not any("num_ps" in a for a in args)

    def test_cnn_model_choices(self):
        with pytest.raises(ParamError):
            default_registry.generate("tpu-cnn-benchmark", "b", model="vgg99")

    def test_operator_manifests(self):
        objs = default_registry.generate("tpujob-operator", "op")
        kinds = [o["kind"] for o in objs]
        assert "CustomResourceDefinition" in kinds
        assert "Deployment" in kinds
        assert "ClusterRole" in kinds
        assert "ConfigMap" in kinds
        crd_obj = objs[kinds.index("CustomResourceDefinition")]
        assert crd_obj["metadata"]["name"] == "tpujobs.kubeflow-tpu.org"

    def test_no_tpu_anywhere(self):
        """The port's north star: no ``google.com/tpu`` request anywhere;
        the core and a benchmark job name only GPU shapes."""
        import json

        app = App()
        app.add("kubeflow-core", "core")
        app.add("tpu-cnn-benchmark", "bench")
        text = json.dumps(app.render())
        assert "google.com/tpu" not in text
        assert app.render()[-1]["spec"]["sliceType"] == "h100-8"


class TestCore:
    def test_core_aggregate(self):
        objs = default_registry.generate("kubeflow-core", "core")
        kinds = [o["kind"] for o in objs]
        # hub + operator + gateway + dashboards + version configmap
        assert kinds.count("Deployment") >= 4
        assert "StatefulSet" in kinds
        names = [o["metadata"]["name"] for o in objs]
        assert "kubeflow-version" in names
        assert "ambassador" in names

    def test_telemetry_opt_in(self):
        """Usage reporting must be opt-in (reference gated on reportUsage,
        kubeflow/core/spartakus.libsonnet:4-14)."""
        import json

        off = json.dumps(default_registry.generate("kubeflow-core", "core"))
        assert "usage-telemetry" not in off
        on = json.dumps(default_registry.generate(
            "kubeflow-core", "core", report_usage=True, usage_id="u-123"))
        assert "usage-telemetry" in on and "u-123" in on

    def test_nfs_opt_in(self):
        objs = default_registry.generate("kubeflow-core", "core", disks=True)
        kinds = [o["kind"] for o in objs]
        assert "StorageClass" in kinds
        assert "PersistentVolumeClaim" in kinds
        # The hub spawner must actually use the deployed NFS StorageClass.
        hub_cm = next(o for o in objs
                      if o["kind"] == "ConfigMap"
                      and "jupyterhub_config.py" in o.get("data", {}))
        assert "user_storage_class = 'nfs'" in hub_cm["data"]["jupyterhub_config.py"]

    def test_bad_gpu_count_fails_at_render(self):
        with pytest.raises(ValueError, match="GPUs per host"):
            base.gpu_resource_limits("h100-32", 16)  # 8 GPUs a host
        assert base.gpu_resource_limits("h100-32") == \
            {"limits": {"nvidia.com/gpu": 8}}
        assert base.gpu_resource_limits("a3-highgpu-4g") == \
            {"limits": {"nvidia.com/gpu": 4}}


class TestJupyterHub:
    def test_spawner_config_golden(self):
        from kubeflow_tpu_torch.manifests.jupyterhub import spawner_config

        cfg = spawner_config("dummy", "img:latest",
                             notebook_pvc_mount="/home/jovyan")
        assert "DummyAuthenticator" in cfg
        assert "claim-{username}" in cfg
        assert "nvidia.com/gpu" in cfg
        assert "google.com/tpu" not in cfg
        compile(cfg, "jupyterhub_config.py", "exec")  # must be valid python

    def test_iap_authenticator(self):
        from kubeflow_tpu_torch.manifests.jupyterhub import spawner_config

        cfg = spawner_config("iap", "img:latest")
        assert "x-goog-authenticated-user-email" in cfg
        compile(cfg, "jupyterhub_config.py", "exec")

    def test_hub_manifests(self):
        objs = default_registry.generate("jupyterhub", "hub")
        by_kind = {}
        for o in objs:
            by_kind.setdefault(o["kind"], []).append(o)
        assert len(by_kind["StatefulSet"]) == 1
        # headless svc for stable DNS + LB for ingress
        svcs = by_kind["Service"]
        assert any(s["spec"].get("clusterIP") == "None" for s in svcs)
        assert any(s["spec"].get("type") == "LoadBalancer" for s in svcs)
