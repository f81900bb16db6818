"""Golden-style tests for the port's widened manifest packages (serving,
tensorboard, iap, addons, examples, torch): the twins of
tests/test_manifest_packages.py in GPU form."""

import pytest
import torch
import yaml

import kubeflow_tpu_torch.manifests  # noqa: F401 — registers prototypes
from kubeflow_tpu_torch.config.registry import App, default_registry
from kubeflow_tpu_torch.manifests.base import to_yaml
from kubeflow_tpu_torch.manifests.iap import is_cloud_endpoint

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)


EXPECTED_PROTOTYPES = {
    "argo", "cert-manager", "cloud-endpoints", "gcp-credentials-pod-preset",
    "iap-ingress", "jupyterhub", "kubeflow-core", "pachyderm", "seldon",
    "tensorboard", "torch-xla-job", "tpu-cnn-benchmark", "tpu-job",
    "tpu-job-simple", "tpu-serving", "tpu-serving-simple",
    "tpu-serving-with-istio", "tpujob-operator",
}


def test_registry_has_all_packages():
    assert EXPECTED_PROTOTYPES <= set(default_registry.names())


def kinds(objs):
    return [o["kind"] for o in objs]


class TestServing:
    def test_default_render(self):
        objs = default_registry.generate("tpu-serving", "mnist",
                                         model_name="mnist")
        assert kinds(objs) == ["Deployment", "Service"]
        deploy, svc = objs
        args = deploy["spec"]["template"]["spec"]["containers"][0]["args"]
        assert "--model_name=mnist" in args
        assert "getambassador.io/config" in svc["metadata"]["annotations"]
        route = svc["metadata"]["annotations"]["getambassador.io/config"]
        assert "/models/mnist/" in route

    def test_s3_mixin_env(self):
        objs = default_registry.generate(
            "tpu-serving", "m", storage_type="s3")
        env = objs[0]["spec"]["template"]["spec"]["containers"][0]["env"]
        names = {e["name"] for e in env}
        assert {"AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_REGION",
                "S3_USE_HTTPS", "S3_VERIFY_SSL", "S3_ENDPOINT"} <= names
        keyed = [e for e in env if e["name"] == "AWS_ACCESS_KEY_ID"][0]
        assert keyed["valueFrom"]["secretKeyRef"]["name"] == "s3-credentials"

    def test_gcp_mixin_mount(self):
        objs = default_registry.generate(
            "tpu-serving", "m", storage_type="gcp")
        tmpl = objs[0]["spec"]["template"]["spec"]
        env = tmpl["containers"][0]["env"]
        assert any(e["name"] == "GOOGLE_APPLICATION_CREDENTIALS"
                   for e in env)
        assert tmpl["volumes"][0]["secret"]["secretName"] == "user-gcp-sa"

    def test_tpu_serving_gets_gpu_resources(self):
        objs = default_registry.generate(
            "tpu-serving", "m", slice_type="h100-1")
        tmpl = objs[0]["spec"]["template"]["spec"]
        limits = tmpl["containers"][0]["resources"]["limits"]
        assert limits == {"nvidia.com/gpu": 1}
        assert tmpl["nodeSelector"] == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}

    def test_no_tpu_anywhere(self):
        """The port's north star: no ``google.com/tpu`` anywhere, and
        every accelerator request is ``nvidia.com/gpu``."""
        app = App()
        for proto in sorted(EXPECTED_PROTOTYPES):
            app.add(proto, f"x-{proto}")
        app.add("tpu-serving", "gpu-serving", slice_type="h100-8")
        rendered = to_yaml(app.render())
        assert "google.com/tpu" not in rendered
        assert "nvidia.com/gpu" in rendered
        requests = [key for obj in app.render()
                    for key in _resource_names(obj)]
        assert requests and set(requests) <= {"cpu", "memory",
                                              "nvidia.com/gpu"}, requests


def _resource_names(obj):
    """Every resource name a container asks for, anywhere in ``obj``."""
    if isinstance(obj, dict):
        for key in ("limits", "requests"):
            if isinstance(obj.get(key), dict):
                yield from obj[key]
        for value in obj.values():
            yield from _resource_names(value)
    elif isinstance(obj, list):
        for value in obj:
            yield from _resource_names(value)


class TestTensorboard:
    def test_render(self):
        objs = default_registry.generate("tensorboard", "tb",
                                         log_dir="gs://bucket/logs",
                                         storage_type="gcp")
        deploy, svc = objs
        cmd = deploy["spec"]["template"]["spec"]["containers"][0]["command"]
        assert "--logdir=gs://bucket/logs" in cmd
        assert "/tensorboard/tb/" in \
            svc["metadata"]["annotations"]["getambassador.io/config"]


class TestIAP:
    def test_cloud_endpoint_detection(self):
        assert is_cloud_endpoint("kf.endpoints.proj.cloud.goog")
        assert not is_cloud_endpoint("kubeflow.example.com")

    def test_render_kinds(self):
        objs = default_registry.generate("iap-ingress", "platform")
        assert set(kinds(objs)) == {
            "BackendConfig", "ManagedCertificate", "Service", "Ingress",
            "Deployment",
        }
        ingress = [o for o in objs if o["kind"] == "Ingress"][0]
        assert ingress["spec"]["rules"][0]["host"].endswith("cloud.goog")


class TestAddons:
    def test_argo(self):
        objs = default_registry.generate("argo", "argo")
        assert "CustomResourceDefinition" in kinds(objs)
        crd = [o for o in objs if o["kind"] == "CustomResourceDefinition"][0]
        assert crd["spec"]["group"] == "argoproj.io"

    def test_seldon_and_pachyderm_render(self):
        for proto in ("seldon", "pachyderm"):
            objs = default_registry.generate(proto, proto)
            assert len(objs) >= 4

    def test_credentials_preset(self):
        objs = default_registry.generate(
            "gcp-credentials-pod-preset", "creds")
        assert objs[0]["kind"] == "PodPreset"
        env = objs[0]["spec"]["env"]
        assert env[0]["name"] == "GOOGLE_APPLICATION_CREDENTIALS"


class TestTorchProfile:
    def test_torch_job_is_tpujob_with_cuda_image_and_no_pjrt_env(self):
        objs = default_registry.generate("torch-xla-job", "bert")
        cr = objs[0]
        assert cr["kind"] == "TPUJob"
        worker = cr["spec"]["worker"]
        assert worker["image"] == \
            "ghcr.io/kubeflow-tpu-torch/torch-cuda:latest"
        assert not worker.get("env")
        assert cr["spec"]["sliceType"] == "h100-8"


class TestExamples:
    def test_job_simple(self):
        objs = default_registry.generate("tpu-job-simple", "hello")
        assert objs[0]["spec"]["sliceType"] == "h100-1"

    def test_serving_simple_delegates(self):
        objs = default_registry.generate("tpu-serving-simple", "inception")
        assert kinds(objs) == ["Deployment", "Service"]

    def test_serving_with_istio(self):
        objs = default_registry.generate("tpu-serving-with-istio",
                                         "inception")
        assert kinds(objs) == ["Deployment", "Service", "DestinationRule",
                               "VirtualService"]


class TestServingIstio:
    """Heir of the RouteRule + sidecar-inject surface
    (kubeflow/tf-serving/tf-serving.libsonnet:287-305,
    examples/prototypes/tf-serving-with-istio.jsonnet:106)."""

    def test_sidecar_inject_and_version_label(self):
        objs = default_registry.generate(
            "tpu-serving", "m", istio_enable=True, istio_version="v2")
        deploy = objs[0]
        tmpl = deploy["spec"]["template"]
        assert tmpl["metadata"]["annotations"][
            "sidecar.istio.io/inject"] == "true"
        assert tmpl["metadata"]["labels"]["version"] == "v2"
        # Selector must stay version-free: it is immutable on the API
        # server, and the canary flow re-renders with a new version.
        assert "version" not in deploy["spec"]["selector"]["matchLabels"]
        svc = objs[1]
        assert "version" not in svc["spec"]["selector"]

    def test_route_objects_target_the_subset(self):
        objs = default_registry.generate(
            "tpu-serving", "m", istio_enable=True)
        dr = [o for o in objs if o["kind"] == "DestinationRule"][0]
        vs = [o for o in objs if o["kind"] == "VirtualService"][0]
        assert dr["spec"]["subsets"] == [
            {"name": "v1", "labels": {"version": "v1"}}]
        route = vs["spec"]["http"][0]["route"][0]
        assert route["destination"] == {"host": "m", "subset": "v1"}
        assert route["weight"] == 100

    def test_istio_off_by_default(self):
        objs = default_registry.generate("tpu-serving", "m")
        assert kinds(objs) == ["Deployment", "Service"]
        tmpl = objs[0]["spec"]["template"]["metadata"]["annotations"]
        # No istio injection by default; prometheus scrape annotations
        # are always present (pod + Service, either discovery mode).
        assert "sidecar.istio.io/inject" not in tmpl
        assert tmpl["prometheus.io/scrape"] == "true"
        assert objs[1]["metadata"]["annotations"][
            "prometheus.io/port"] == "8000"


class TestCertManager:
    """Heir of kubeflow/core/cert-manager.libsonnet:1-182."""

    def test_full_render(self):
        objs = default_registry.generate("cert-manager", "certs")
        ks = kinds(objs)
        assert ks.count("CustomResourceDefinition") == 3
        assert {"ServiceAccount", "ClusterRole", "ClusterRoleBinding",
                "Deployment", "Issuer"} <= set(ks)
        issuer = [o for o in objs if o["kind"] == "Issuer"][0]
        acme = issuer["spec"]["acme"]
        assert acme["server"].startswith("https://acme-v02")
        assert acme["solvers"] == [{"http01": {"ingress": {}}}]
        assert acme["privateKeySecretRef"]["name"] == \
            "letsencrypt-prod-secret"

    def test_crd_scopes(self):
        objs = default_registry.generate("cert-manager", "certs")
        scopes = {o["spec"]["names"]["kind"]: o["spec"]["scope"]
                  for o in objs
                  if o["kind"] == "CustomResourceDefinition"}
        assert scopes == {"Certificate": "Namespaced",
                          "Issuer": "Namespaced",
                          "ClusterIssuer": "Cluster"}

    def test_iap_cert_manager_tls(self):
        objs = default_registry.generate(
            "iap-ingress", "iap", tls_type="cert-manager",
            hostname="kf.example.com")
        cert = [o for o in objs if o["kind"] == "Certificate"][0]
        assert cert["apiVersion"] == "cert-manager.io/v1"
        assert cert["spec"]["dnsNames"] == ["kf.example.com"]
        ingress = [o for o in objs if o["kind"] == "Ingress"][0]
        # No ingress-shim annotation: the explicit Certificate is the
        # single owner of the TLS secret.
        assert "annotations" not in ingress["metadata"]
        assert ingress["spec"]["tls"] == [
            {"hosts": ["kf.example.com"],
             "secretName": "platform-cert-tls"}]

    def test_iap_rejects_unknown_tls_type(self):
        with pytest.raises(Exception):
            default_registry.generate("iap-ingress", "iap", tls_type="nope")


class TestCloudEndpoints:
    """Heir of kubeflow/core/cloud-endpoints.libsonnet:1-332."""

    def test_controller_render(self):
        objs = default_registry.generate("cloud-endpoints", "cloudep")
        ks = kinds(objs)
        assert ks == ["CustomResourceDefinition", "ServiceAccount",
                      "ClusterRole", "ClusterRoleBinding", "Deployment",
                      "Service"]
        deploy = [o for o in objs if o["kind"] == "Deployment"][0]
        c = deploy["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e["value"] for e in c["env"]}
        assert env["GOOGLE_APPLICATION_CREDENTIALS"] == \
            "/var/run/secrets/sa/sa-key.json"

    def test_hostname_renders_cr(self):
        objs = default_registry.generate(
            "cloud-endpoints", "cloudep",
            hostname="kubeflow.endpoints.myproj.cloud.goog")
        cr = [o for o in objs if o["kind"] == "CloudEndpoint"][0]
        assert cr["metadata"]["name"] == "kubeflow"
        assert cr["spec"]["project"] == "myproj"
        assert cr["spec"]["targetIngress"]["name"] == "iap-ingress"

    def test_non_cloud_goog_hostname_rejected(self):
        with pytest.raises(Exception):
            default_registry.generate("cloud-endpoints", "cloudep",
                                      hostname="kf.example.com")


class TestWholeAppRenders:
    def test_everything_is_valid_yaml(self):
        app = App()
        for proto in sorted(EXPECTED_PROTOTYPES):
            app.add(proto, f"c-{proto}")
        docs = list(yaml.safe_load_all(to_yaml(app.render())))
        assert len(docs) >= 30
        for doc in docs:
            assert "kind" in doc and "apiVersion" in doc
