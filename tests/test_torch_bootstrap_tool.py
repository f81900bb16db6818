"""The port's bootstrap installer (heir of bootstrap/.../server_test.go):
the twins of tests/test_bootstrap_tool.py on GPU gang shapes."""

import torch
import yaml

from kubeflow_tpu_torch.tools.bootstrap import BootConfig, render

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)


def test_default_config_renders_platform():
    cfg = BootConfig(platform="generic")
    objs = render(cfg)
    kinds = [o["kind"] for o in objs]
    assert kinds[0] == "Namespace"
    assert "CustomResourceDefinition" in kinds  # operator CRD
    assert kinds.count("Deployment") >= 2


def test_gke_platform_adds_admin_binding_and_cloud_param():
    cfg = BootConfig(platform="gke")
    objs = render(cfg)
    assert objs[-1]["kind"] == "ClusterRoleBinding"
    assert objs[-1]["roleRef"]["name"] == "cluster-admin"


def test_yaml_config_roundtrip(tmp_path):
    path = tmp_path / "boot.yaml"
    path.write_text(yaml.safe_dump({
        "bootstrap": {
            "namespace": "ml",
            "platform": "generic",
            "components": [
                {"prototype": "tpujob-operator", "name": "op"},
                {"prototype": "tpu-job", "name": "train",
                 "params": {"slice_type": "h100-32"}},
            ],
        },
    }))
    cfg = BootConfig.load(path)
    assert cfg.namespace == "ml"
    objs = render(cfg)
    assert objs[0]["metadata"]["name"] == "ml"
    tpujob = [o for o in objs if o["kind"] == "TPUJob"][0]
    assert tpujob["spec"]["sliceType"] == "h100-32"
