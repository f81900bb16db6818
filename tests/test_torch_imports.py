"""The port stands alone: no JAX, flax, optax, msgpack, ml_dtypes or
kubeflow_tpu import anywhere in it or in chip_smoke.py, and no silent CPU
run."""

import ast
import importlib
from pathlib import Path

import pytest
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.generate import init_cache
from kubeflow_tpu_torch.models.inception import InceptionV3
from kubeflow_tpu_torch.models.resnet import ResNet50, ResNetConfig
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.serving.model_server import ModelServer

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes",
             "kubeflow_tpu")
SMALL = TransformerConfig(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
                          n_kv_heads=2, d_ff=32, head_dim=8,
                          dtype=torch.float32)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((REPO / "kubeflow_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imports(f) if _forbidden(m)]
    assert not bad, bad


def test_every_port_module_imports():
    """Each module of the port imports (nothing is built at import: the
    CUDA kernels and the data core build at first use), the modules of
    the training slice's record pipeline and checkpoints and the serving
    engine's copies of the JAX package's host modules among them."""
    root = REPO / "kubeflow_tpu_torch"
    names = sorted(
        ".".join(f.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__") for f in root.rglob("*.py"))
    for name in names:
        importlib.import_module(name)
    assert {"kubeflow_tpu_torch.data", "kubeflow_tpu_torch.data.loader",
            "kubeflow_tpu_torch.runtime.checkpoint",
            "kubeflow_tpu_torch.runtime.optim",
            "kubeflow_tpu_torch.runtime.tracing",
            "kubeflow_tpu_torch.serving.engine",
            "kubeflow_tpu_torch.serving.adapters",
            "kubeflow_tpu_torch.serving.prefix_cache"} <= set(names)


@pytest.mark.parametrize("module", ["serving/engine.py",
                                    "serving/prefix_cache.py",
                                    "serving/adapters.py",
                                    "runtime/tracing.py"])
def test_engine_slice_modules_import_nothing_of_jax(module):
    """The engine and the stdlib/numpy modules it needs are the port's
    own copies: none imports JAX or the JAX package."""
    path = REPO / "kubeflow_tpu_torch" / module
    imported = list(_imports(path))
    assert imported
    assert not [m for m in imported if _forbidden(m)]


def test_forbidden_prefix_does_not_match_the_port():
    assert _forbidden("kubeflow_tpu.serving.export")
    assert not _forbidden("kubeflow_tpu_torch.serving.export")


def test_default_device_is_cuda_or_an_error():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert ResNet50(num_classes=10, num_filters=8).head.weight.is_cuda
        assert InceptionV3(num_classes=10).logits.weight.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelServer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(SMALL, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNet50(num_classes=10, num_filters=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNetConfig(name="resnet18").build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InceptionV3(num_classes=10)
    assert resolve_device("cpu").type == "cpu"
    assert Transformer(SMALL, device="cpu").embed.device.type == "cpu"
    assert init_cache(SMALL, 1, 8, device="cpu")[0].device.type == "cpu"
