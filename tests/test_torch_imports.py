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

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

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
            "kubeflow_tpu_torch.serving.prefix_cache",
            "kubeflow_tpu_torch.analysis",
            "kubeflow_tpu_torch.analysis.core",
            "kubeflow_tpu_torch.analysis.capture",
            "kubeflow_tpu_torch.analysis.faultsites",
            "kubeflow_tpu_torch.models.moe",
            "kubeflow_tpu_torch.serving.grpc_server",
            "kubeflow_tpu_torch.serving.tf_compat",
            "kubeflow_tpu_torch.serving.protos.prediction_pb2",
            "kubeflow_tpu_torch.serving.protos.tf_compat_pb2",
            "kubeflow_tpu_torch.runtime.hfta",
            "kubeflow_tpu_torch.runtime.member_map",
            "kubeflow_tpu_torch.parallel",
            "kubeflow_tpu_torch.parallel.mesh",
            "kubeflow_tpu_torch.parallel.p2p",
            "kubeflow_tpu_torch.parallel.pipeline",
            "kubeflow_tpu_torch.parallel.ring",
            "kubeflow_tpu_torch.parallel.tensor",
            "kubeflow_tpu_torch.runtime.bootstrap",
            "kubeflow_tpu_torch.testing.ranks",
            "kubeflow_tpu_torch.testing.ring_check",
            "kubeflow_tpu_torch.serving.sharding",
            "kubeflow_tpu_torch.serving.lockstep",
            "kubeflow_tpu_torch.version",
            "kubeflow_tpu_torch.runtime.topology",
            "kubeflow_tpu_torch.runtime.profiling",
            "kubeflow_tpu_torch.tools.xplane_summary",
            "kubeflow_tpu_torch.tools.launcher",
            "kubeflow_tpu_torch.tools.train_torch",
            "kubeflow_tpu_torch.tools.telemetry"} | set(
                CONTROL_PLANE) | set(DEPLOYMENT) | {
                    "kubeflow_tpu_torch.testing.e2e"} <= set(names)


# The control plane (the fleet tier, the operator, the cluster scheduler
# and their Kubernetes transport): stdlib-only copies of the JAX
# package's modules.
CONTROL_PLANE = [
    "kubeflow_tpu_torch.operator", "kubeflow_tpu_torch.operator.kube",
    "kubeflow_tpu_torch.operator.crd", "kubeflow_tpu_torch.operator.kube_http",
    "kubeflow_tpu_torch.operator.kube_real",
    "kubeflow_tpu_torch.operator.gang",
    "kubeflow_tpu_torch.operator.reconciler",
    "kubeflow_tpu_torch.operator.main",
    "kubeflow_tpu_torch.scheduler", "kubeflow_tpu_torch.scheduler.preempt",
    "kubeflow_tpu_torch.scheduler.policy",
    "kubeflow_tpu_torch.scheduler.queue", "kubeflow_tpu_torch.scheduler.fuse",
    "kubeflow_tpu_torch.scheduler.colocate",
    "kubeflow_tpu_torch.testing.fake_apiserver",
    "kubeflow_tpu_torch.fleet", "kubeflow_tpu_torch.fleet.endpoints",
    "kubeflow_tpu_torch.fleet.router", "kubeflow_tpu_torch.fleet.autoscaler",
    "kubeflow_tpu_torch.fleet.main"]


# The deployment surface (the typed params and registry, every manifest
# package, the bootstrapper and the CLI) and the test harness's JUnit
# report and lock-order sanitizer: stdlib-only copies of the JAX
# package's modules.
DEPLOYMENT = [
    "kubeflow_tpu_torch.config", "kubeflow_tpu_torch.config.params",
    "kubeflow_tpu_torch.config.registry",
    "kubeflow_tpu_torch.manifests", "kubeflow_tpu_torch.manifests.base",
    "kubeflow_tpu_torch.manifests.tpujob", "kubeflow_tpu_torch.manifests.torch",
    "kubeflow_tpu_torch.manifests.serving",
    "kubeflow_tpu_torch.manifests.jupyterhub",
    "kubeflow_tpu_torch.manifests.core",
    "kubeflow_tpu_torch.manifests.tensorboard",
    "kubeflow_tpu_torch.manifests.addons", "kubeflow_tpu_torch.manifests.certs",
    "kubeflow_tpu_torch.manifests.iap", "kubeflow_tpu_torch.manifests.endpoints",
    "kubeflow_tpu_torch.manifests.examples",
    "kubeflow_tpu_torch.tools.bootstrap", "kubeflow_tpu_torch.tools.cli",
    "kubeflow_tpu_torch.testing.junit", "kubeflow_tpu_torch.testing.lockcheck"]


@pytest.mark.parametrize("module", CONTROL_PLANE + DEPLOYMENT)
def test_control_plane_modules_import_neither_jax_nor_torch(module):
    """The fleet router, endpoint registry, autoscaler and entry point,
    the operator (gang scheduler, reconciler, entry point), the cluster
    scheduler, the TPUJob spec, the kube clients and the fake apiserver
    import nothing of JAX or the JAX package, and no torch at module
    level (the registry's gRPC probe imports the serving package only
    when an endpoint is gRPC-only)."""
    rel = module.replace(".", "/")
    path = REPO / (rel + ".py")
    if not path.exists():
        path = REPO / rel / "__init__.py"
    tree = ast.parse(path.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import)
             for a in n.names] + [n.module or "" for n in top
                                  if isinstance(n, ast.ImportFrom)]
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert not [m for m in names if m.split(".")[0] == "torch"]


def test_cli_and_renderers_load_no_torch():
    """The deployment CLI renders, bootstraps and judges checkpoints
    without torch or JAX: importing it (and so every manifest package)
    loads neither; ``checkpoints`` imports the port's checkpoint module
    only when it runs."""
    import subprocess
    import sys

    code = ("import sys, kubeflow_tpu_torch.tools.cli, "
            "kubeflow_tpu_torch.tools.bootstrap, "
            "kubeflow_tpu_torch.testing.lockcheck, "
            "kubeflow_tpu_torch.testing.junit; "
            "print(sorted(m for m in ('torch', 'jax', 'kubeflow_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_operator_and_scheduler_load_no_torch():
    """The operator's entry point, reconciler and the cluster scheduler
    run without torch: importing them loads none (the reconciler reads
    the worker env contract from runtime/bootstrap.py, which imports
    torch only when a worker starts its process group)."""
    import subprocess
    import sys

    code = ("import sys, kubeflow_tpu_torch.operator.main, "
            "kubeflow_tpu_torch.operator.reconciler, "
            "kubeflow_tpu_torch.scheduler; "
            "print(sorted(m for m in ('torch', 'jax', 'kubeflow_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_e2e_twins_import_nothing_of_jax():
    imported = list(_imports(REPO / "kubeflow_tpu_torch/testing/e2e.py"))
    assert imported
    assert not [m for m in imported if _forbidden(m)]


ANALYSIS = sorted(p.name for p in
                  (REPO / "kubeflow_tpu_torch" / "analysis").glob("*.py"))


@pytest.mark.parametrize("module", ANALYSIS)
def test_analysis_modules_import_only_the_stdlib_and_themselves(module):
    """The port's analyzer is a stdlib-only copy: each module imports the
    standard library and ``kubeflow_tpu_torch.analysis`` and nothing
    else, neither the JAX package's analyzer nor torch."""
    import sys

    path = REPO / "kubeflow_tpu_torch" / "analysis" / module
    imported = [m for m in _imports(path) if m != "__future__"]
    assert imported
    for m in imported:
        top = m.split(".")[0]
        assert m.startswith("kubeflow_tpu_torch.analysis") or \
            top in sys.stdlib_module_names, (module, m)


@pytest.mark.parametrize("module", ["serving/engine.py",
                                    "serving/prefix_cache.py",
                                    "serving/adapters.py",
                                    "runtime/tracing.py",
                                    "serving/grpc_server.py",
                                    "serving/tf_compat.py",
                                    "serving/protos/prediction_pb2.py",
                                    "serving/protos/tf_compat_pb2.py",
                                    "models/moe.py"])
def test_engine_slice_modules_import_nothing_of_jax(module):
    """The engine, the gRPC face and the MoE MLP, and the stdlib/numpy
    modules they need, are the port's own copies: none imports JAX or
    the JAX package."""
    path = REPO / "kubeflow_tpu_torch" / module
    imported = list(_imports(path))
    assert imported
    assert not [m for m in imported if _forbidden(m)]


PARALLEL_SLICE = ["parallel/__init__.py", "parallel/mesh.py",
                  "parallel/ring.py", "parallel/tensor.py",
                  "runtime/bootstrap.py",
                  "runtime/train.py", "testing/ranks.py",
                  "testing/ring_check.py"]


SERVING_MESH_SLICE = ["serving/sharding.py", "serving/lockstep.py",
                      "serving/main.py", "serving/programs.py"]


@pytest.mark.parametrize("module", SERVING_MESH_SLICE)
def test_serving_mesh_modules_import_nothing_of_jax(module):
    """Tensor-parallel decode (the serving mesh, its rule table and
    placement, the lockstep channel, and the entry point that joins the
    job) imports neither JAX nor the JAX package: its rule table and
    flag grammar are the port's own copies of kubeflow_tpu/serving/
    sharding.py's."""
    imported = list(_imports(REPO / "kubeflow_tpu_torch" / module))
    assert imported
    assert not [m for m in imported if _forbidden(m)]


@pytest.mark.parametrize("module", PARALLEL_SLICE)
def test_parallel_slice_modules_import_nothing_of_jax(module):
    """The mesh, the ring, tensor parallelism's operators, the NCCL
    bootstrap (with its own copy of ``kubeflow_tpu/tools/train_torch.py``'s
    ``torch_dist_env``), the mesh trainer and the rank launcher import
    neither JAX, flax or optax
    nor anything of the JAX package, whose train_torch tool among it."""
    imported = list(_imports(REPO / "kubeflow_tpu_torch" / module))
    assert imported
    assert not [m for m in imported if _forbidden(m)]
    assert "kubeflow_tpu.tools.train_torch" not in imported


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


def test_serving_entry_point_imports_grpc_only_when_asked():
    """serving/main.py imports the gRPC face inside the start-up that asks
    for it: a REST-only server (``--grpc_port -1``) runs without grpcio
    on the machine."""
    path = REPO / "kubeflow_tpu_torch" / "serving" / "main.py"
    tree = ast.parse(path.read_text())
    top = [node for node in tree.body
           if isinstance(node, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top for a in n.names] + [
        n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if "grpc" in m], names
    assert "kubeflow_tpu_torch.serving.grpc_server" in set(_imports(path))
