"""The port's node shapes (kubeflow_tpu_torch/runtime/topology.py)
against the JAX package's slice model, ``MeshSpec.build(topology=)``,
and the one peak table the training entry points take MFU's peak from.

Where the meaning carries over the port equals JAX: a fake slice's and
a ``cpu-N`` gang's chips, hosts, devices, memory and peak, and the
message of a topology whose device count the runtime does not see.  The
H100 shapes are the port's own: GKE's ``a3-highgpu-{1,2,4,8}g`` hosts
and gangs of 8-GPU hosts, NVIDIA's data-sheet peak and memory."""

import jax
import pytest
import torch

from kubeflow_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from kubeflow_tpu.runtime import topology as jax_topology
from kubeflow_tpu_torch.parallel.mesh import MeshSpec
from kubeflow_tpu_torch.runtime import topology
from kubeflow_tpu_torch.tools import train_lm

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

SHARED = ("name", "chips", "hosts", "chips_per_host", "devices")
TINY_ARGS = ["--d-model", "32", "--n-layers", "2", "--n-heads", "4",
             "--n-kv-heads", "2", "--d-ff", "64", "--head-dim", "8",
             "--vocab-size", "64", "--seq-len", "16",
             "--batch-size-per-device", "1", "--steps", "2",
             "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("n,hosts", [(1, 1), (4, 1), (8, 2), (16, 4)])
def test_fake_slice_equals_jax(n, hosts):
    mine, theirs = topology.fake_slice(n, hosts), \
        jax_topology.fake_slice(n, hosts)
    for field in SHARED:
        assert getattr(mine, field) == getattr(theirs, field), field
    assert not mine.is_cpu and not theirs.is_cpu


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_cpu_shapes_equal_jax(n):
    name = f"cpu-{n}"
    mine, theirs = topology.get_topology(name), \
        jax_topology.get_topology(name)
    for field in SHARED + ("hbm_gib_per_chip", "bf16_tflops_per_chip",
                           "is_cpu", "generation"):
        assert getattr(mine, field) == getattr(theirs, field), field
    assert mine.k8s_node_selector() == theirs.k8s_node_selector() == {}
    assert topology.parse_slice_type(name) is mine


@pytest.mark.parametrize("name,hosts,per_host", [
    ("h100-1", 1, 1), ("h100-2", 1, 2), ("h100-4", 1, 4), ("h100-8", 1, 8),
    ("h100-16", 2, 8), ("h100-64", 8, 8)])
def test_h100_shapes(name, hosts, per_host):
    topo = topology.get_topology(name)
    assert (topo.hosts, topo.chips_per_host) == (hosts, per_host)
    assert topo.devices == topo.chips == hosts * per_host
    assert topo.nvlink_domain == (per_host,)
    assert topo.machine_type == f"a3-highgpu-{per_host}g"
    assert topo.k8s_node_selector() == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert topo.bf16_tflops_per_chip * 1e12 == \
        topology.PEAK_BF16_FLOPS["H100"] == 989e12
    assert topo.hbm_gib_per_chip == pytest.approx(74.506, abs=1e-3)
    assert topology.parse_slice_type(f"h100-{hosts}x{per_host}") is topo
    if hosts == 1:
        assert topology.parse_slice_type(topo.machine_type) is topo


@pytest.mark.parametrize("name", ["v5e-1", "h100-3", "h100-3x8",
                                  "a3-highgpu-3g", "gpu"])
def test_unknown_shapes_raise(name):
    with pytest.raises(ValueError):
        topology.parse_slice_type(name)


def test_list_topologies_is_sorted_and_whole():
    names = topology.list_topologies()
    assert names == sorted(names)
    assert {"h100-1", "h100-8", "h100-128", "cpu-1", "cpu-8"} <= set(names)


def test_build_mismatch_message_equals_jax():
    """A topology of 16 devices on a job of one rank: the port raises
    JAX's ValueError, word for word, before any process group is made."""
    import torch.distributed as dist

    before = dist.is_initialized()
    with pytest.raises(ValueError) as theirs:
        JaxMeshSpec(data=-1).build(jax.devices()[:1],
                                   topology=jax_topology.fake_slice(16))
    with pytest.raises(ValueError) as mine:
        MeshSpec(data=-1).build("cpu", topology=topology.fake_slice(16))
    assert str(mine.value) == str(theirs.value)
    assert dist.is_initialized() == before


@pytest.mark.parametrize("slice_type,want", [
    ("h100-1", 989e12), ("h100-16", 989e12), ("cpu-2", 1e12), ("", 0.0)])
def test_mfu_peak(slice_type, want):
    """MFU's peak: the named shape's, as the JAX entry points take it;
    without one the card's (none on the CPU)."""
    assert topology.mfu_peak(slice_type, torch.device("cpu")) == want
    if slice_type.startswith("cpu"):
        assert want == jax_topology.parse_slice_type(
            slice_type).bf16_tflops_per_chip * 1e12


@pytest.mark.parametrize("slice_type", ["h100-1", ""])
def test_train_lm_takes_mfu_peak_from_the_slice_type(monkeypatch,
                                                     slice_type):
    monkeypatch.setenv("KFT_SLICE_TYPE", slice_type)
    monkeypatch.setenv("KFT_PROCESS_ID", "0")
    monkeypatch.delenv("KFT_NUM_PROCESSES", raising=False)
    trainer = train_lm.run(TINY_ARGS)
    last = trainer.metrics.history[-1]
    if slice_type:
        assert trainer.peak_flops_per_chip == 989e12
        assert "mfu" in last  # 0.0 at 4 decimals on this tiny model
    else:
        assert trainer.peak_flops_per_chip == 0.0
        assert "mfu" not in last
