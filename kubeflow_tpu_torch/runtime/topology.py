"""GPU node shapes: the port of kubeflow_tpu/runtime/topology.py.

The JAX package models a TPU pod slice: an indivisible gang of hosts
wired by ICI, which the scheduler places whole or not at all.  The
port's counterpart is a gang of H100 hosts: one to eight GPUs on one
host (GKE's ``a3-highgpu-{1,2,4,8}g``), or several hosts of eight.  The
GPUs of one host share an NVLink domain (``nvlink_domain`` takes the
place of ``ici_mesh``); traffic between hosts rides the network.  A
worker process drives one GPU, so ``devices``, the world size
``MeshSpec.build`` sees, is the gang's GPU count.

This module is the one table of the card's peak: ``PEAK_BF16_FLOPS``
(NVIDIA's H100 SXM data sheet, dense bf16 without sparsity) gives both
``SliceTopology.bf16_tflops_per_chip`` and ``peak_bf16_flops``, the MFU
denominator of the training entry points when no ``KFT_SLICE_TYPE``
names a shape.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

# Published dense bf16 tensor-core peak per card (NVIDIA's data sheet,
# SXM part), keyed by a substring of torch.cuda.get_device_name(); the
# MFU denominator.  A card not listed reports no MFU.
PEAK_BF16_FLOPS = {"H100": 989e12}

# The H100 SXM's 80 GB of HBM3 (data sheet), in GiB.
H100_HBM_GIB = 80e9 / 2**30
# GPUs of one GKE a3-highgpu host at most, all in one NVLink domain.
GPUS_PER_HOST = 8


def peak_bf16_flops(device) -> float:
    """The card's bf16 peak FLOP/s from ``PEAK_BF16_FLOPS``, or 0 (no
    MFU) on the CPU or an unlisted card."""
    import torch

    if device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in PEAK_BF16_FLOPS.items() if k in name), 0.0)


def mfu_peak(slice_type: str, device) -> float:
    """MFU's peak FLOP/s a device: that of the shape ``slice_type`` (the
    worker's ``KFT_SLICE_TYPE``) names when it is set, as the JAX entry
    points take it, else the card's own (0 on the CPU: no MFU)."""
    if slice_type:
        return parse_slice_type(slice_type).bf16_tflops_per_chip * 1e12
    return peak_bf16_flops(device)


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """One gang shape.

    chips: GPUs in the gang (one worker process each).
    hosts: worker VMs (k8s pods) the gang spans; GPUs are evenly divided
      across hosts, and ``chips_per_host`` is a pod's ``nvidia.com/gpu``
      request.
    nvlink_domain: GPUs joined all to all by NVLink, as a shape (the
      GPUs of one host); collectives inside it ride NVLink, between
      hosts the network.
    """

    name: str
    generation: str
    chips: int
    hosts: int
    nvlink_domain: Tuple[int, ...]
    hbm_gib_per_chip: float = H100_HBM_GIB
    bf16_tflops_per_chip: float = PEAK_BF16_FLOPS["H100"] / 1e12

    @property
    def chips_per_host(self) -> int:
        return self.chips // self.hosts

    @property
    def devices(self) -> int:
        """The world size the runtime sees across the gang: one process
        a GPU."""
        return self.chips

    @property
    def is_cpu(self) -> bool:
        """CPU gangs (cpu-N): schedulable on any node; the E2E runs of
        clusters without GPUs."""
        return self.generation == "cpu"

    @property
    def machine_type(self) -> str:
        """The GKE machine type of one host (``a3-highgpu-8g``)."""
        if self.is_cpu:
            return ""
        return f"a3-highgpu-{self.chips_per_host}g"

    def k8s_node_selector(self) -> Dict[str, str]:
        if self.is_cpu:
            return {}
        return {"cloud.google.com/gke-accelerator": self.gke_accelerator()}

    def gke_accelerator(self) -> str:
        return {"h100": "nvidia-h100-80gb"}[self.generation]


def _h100(chips: int) -> SliceTopology:
    hosts = max(1, chips // GPUS_PER_HOST)
    return SliceTopology(
        name=f"h100-{chips}", generation="h100", chips=chips, hosts=hosts,
        nvlink_domain=(chips // hosts,))


# Registry of supported shapes: one host of 1, 2, 4 or 8 GPUs, then gangs
# of 8-GPU hosts.  Names count GPUs.
_TOPOLOGIES: Dict[str, SliceTopology] = {}
for topo in [_h100(n) for n in (1, 2, 4, 8, 16, 32, 64, 128)] + [
    # CPU gangs for GPU-less clusters (kind/minikube E2E): n
    # single-process hosts.
    SliceTopology(name=f"cpu-{n}", generation="cpu", chips=n, hosts=n,
                  nvlink_domain=(1,), hbm_gib_per_chip=0,
                  bf16_tflops_per_chip=1.0)
    for n in (1, 2, 4, 8)
]:
    _TOPOLOGIES[topo.name] = topo


def get_topology(name: str) -> SliceTopology:
    try:
        return _TOPOLOGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown slice type {name!r}; known: {sorted(_TOPOLOGIES)}"
        ) from None


def list_topologies() -> List[str]:
    return sorted(_TOPOLOGIES)


def parse_slice_type(name: str) -> SliceTopology:
    """Accept a registered name (``h100-16``), a GKE machine type of one
    host (``a3-highgpu-4g``) or hosts x GPUs a host (``h100-2x8``)."""
    if name in _TOPOLOGIES:
        return _TOPOLOGIES[name]
    match = re.fullmatch(r"a3-highgpu-(\d+)g", name)
    if match:
        return get_topology(f"h100-{match.group(1)}")
    match = re.fullmatch(r"(h100)-(\d+)x(\d+)", name)
    if match:
        hosts, per_host = int(match.group(2)), int(match.group(3))
        for topo in _TOPOLOGIES.values():
            if topo.generation == match.group(1) and topo.hosts == hosts \
                    and topo.chips_per_host == per_host:
                return topo
        raise ValueError(
            f"unsupported topology {name!r} ({hosts} hosts of {per_host} "
            f"GPUs, {hosts * per_host} GPUs)")
    raise ValueError(
        f"unknown slice type {name!r}; known: {sorted(_TOPOLOGIES)}"
    )


def fake_slice(n_devices: int, hosts: int = 1) -> SliceTopology:
    """A synthetic shape of ``n_devices`` ranks for CPU testing (the
    JAX package's fake slice: its devices there are fake CPU devices,
    here they are processes)."""
    return SliceTopology(
        name=f"fake-{n_devices}", generation="h100", chips=n_devices,
        hosts=hosts, nvlink_domain=(n_devices // hosts,))
