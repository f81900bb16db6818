"""Parallelism over several GPUs: the port of kubeflow_tpu/parallel/.

``mesh.py`` names the axes and maps a ``MeshSpec`` onto a
``torch.distributed`` ``DeviceMesh`` (one rank a GPU); ``ring.py`` is
ring attention over the ``sequence`` axis on the flash kernels;
``tensor.py`` holds the collectives of the ``tensor`` axis (Megatron's
column/row split, the vocab-parallel embedding and cross-entropy);
``pipeline.py`` is the GPipe schedule over the ``pipeline`` axis; and
``p2p.py`` the point-to-point transfers the ring and the pipeline share.
The ``expert`` axis is models/moe.py's: each rank holds a share of the
experts, marked with a ``TensorShard`` as the tensor slices are.
"""

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DATA,
    DEFAULT_RULES,
    EXPERT,
    FSDP,
    PIPELINE,
    SEQUENCE,
    TENSOR,
    MeshSpec,
    logical_spec,
)

__all__ = [
    "AXIS_ORDER",
    "DATA",
    "FSDP",
    "PIPELINE",
    "EXPERT",
    "SEQUENCE",
    "TENSOR",
    "DEFAULT_RULES",
    "MeshSpec",
    "logical_spec",
]
