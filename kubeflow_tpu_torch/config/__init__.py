"""Typed parameter & prototype system.

The port's copy of kubeflow_tpu/config/__init__.py, importing nothing of the JAX
package.

Heir of the ksonnet prototype layer: the reference declares component
parameters via ``// @param`` / ``// @optionalParam`` comment annotations
(kubeflow/core/prototypes/all.jsonnet:4-20,
kubeflow/openmpi/prototypes/openmpi.jsonnet:5-32) and coerces
string-encoded lists/bools with util.toArray/toBool
(kubeflow/core/util.libsonnet:1-35).  Everything there is stringly-typed —
a known wart (user_guide.md:395-397).  Here params are typed dataclass
fields with declared coercions, docstrings, and validation, and prototypes
are callables registered in a Registry (heir of kubeflow/registry.yaml).
"""

from kubeflow_tpu_torch.config.params import (
    Param,
    ParamError,
    Prototype,
    param,
    to_bool,
    to_list,
)
from kubeflow_tpu_torch.config.registry import Registry, default_registry

__all__ = [
    "Param",
    "ParamError",
    "Prototype",
    "param",
    "to_bool",
    "to_list",
    "Registry",
    "default_registry",
]
