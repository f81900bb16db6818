"""Prototype registry.

The port's copy of kubeflow_tpu/config/registry.py, importing nothing of the JAX
package.

Heir of the ksonnet registry (kubeflow/registry.yaml) + ``ks pkg install``:
packages register their prototypes here; an "app" selects components
(prototype instantiations with param overrides) and renders manifests.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from kubeflow_tpu_torch.config.params import ParamError, Prototype

_UNSET = object()


class Registry:
    def __init__(self) -> None:
        self._prototypes: Dict[str, Prototype] = {}

    def register(self, proto: Prototype) -> Prototype:
        if proto.name in self._prototypes:
            raise ParamError(f"prototype {proto.name!r} already registered")
        self._prototypes[proto.name] = proto
        return proto

    def get(self, name: str) -> Prototype:
        try:
            return self._prototypes[name]
        except KeyError:
            raise ParamError(
                f"unknown prototype {name!r}; available: {sorted(self._prototypes)}"
            ) from None

    def names(self) -> List[str]:
        return sorted(self._prototypes)

    def generate(self, prototype: str, component_name: str,
                 **overrides: Any) -> List[dict]:
        return self.get(prototype).generate(component_name, **overrides)


# The process-wide registry all manifest packages register into on import
# (importing kubeflow_tpu_torch.manifests populates it).
default_registry = Registry()


class App:
    """A deployable selection of components — heir of a ksonnet app dir.

    Components are (prototype, name, params) triples; ``render()`` is the
    equivalent of ``ks show default`` — the full manifest list ready to be
    applied to a cluster.
    """

    def __init__(self, namespace: str = "kubeflow",
                 registry: Optional[Registry] = None) -> None:
        self.namespace = namespace
        self.registry = registry or default_registry
        self.components: List[dict] = []

    def add(self, prototype: str, name: str, **params: Any) -> "App":
        # Validate eagerly so misconfigurations fail at add() time, like
        # `ks generate` did, not at render time.  Generators are pure, so a
        # trial render catches domain errors (e.g. unknown slice types) that
        # param-type coercion alone cannot.
        self.components.append(
            {"prototype": prototype, "name": name, "params": params}
        )
        try:
            self._render_component(self.components[-1])
        except Exception:
            self.components.pop()
            raise
        return self

    def set_param(self, component: str, key: str, value: Any) -> "App":
        """Heir of ``ks param set <component> <key> <value>``."""
        for comp in self.components:
            if comp["name"] == component:
                old = comp["params"].get(key, _UNSET)
                comp["params"][key] = value
                try:
                    self._render_component(comp)
                except Exception:
                    if old is _UNSET:
                        del comp["params"][key]
                    else:
                        comp["params"][key] = old
                    raise
                return self
        raise ParamError(f"no component named {component!r}")

    def _render_component(self, comp: dict) -> List[dict]:
        params = dict(comp["params"])
        proto = self.registry.get(comp["prototype"])
        if "namespace" in proto._by_name:
            params.setdefault("namespace", self.namespace)
        return proto.generate(comp["name"], **params)

    def render(self) -> List[dict]:
        objects: List[dict] = []
        for comp in self.components:
            objects.extend(self._render_component(comp))
        return objects


