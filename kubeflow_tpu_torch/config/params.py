"""Typed parameters for component prototypes.

The port's copy of kubeflow_tpu/config/params.py, importing nothing of the JAX
package.

The reference's parameter surface is ksonnet ``// @param name type default``
comment annotations parsed by the ks CLI (kubeflow/core/prototypes/all.jsonnet:4-20),
with string->bool/list coercion helpers (kubeflow/core/util.libsonnet:1-35,
tested in kubeflow/core/tests/util_test.jsonnet:1-22).  This module keeps the
*capability* — prototype-with-defaults + late param override + introspectable
docs — as first-class typed Python objects.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Callable, Dict, List, Optional, Sequence


class ParamError(ValueError):
    """Raised for unknown, missing, or uncoercible parameter values."""


def to_bool(value: Any) -> bool:
    """Coerce user-supplied value to bool.

    Same semantics as the reference's util.toBool (kubeflow/core/util.libsonnet:4-17):
    true booleans pass through, "true" (case-insensitive) is True, nonzero
    numbers are True, everything else False — but unknown strings raise here
    instead of silently meaning False.
    """
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)):
        return value != 0
    if isinstance(value, str):
        lowered = value.strip().lower()
        if lowered in ("true", "yes", "1", "on"):
            return True
        if lowered in ("false", "no", "0", "off", ""):
            return False
    raise ParamError(f"cannot coerce {value!r} to bool")


def to_list(value: Any, sep: str = ",") -> List[str]:
    """Coerce comma-separated string to list (util.toArray, util.libsonnet:19-30)."""
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return [str(v) for v in value]
    if isinstance(value, str):
        stripped = value.strip()
        if not stripped:
            return []
        return [part.strip() for part in stripped.split(sep)]
    raise ParamError(f"cannot coerce {value!r} to list")


_COERCERS: Dict[type, Callable[[Any], Any]] = {
    bool: to_bool,
    int: lambda v: int(v),
    float: lambda v: float(v),
    str: lambda v: str(v),
    list: to_list,
}


@dataclasses.dataclass
class Param:
    """One typed parameter: name, type, default, documentation.

    ``required=True`` mirrors ``// @param`` (no default); ``required=False``
    mirrors ``// @optionalParam``.
    """

    name: str
    type: type = str
    default: Any = None
    doc: str = ""
    required: bool = False
    choices: Optional[Sequence[Any]] = None

    def coerce(self, value: Any) -> Any:
        if value is None:
            if self.required:
                raise ParamError(f"parameter {self.name!r} is required")
            value = self.default
        if value is not None:
            origin = typing.get_origin(self.type) or self.type
            coercer = _COERCERS.get(origin)
            if coercer is not None and not isinstance(value, origin):
                try:
                    value = coercer(value)
                except (TypeError, ValueError) as exc:
                    raise ParamError(
                        f"parameter {self.name!r}: cannot coerce {value!r} to "
                        f"{self.type.__name__}: {exc}"
                    ) from exc
        if self.choices is not None and value not in self.choices:
            raise ParamError(
                f"parameter {self.name!r}: {value!r} not in {list(self.choices)}"
            )
        return value


def param(
    name: str,
    type: type = str,  # noqa: A002 - mirrors Param field name
    default: Any = None,
    doc: str = "",
    required: bool = False,
    choices: Optional[Sequence[Any]] = None,
) -> Param:
    return Param(name=name, type=type, default=default, doc=doc,
                 required=required, choices=choices)


class Prototype:
    """A named component generator: declared params + a generate function.

    Heir of one ksonnet prototype file: ``ks generate <prototype> <name>``
    becomes ``proto.generate(name, **overrides) -> list[k8s object dict]``.
    """

    def __init__(
        self,
        name: str,
        params: Sequence[Param],
        generate: Callable[..., List[dict]],
        doc: str = "",
    ):
        self.name = name
        self.params = list(params)
        self._by_name = {p.name: p for p in self.params}
        if len(self._by_name) != len(self.params):
            raise ParamError(f"prototype {name!r} has duplicate param names")
        self._generate = generate
        self.doc = doc

    def resolve(self, overrides: Dict[str, Any]) -> Dict[str, Any]:
        """Validate+coerce overrides against the declared param surface."""
        unknown = set(overrides) - set(self._by_name)
        if unknown:
            raise ParamError(
                f"prototype {self.name!r}: unknown parameters {sorted(unknown)}; "
                f"known: {sorted(self._by_name)}"
            )
        return {
            p.name: p.coerce(overrides.get(p.name)) for p in self.params
        }

    def generate(self, component_name: str, **overrides: Any) -> List[dict]:
        resolved = self.resolve(overrides)
        return self._generate(component_name, **resolved)

    def describe(self) -> str:
        """Human-readable param listing (what `ks prototype describe` showed)."""
        lines = [f"{self.name}: {self.doc}".rstrip(": ")]
        for p in self.params:
            req = "required" if p.required else f"default={p.default!r}"
            lines.append(f"  --{p.name} ({p.type.__name__}, {req}) {p.doc}")
        return "\n".join(lines)
