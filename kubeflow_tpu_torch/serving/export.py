"""Versioned model export: the port of kubeflow_tpu/serving/export.py.

The on-disk contract is the JAX package's, unchanged, so the port serves a
version that package exported (and the other way round):

    {base_path}/{version}/
        model.json       -- {"format": "kubeflow-tpu/1", "loader",
                             "config", "signature"}
        params.msgpack   -- flax.serialization msgpack of the variables

``params.msgpack`` is read and written by a small msgpack codec in this
module (stdlib + numpy), since the port does not depend on the msgpack
package.  Arrays use flax's ndarray extension (type 1, payload a packed
``(shape, dtype name, C-order bytes)``); ``bfloat16`` maps to
``torch.bfloat16``.  Decoded arrays are CPU torch tensors.

Loader resolution is allowlisted: model.json lives in a directory that
producers write, and naming an arbitrary importable there would hand code
execution in the serving process to anyone who can write a model
directory.  The JAX package's loader names map to the port's through
``_JAX_LOADERS``, a table of strings; nothing of the JAX package is
imported.  A loader here is ``fn(config, device) -> make_predict``.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import struct
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

MODEL_FILE = "model.json"
PARAMS_FILE = "params.msgpack"
FORMAT = "kubeflow-tpu/1"
_VERSION_RE = re.compile(r"^\d+$")

_ALLOWED_LOADER_MODULES = {"kubeflow_tpu_torch.serving.loaders"}
# Loader names written by the JAX package -> the port's counterpart.
_JAX_LOADERS = {
    "kubeflow_tpu.serving.loaders:lm":
        "kubeflow_tpu_torch.serving.loaders:lm",
    "kubeflow_tpu.serving.loaders:lm_generate":
        "kubeflow_tpu_torch.serving.loaders:lm_generate",
    "kubeflow_tpu.serving.loaders:classifier":
        "kubeflow_tpu_torch.serving.loaders:classifier",
}

# ---------------------------------------------------------------------------
# msgpack codec (the subset flax.serialization writes)
# ---------------------------------------------------------------------------

_EXT_NDARRAY = 1
# flax splits arrays above this many bytes into a chunked dict form.
_MAX_CHUNK_SIZE = 2 ** 30


def _tensor_payload(x: Any) -> Tuple[List[int], str, bytes]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return list(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    arr = np.ascontiguousarray(x)
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"cannot serialize an array of dtype {arr.dtype}")
    return list(arr.shape), arr.dtype.name, arr.tobytes("C")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True:
        out += b"\xc3"
    elif obj is False:
        out += b"\xc2"
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out += struct.pack("B", obj)
        elif -32 <= obj < 0:
            out += struct.pack("b", obj)
        elif 0 <= obj < 2 ** 64:
            out += b"\xcf" + struct.pack(">Q", obj)
        elif -2 ** 63 <= obj < 0:
            out += b"\xd3" + struct.pack(">q", obj)
        else:
            raise ValueError(f"integer {obj} does not fit msgpack")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out += struct.pack("B", 0xA0 | n)
        elif n < 2 ** 8:
            out += b"\xd9" + struct.pack(">B", n)
        elif n < 2 ** 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = len(obj)
        if n < 2 ** 8:
            out += b"\xc4" + struct.pack(">B", n)
        elif n < 2 ** 16:
            out += b"\xc5" + struct.pack(">H", n)
        else:
            out += b"\xc6" + struct.pack(">I", n)
        out += obj
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out += struct.pack("B", 0x90 | n)
        elif n < 2 ** 16:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out += struct.pack("B", 0x80 | n)
        elif n < 2 ** 16:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        shape, dtype, data = _tensor_payload(obj)
        if len(data) > _MAX_CHUNK_SIZE:
            raise ValueError(
                f"array of {len(data)} bytes exceeds 2**30: flax would write "
                "it in chunked form, which this codec does not support")
        inner = bytearray()
        _pack([shape, dtype, data], inner)
        out += b"\xc9" + struct.pack(">Ib", len(inner), _EXT_NDARRAY)
        out += inner
    else:
        raise TypeError(f"cannot msgpack-serialize {type(obj).__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a nested dict/list tree with array leaves as flax does."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def _array_from_payload(data: memoryview) -> torch.Tensor:
    shape, dtype, buf = _Unpacker(data).unpack_all()
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    raw = bytearray(buf)
    if dtype == "bfloat16":
        flat = torch.frombuffer(raw, dtype=torch.int16).view(torch.bfloat16) \
            if raw else torch.empty(0, dtype=torch.bfloat16)
    else:
        flat = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype)))
    return flat.reshape([int(s) for s in shape])


class _Unpacker:
    def __init__(self, data: "bytes | memoryview"):
        self._data = memoryview(data)
        self._pos = 0

    def _take(self, n: int) -> memoryview:
        if self._pos + n > len(self._data):
            raise ValueError("truncated msgpack data")
        chunk = self._data[self._pos:self._pos + n]
        self._pos += n
        return chunk

    def _fmt(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def unpack_all(self) -> Any:
        obj = self.unpack()
        if self._pos != len(self._data):
            raise ValueError("trailing bytes after msgpack object")
        return obj

    def unpack(self) -> Any:
        b = self._fmt("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.unpack() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self._fmt(ints[b])
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lengths:
            return self._str(self._fmt(lengths[b]))
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self._take(self._fmt(lengths[b])))
        if b in (0xDC, 0xDD):
            n = self._fmt(">H" if b == 0xDC else ">I")
            return [self.unpack() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._fmt(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            return self._ext(self._fmt(lengths[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.unpack()
            out[key] = self.unpack()
        if "__msgpack_chunked_array__" in out:
            raise ValueError(
                "params.msgpack holds a chunked array (a leaf above 2**30 "
                "bytes); this codec does not support flax's chunked form")
        return out

    def _ext(self, n: int) -> Any:
        code = self._fmt("b")
        data = self._take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack extension type {code}")
        return _array_from_payload(data)


def msgpack_restore(data: bytes) -> Any:
    """Decode what flax.serialization.msgpack_serialize wrote."""
    return _Unpacker(data).unpack_all()


# ---------------------------------------------------------------------------
# Versions and loaders
# ---------------------------------------------------------------------------


def export(
    base_path: "str | Path",
    version: int,
    variables: Any,
    loader: str,
    config: Optional[Dict[str, Any]] = None,
    signature: Optional[Dict[str, Any]] = None,
) -> Path:
    """Write one model version.  Atomic: built in a temp dir then renamed,
    so the version watcher never sees a half-written version."""
    base = Path(base_path)
    final = base / str(version)
    tmp = base / f".tmp-{version}"
    if final.exists():
        raise FileExistsError(f"version {version} already exists at {final}")
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / PARAMS_FILE).write_bytes(msgpack_serialize(variables))
    (tmp / MODEL_FILE).write_text(json.dumps({
        "format": FORMAT,
        "loader": loader,
        "config": config or {},
        "signature": signature or {},
    }, indent=2))
    tmp.rename(final)
    return final


def list_versions(base_path: "str | Path") -> List[int]:
    base = Path(base_path)
    if not base.is_dir():
        return []
    out = []
    for child in base.iterdir():
        if child.is_dir() and _VERSION_RE.match(child.name) \
                and (child / MODEL_FILE).exists():
            out.append(int(child.name))
    return sorted(out)


def resolve_loader(path: str) -> Callable:
    """A JAX loader name or an allowlisted 'pkg.mod:fn' -> callable.
    Modules beyond the port's own loaders opt in through the
    KFT_SERVING_LOADER_MODULES environment variable (comma-separated)."""
    path = _JAX_LOADERS.get(path, path)
    mod_name, _, fn_name = path.partition(":")
    if not fn_name:
        raise ValueError(f"loader {path!r} must be 'module:function'")
    allowed = _ALLOWED_LOADER_MODULES | {
        m.strip() for m in os.environ.get(
            "KFT_SERVING_LOADER_MODULES", "").split(",") if m.strip()
    }
    if mod_name not in allowed:
        raise PermissionError(
            f"loader module {mod_name!r} is not allowlisted; opt it in "
            f"with the KFT_SERVING_LOADER_MODULES env var (allowed: "
            f"{sorted(allowed)})")
    return getattr(importlib.import_module(mod_name), fn_name)


def load_version(
    base_path: "str | Path", version: int, device=None,
) -> Tuple[Callable[[Dict[str, Any]], Dict[str, Any]], Dict[str, Any]]:
    """Rebuild (predict_fn, metadata) for one exported version on
    ``device`` (kubeflow_tpu_torch.device rules: None means CUDA)."""
    vdir = Path(base_path) / str(version)
    spec = json.loads((vdir / MODEL_FILE).read_text())
    if spec.get("format") != FORMAT:
        raise ValueError(
            f"unknown model format in {vdir}: {spec.get('format')}")
    loader = resolve_loader(spec["loader"])
    make_predict = loader(spec["config"], device=device)
    variables = msgpack_restore((vdir / PARAMS_FILE).read_bytes())
    predict = make_predict(variables)
    meta = {
        "loader": spec["loader"],
        "config": spec["config"],
        "signature": spec["signature"],
        "version": version,
    }
    return predict, meta
