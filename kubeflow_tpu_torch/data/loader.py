"""Input pipeline: KFTR record format, native prefetch core, batching.

A copy of the JAX package's kubeflow_tpu/data/loader.py (it uses no JAX;
the port imports nothing of the JAX package), with its native core
(native/kft_data.cc, also copied) built by the port on its own, into
``kubeflow_tpu_torch/data/_build/``.  The same files and seed give the
same batches as the JAX package's pipeline.  The host data path has the
weight in native code where it matters:

  - ``RecordWriter`` / ``read_records``: the KFTR on-disk format
    (magic + length-prefixed payloads) — python, it's not hot.
  - ``RecordDataset``: iterates records through the C++ core
    (native/kft_data.cc): N reader threads, bounded ring buffer
    (backpressure), reservoir shuffle — compiled on first use with g++
    into ``data/_build/`` (named by a digest of the source); a
    pure-python fallback keeps every feature working (slower) when no
    toolchain is present.
  - ``tensor_batches``: decode + stack into the {name: np.ndarray} batches
    Trainer.shard_batch consumes; per-process file sharding mirrors the
    operator's gang layout (process i of n reads files i::n).
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import logging
import os
import random
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)


class DataError(RuntimeError):
    """The input pipeline failed past its transient-retry budget.

    The typed signal the training supervisor
    (runtime/supervisor.py) converts into a supervised restart —
    distinguishable from a programming error, which propagates raw."""

MAGIC = b"KFTR\x01"
_NATIVE_SRC = Path(__file__).parent / "native" / "kft_data.cc"
_NATIVE_BUILD_DIR = Path(__file__).parent / "_build"
_NATIVE_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
_build_lock = threading.Lock()
_lib = None
_lib_failed = False


# ---------------------------------------------------------------------------
# Format
# ---------------------------------------------------------------------------

class RecordWriter:
    """Writes the KFTR v1 format: 'KFTR'+version byte, then
    [u32le length][payload] per record."""

    def __init__(self, path: str | Path):
        self._f = open(path, "wb")
        self._f.write(MAGIC)

    def write(self, payload: bytes) -> None:
        self._f.write(struct.pack("<I", len(payload)))
        self._f.write(payload)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "RecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_records(path: str | Path) -> Iterator[bytes]:
    """Pure-python sequential reader (also the no-toolchain fallback).
    Corrupt files raise IOError — the same contract as the native core's
    error surface, so callers handle one exception type per condition."""
    with open(path, "rb") as f:
        if f.read(5) != MAGIC:
            raise IOError(f"{path}: bad magic (want KFTR v1)")
        while True:
            header = f.read(4)
            if not header:
                return
            if len(header) != 4:
                raise IOError(f"{path}: truncated length")
            (length,) = struct.unpack("<I", header)
            payload = f.read(length)
            if len(payload) != length:
                raise IOError(f"{path}: truncated payload")
            yield payload


# ---------------------------------------------------------------------------
# Native core
# ---------------------------------------------------------------------------

def _native_lib():
    """Compile (once) and load the C++ core; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_failed:
            return _lib
        digest = hashlib.sha256(_NATIVE_SRC.read_bytes() + " ".join(
            _NATIVE_FLAGS).encode()).hexdigest()[:16]
        so_path = _NATIVE_BUILD_DIR / f"libkft_data-{digest}.so"
        try:
            if not so_path.exists():
                _NATIVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so_path.with_suffix(f".so.tmp{os.getpid()}")
                cmd = ["g++", *_NATIVE_FLAGS, str(_NATIVE_SRC), "-o",
                       str(tmp)]
                # Serializing the one-time native build is the point of
                # _build_lock: racing compilers would clobber the .so;
                # every later call hits the cached fast path without
                # blocking.
                # kft: allow=blocking-under-lock
                subprocess.run(cmd, check=True, capture_output=True)
                os.replace(tmp, so_path)
                log.info("built native data core -> %s", so_path)
            lib = ctypes.CDLL(str(so_path))
            lib.kft_loader_create.restype = ctypes.c_void_p
            lib.kft_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ]
            lib.kft_loader_next.restype = ctypes.c_int
            lib.kft_loader_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.kft_loader_next_batch.restype = ctypes.c_int
            lib.kft_loader_next_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ]
            lib.kft_loader_free_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int,
            ]
            lib.kft_loader_schema.restype = ctypes.c_int
            lib.kft_loader_schema.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.kft_loader_fill_batch.restype = ctypes.c_int
            lib.kft_loader_fill_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int, ctypes.c_int,
            ]
            lib.kft_loader_error.restype = ctypes.c_char_p
            lib.kft_loader_error.argtypes = [ctypes.c_void_p]
            lib.kft_loader_destroy.argtypes = [ctypes.c_void_p]
            lib.kft_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception as e:  # no g++ / unwritable build directory
            log.warning("native data core unavailable (%s); "
                        "using python reader", e)
            _lib_failed = True
    return _lib


class RecordDataset:
    """Iterate raw record payloads from KFTR files.

    shard(process_id, num_processes): file-level sharding — the gang
    analogue of the reference's per-worker data split (each worker i of n
    reads files i::n), matching KFT_PROCESS_ID from the operator env.

    Path selection is measurement-driven, per consumption style:

    * Batch consumption (``stacked_batches`` / ``tensor_batches``) always
      uses the native core's in-core KTE1 decode + assembly — it wins at
      every record size measured (2.4x on 48 KiB images, 8x on small
      records) because the python per-record loop is the bottleneck.
    * RAW record handout defaults to the single-thread python reader: on
      warm local files it is memcpy-bound and the threaded core's
      per-record FFI + copy overhead makes it a net loss (round-2 bench:
      0.58x).  Pass ``num_threads`` explicitly to force the threaded
      native core for high-latency storage (cold NFS/object stores),
      where overlapping file reads is worth the copy.
    """

    def __init__(
        self,
        paths: Sequence[str | Path],
        *,
        num_threads: Optional[int] = None,
        # Records buffered ahead (backpressure bound).  Shallow beats
        # deep on warm data: a deep ring streams every record through
        # DRAM before the consumer copy, a shallow one stays cache-hot
        # (measured 14k vs 7.8k rec/s at 4 threads, 256 KiB records).
        prefetch: int = 64,
        shuffle_buffer: int = 0,
        seed: int = 0,
        repeat: int = 1,
        force_python: bool = False,
    ):
        if not paths:
            raise ValueError("RecordDataset needs at least one file")
        self.paths = [str(p) for p in paths]
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.repeat = repeat
        self.force_python = force_python

    def shard(self, process_id: int, num_processes: int) -> "RecordDataset":
        mine = self.paths[process_id::num_processes]
        if not mine:
            raise ValueError(
                f"process {process_id}/{num_processes}: no files "
                f"(have {len(self.paths)} total — write more shards)"
            )
        return RecordDataset(
            mine, num_threads=self.num_threads, prefetch=self.prefetch,
            shuffle_buffer=self.shuffle_buffer, seed=self.seed + process_id,
            repeat=self.repeat, force_python=self.force_python,
        )

    def __iter__(self) -> Iterator[bytes]:
        # Raw handout auto-select: python unless threads were requested
        # (see class docstring for the measurements behind this).
        use_native = not self.force_python and self.num_threads is not None
        lib = _native_lib() if use_native else None
        if lib is None:
            yield from self._python_iter()
            return
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths]
        )
        handle = lib.kft_loader_create(
            arr, len(self.paths), self.num_threads, self.prefetch,
            self.shuffle_buffer, self.seed, self.repeat,
        )
        if not handle:
            raise RuntimeError("kft_loader_create failed")
        try:
            # Batched FFI: one C call (and one lock sweep inside) per up
            # to 64 records, not per record — the per-record round trip
            # dominated at high record rates.
            batch_n = 64
            datas = (ctypes.c_void_p * batch_n)()
            lengths = (ctypes.c_uint64 * batch_n)()
            while True:
                n = lib.kft_loader_next_batch(handle, datas, lengths,
                                              batch_n)
                if n == 0:
                    break
                payloads = [ctypes.string_at(datas[i], lengths[i])
                            for i in range(n)]
                # Returns buffers to the loader's pool for reader reuse
                # (keeps the hot path in recycled, cache-warm memory).
                lib.kft_loader_free_batch(handle, datas, n)
                yield from payloads
            err = lib.kft_loader_error(handle)
            if err:
                raise IOError(err.decode())
        finally:
            lib.kft_loader_destroy(handle)

    def stacked_batches(
        self, batch_size: int, *, drop_remainder: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Decode + stack KTE1 records into batches inside the C++ core.

        The python consumer cost is one FFI call and a dict per BATCH:
        the core parses each record's KTE1 header and memcpys its
        tensors directly into per-key contiguous buffers numpy wraps
        zero-copy — no per-record bytes object, no GIL-bound decode
        loop, no np.stack second copy.  Falls back to the python
        decode/stack path when the core is unavailable or the payloads
        are not KTE1 (legacy npz shards).
        """
        lib = None if self.force_python else _native_lib()
        if lib is None:
            yield from self._python_batches(batch_size, drop_remainder)
            return
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths]
        )
        handle = lib.kft_loader_create(
            arr, len(self.paths),
            self.num_threads if self.num_threads is not None else 4,
            self.prefetch, self.shuffle_buffer, self.seed, self.repeat,
        )
        if not handle:
            raise RuntimeError("kft_loader_create failed")
        try:
            buf = ctypes.create_string_buffer(1 << 16)
            rc = lib.kft_loader_schema(handle, buf, len(buf))
            if rc == 0:
                # Empty dataset — or a shard that failed before its
                # first record; surface that, as the raw path does.
                err = lib.kft_loader_error(handle)
                if err:
                    raise IOError(err.decode())
                return
            if rc < 0:
                # Not KTE1 (legacy npz shards) — python path handles it.
                lib.kft_loader_destroy(handle)
                handle = None
                yield from self._python_batches(batch_size,
                                                drop_remainder)
                return
            schema = []
            for part in buf.value.decode().split(";"):
                # dtype.str may itself contain '|' ('|u1', '|b1'), so
                # split key off the left and dims off the right.
                key, rest = part.split("|", 1)
                dtype, _, dims = rest.rpartition("|")
                shape = tuple(int(d) for d in dims.split(",") if d)
                schema.append((key, np.dtype(dtype), shape))
            while True:
                arrays = {
                    key: np.empty((batch_size, *shape), dtype)
                    for key, dtype, shape in schema
                }
                dests = (ctypes.c_void_p * len(schema))(
                    *[arrays[key].ctypes.data
                      for key, _, _ in schema]
                )
                n = lib.kft_loader_fill_batch(handle, dests,
                                              len(schema), batch_size)
                if n < 0:
                    raise IOError(
                        lib.kft_loader_error(handle).decode()
                        or "stacked batch failed")
                if n < batch_size:
                    # End-of-data — or a reader that died mid-shard.
                    # The raw path raises on corrupt shards; silent
                    # truncation here would train on partial data.
                    err = lib.kft_loader_error(handle)
                    if err:
                        raise IOError(err.decode())
                if n == batch_size:
                    yield arrays
                elif n and not drop_remainder:
                    yield {k: v[:n] for k, v in arrays.items()}
                if n < batch_size:
                    return
        finally:
            if handle:
                lib.kft_loader_destroy(handle)

    def _python_batches(
        self, batch_size: int, drop_remainder: bool,
    ) -> Iterator[Dict[str, np.ndarray]]:
        yield from _stack_payloads(self, batch_size, drop_remainder)

    def _python_iter(self) -> Iterator[bytes]:
        rng = np.random.RandomState(self.seed)
        reservoir: List[bytes] = []
        epochs = range(self.repeat) if self.repeat > 0 else iter(int, 1)
        for _ in epochs:
            for path in self.paths:
                for payload in read_records(path):
                    if self.shuffle_buffer <= 1:
                        yield payload
                        continue
                    if len(reservoir) < self.shuffle_buffer:
                        reservoir.append(payload)
                        continue
                    idx = rng.randint(len(reservoir))
                    out, reservoir[idx] = reservoir[idx], payload
                    yield out
        while reservoir:
            idx = rng.randint(len(reservoir))
            reservoir[idx], reservoir[-1] = reservoir[-1], reservoir[idx]
            yield reservoir.pop()


# ---------------------------------------------------------------------------
# Tensor (de)serialization + batching
# ---------------------------------------------------------------------------

_KTE_MAGIC = b"KTE1"


def encode_example(example: Dict[str, np.ndarray]) -> bytes:
    """Dict of arrays -> KTE1 bytes (the KFTR payload convention).

    Raw fixed-layout tensors, not npz: zip parsing per record was the
    dominant cost of the whole input pipeline (~25x the file read), so
    the payload is a flat [key, dtype, shape, raw bytes] sequence and
    decode is a zero-copy ``np.frombuffer`` view.  Feeding the chip
    should cost the host a memcpy, not a decompressor.
    """
    parts = [_KTE_MAGIC, struct.pack("<H", len(example))]
    for key, value in example.items():
        if "|" in key or ";" in key:
            # Reserved by the stacked-batch schema wire ('key|dtype|dims'
            # joined with ';'); rejecting at write time keeps every
            # KTE1 shard batchable by the native core.
            raise ValueError(
                f"example key {key!r} contains a reserved character "
                f"('|' or ';')")
        arr = np.asarray(value)  # not ascontiguousarray: it forces ndmin=1
        kb = key.encode()
        db = arr.dtype.str.encode()  # e.g. b'<f4' — endian-explicit
        parts.append(struct.pack("<HH", len(kb), len(db)))
        parts.append(kb)
        parts.append(db)
        parts.append(struct.pack("<B", arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}q" if arr.ndim else "<0q",
                                 *arr.shape))
        parts.append(struct.pack("<Q", arr.nbytes))
        parts.append(arr.tobytes())
    return b"".join(parts)


def decode_example(payload: bytes,
                   copy: bool = True) -> Dict[str, np.ndarray]:
    """KTE1 (or legacy npz) payload -> dict of arrays.

    ``copy=False`` returns read-only zero-copy views into the payload —
    the hot path for consumers that immediately stack/copy (e.g.
    ``tensor_batches``); note a retained view pins the whole payload.
    The default matches the old npz contract: fresh writable arrays.
    """
    if not payload.startswith(_KTE_MAGIC):
        # Pre-KTE1 shards used npz payloads; keep reading them.
        with np.load(io.BytesIO(payload)) as npz:
            return {k: npz[k] for k in npz.files}
    view = memoryview(payload)
    (n_keys,) = struct.unpack_from("<H", view, 4)
    off = 6
    out: Dict[str, np.ndarray] = {}
    for _ in range(n_keys):
        klen, dlen = struct.unpack_from("<HH", view, off)
        off += 4
        key = bytes(view[off:off + klen]).decode()
        off += klen
        dtype = np.dtype(bytes(view[off:off + dlen]).decode())
        off += dlen
        (ndim,) = struct.unpack_from("<B", view, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}q", view, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", view, off)
        off += 8
        arr = np.frombuffer(view, dtype, count=nbytes // dtype.itemsize,
                            offset=off).reshape(shape)
        out[key] = arr.copy() if copy else arr
        off += nbytes
    return out


def skip_records(path: str | Path, n: int) -> int:
    """Skip up to n records of a KFTR file WITHOUT reading payloads
    (header walk + fseek).  Returns how many were skipped — the resume
    fast-path building block: a decode-free skip costs microseconds per
    record against the milliseconds of decode + stack it replaces.
    Truncation raises IOError exactly like ``read_records`` (fseek
    would silently sail past EOF, so the walk checks against the file
    size)."""
    skipped = 0
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if f.read(5) != MAGIC:
            raise IOError(f"{path}: bad magic (want KFTR v1)")
        while skipped < n:
            header = f.read(4)
            if not header:
                break
            if len(header) != 4:
                raise IOError(f"{path}: truncated length")
            (length,) = struct.unpack("<I", header)
            if f.tell() + length > size:
                raise IOError(f"{path}: truncated payload")
            f.seek(length, 1)
            skipped += 1
    return skipped


def _stack_payloads(
    payloads: "Iterable[bytes]", batch_size: int, drop_remainder: bool,
) -> Iterator[Dict[str, np.ndarray]]:
    """The one decode+stack loop every python batching path shares.
    Zero-copy decode views are safe: np.stack copies them out."""
    batch: List[Dict[str, np.ndarray]] = []
    for payload in payloads:
        batch.append(decode_example(payload, copy=False))
        if len(batch) == batch_size:
            yield {k: np.stack([ex[k] for ex in batch])
                   for k in batch[0]}
            batch = []
    if batch and not drop_remainder:
        yield {k: np.stack([ex[k] for ex in batch]) for k in batch[0]}


def count_records(path: str | Path) -> int:
    """Record count via header walk (no payload reads)."""
    return skip_records(path, 1 << 62)


class TensorBatches:
    """Iterator over Trainer-shaped batches with a resume fast-path
    and transient-error retry.

    ``seek(n_steps)`` (the contract Trainer.fit probes for on resume)
    skips n_steps batches before the first yield.  For an unshuffled
    RecordDataset the skip is a decode-free header walk over the
    shard files (payloads are fseek'd over, epochs wrap); shuffled or
    plain-iterable datasets fall back to draining batches — correct,
    just no faster than the replay Trainer.fit would otherwise do.

    Retry: each batch pull runs behind the ``data.next`` fault hook;
    transient read errors (IOError/OSError, or an injected fault) are
    retried with capped jittered backoff on the policy clock, the
    underlying iterator rebuilt and re-aligned past the batches
    already yielded.  ``retries`` consecutive failures exhaust the
    budget and raise :class:`DataError` — the typed signal the
    training supervisor converts into a supervised restart.

    Rebuild-retry applies ONLY to :class:`RecordDataset` sources —
    they re-iterate from their files, so a fresh stream plus a
    count-skip re-aligns exactly (python-order streams; the threaded
    native core re-aligns by count, its interleaving is not
    order-deterministic).  A plain one-shot iterable cannot be
    rebuilt: resuming a half-consumed generator and then skip-
    draining it would silently DROP data, so for those the error
    propagates raw and recovery belongs to the supervisor's
    data_factory (a fresh iterable per attempt).
    """

    def __init__(self, dataset, batch_size: int,
                 drop_remainder: bool = True, *,
                 retries: int = 4,
                 retry_backoff_s: float = 0.5,
                 retry_backoff_max_s: float = 5.0):
        self._dataset = dataset
        self._batch_size = batch_size
        self._drop = drop_remainder
        self._skip_steps = 0
        self._retries = retries
        self._retry_backoff_s = retry_backoff_s
        self._retry_backoff_max_s = retry_backoff_max_s
        self._rng = random.Random()

    def seek(self, n_steps: int) -> None:
        if n_steps < 0:
            raise ValueError(f"seek wants n_steps >= 0, got {n_steps}")
        self._skip_steps = int(n_steps)

    def _fast_skippable(self) -> bool:
        # The header-walk skip yields the remainder in FILE order, which
        # only matches the stream it replaces when that stream is also
        # file-ordered: the force_python reader.  The threaded native
        # core interleaves files (its stream order is not
        # file-deterministic), so a native dataset drains instead —
        # its order on resume then matches what replay would produce.
        return (isinstance(self._dataset, RecordDataset)
                and self._dataset.shuffle_buffer <= 1
                and self._dataset.force_python)

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        if isinstance(self._dataset, RecordDataset):
            yield from self._dataset.stacked_batches(
                self._batch_size, drop_remainder=self._drop)
            return
        yield from _stack_payloads(self._dataset, self._batch_size,
                                   self._drop)

    def _fast_skip(self, n_records: int) -> Iterator[Dict[str, np.ndarray]]:
        """Header-walk past n_records, then decode/stack the remainder.

        The mid-file resume point rules out the in-core stacked path
        (the C reader starts at file offsets 0), so post-skip batches
        use the python decode loop — resume pays decode per record
        only AFTER the skip point instead of through it.
        """
        ds = self._dataset
        counts = [count_records(p) for p in ds.paths]
        per_epoch = sum(counts)
        epochs_total = ds.repeat if ds.repeat > 0 else None
        if per_epoch == 0:
            return
        epoch, offset = divmod(n_records, per_epoch)
        if epochs_total is not None and epoch >= epochs_total:
            return  # sought past the end: nothing left to yield

        def remaining_payloads():
            to_skip = offset  # records to fseek past, first epoch only
            e = epoch
            while epochs_total is None or e < epochs_total:
                for path, cnt in zip(ds.paths, counts):
                    if to_skip >= cnt:
                        to_skip -= cnt
                        continue
                    with open(path, "rb") as f:
                        f.read(5)  # magic, validated by count_records
                        idx = 0
                        while True:
                            header = f.read(4)
                            if not header:
                                break
                            if len(header) != 4:
                                raise IOError(
                                    f"{path}: truncated length")
                            (length,) = struct.unpack("<I", header)
                            if idx < to_skip:
                                f.seek(length, 1)
                            else:
                                payload = f.read(length)
                                if len(payload) != length:
                                    raise IOError(
                                        f"{path}: truncated payload")
                                yield payload
                            idx += 1
                    to_skip = 0
                to_skip = 0
                e += 1

        yield from _stack_payloads(remaining_payloads(),
                                   self._batch_size, self._drop)

    def _iter_from(self, skip: int) -> Iterator[Dict[str, np.ndarray]]:
        """The pre-retry iteration logic: one batch stream starting
        ``skip`` batches in (fast header-walk skip when legal)."""
        if skip and self._fast_skippable():
            yield from self._fast_skip(skip * self._batch_size)
            return
        it = self._batches()
        for _ in range(skip):
            next(it, None)
        yield from it

    def _retry_wait(self, attempt: int) -> None:
        """Capped jittered exponential backoff, expired on the policy
        clock (``faults.policy_backoff``) so clock-skew scenarios
        cover it without wall sleeping."""
        faults.policy_backoff(attempt, self._retry_backoff_s,
                              self._retry_backoff_max_s, self._rng,
                              poll_s=0.02)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # Lazy: Trainer.fit calls iter() BEFORE seek(); the skip amount
        # is read when the first batch is pulled.
        retryable = isinstance(self._dataset, RecordDataset)

        def run():
            yielded = 0
            attempts = 0
            while True:
                try:
                    it = self._iter_from(self._skip_steps + yielded)
                    while True:
                        # The deterministic transient-fault site: a
                        # scripted raise here models one failed read.
                        faults.fire("data.next")
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                        yield batch
                        yielded += 1
                        attempts = 0  # budget is CONSECUTIVE failures
                except DataError:
                    raise
                except (IOError, OSError, faults.FaultInjected) as e:
                    if not retryable:
                        raise  # one-shot iterable: see class docstring
                    attempts += 1
                    if attempts > self._retries:
                        raise DataError(
                            f"input pipeline failed {attempts} "
                            f"consecutive times (retry budget "
                            f"{self._retries}): {e}") from e
                    log.warning(
                        "transient data fault (attempt %d/%d), "
                        "rebuilding the batch stream at batch %d: %s",
                        attempts, self._retries,
                        self._skip_steps + yielded, e)
                    self._retry_wait(attempts)

        return run()


def tensor_batches(
    dataset: Iterable[bytes],
    batch_size: int,
    *,
    drop_remainder: bool = True,
    retries: int = 4,
    retry_backoff_s: float = 0.5,
    retry_backoff_max_s: float = 5.0,
) -> TensorBatches:
    """Decode + stack payloads into Trainer-shaped batches.

    A RecordDataset routes through its in-core stacked-batch path
    (decode + assembly in C++); any other payload iterable uses the
    python decode/stack loop.  The returned iterator supports
    ``seek(n_steps)`` — Trainer.fit's resume fast-path (decode-free
    header-walk skip for unshuffled record datasets) — and retries
    transient read errors behind the ``data.next`` fault hook (see
    :class:`TensorBatches`).
    """
    return TensorBatches(dataset, batch_size, drop_remainder,
                         retries=retries,
                         retry_backoff_s=retry_backoff_s,
                         retry_backoff_max_s=retry_backoff_max_s)


def write_example_shards(
    examples: Iterable[Dict[str, np.ndarray]],
    directory: str | Path,
    *,
    prefix: str = "data",
    examples_per_shard: int = 1024,
) -> List[Path]:
    """Utility (tests, tools): write examples into sharded KFTR files."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    paths: List[Path] = []
    writer: Optional[RecordWriter] = None
    count = 0
    for example in examples:
        if writer is None or count >= examples_per_shard:
            if writer:
                writer.close()
            paths.append(directory / f"{prefix}-{len(paths):05d}.kftr")
            writer = RecordWriter(paths[-1])
            count = 0
        writer.write(encode_example(example))
        count += 1
    if writer:
        writer.close()
    return paths
