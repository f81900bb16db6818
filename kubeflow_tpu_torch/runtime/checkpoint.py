"""Verified checkpoints: the port of kubeflow_tpu/runtime/checkpoint.py.

The JAX package saves with orbax; the port saves with ``torch.save`` into
the same directory layout and the same integrity manifest, so the JAX
package's ``verify_step`` and ``kubeflow-tpu checkpoints verify`` judge a
port checkpoint unchanged:

  - step ``N`` is the directory ``<dir>/N/`` (here one file,
    ``state.pt``), written under a temporary name and renamed into place;
  - beside it, ``kft-manifest-%08d.json`` (format 1): the step, the
    size and blake2b digest (16 bytes) of every file the step wrote, and
    the saved state's leaves (path, shape, dtype), committed atomically
    (tmp + fsync + rename + directory fsync) and LAST, so a save killed
    midway leaves a step that fails verification;
  - ``save()`` copies the state to the host, then a background thread
    writes the files and finalizes; a failure there raises
    :class:`CheckpointError` at the next ``save()`` or ``wait()``
    (``kft_checkpoint_failures_total``; durable saves count in
    ``kft_checkpoint_saves_total``); a step already saved is a no-op;
  - ``restore_or_init`` walks back from the newest step to the newest
    VERIFIED one (failed verifications count in
    ``kft_checkpoint_verify_failures_total``); a directory with no
    manifest at all is tried newest first;
  - GC keeps the newest ``max_to_keep`` steps and, always, the newest
    verified one.

What is saved is the trainer's state as tensors and plain containers
(``_encode``): the step, the parameters (the module's ``state_dict``), the
optimizer state (its dataclass fields), the step generator's
``get_state()`` and ``mutable``.  Restore reads it with
``torch.load(weights_only=True)`` and places it onto the devices of the
caller's template state.  The port does not read the JAX package's orbax
checkpoints.

In a multi-process job (a process group of more than one rank) every
rank calls ``save`` and ``restore`` in step: a save gathers each sharded
tensor (a DTensor, runtime/train.py under a mesh) into the full one,
rank 0 writes the step and its manifest in the format above, and the
step counts as saved only when every rank has passed the barrier after
rank 0's commit (a failure there raises on every rank).  A tensor that
is one rank's slice over the ``tensor`` or ``expert`` axis (its
``TensorShard``, parallel/tensor.py: the split weights of a
tensor-parallel model, an MoE model's experts, and their moments) is
gathered over its group too (over both, for an MoE weight split over
both), after FSDP2's gather.  adafactor's statistics are plain tensors
marked with the ``TensorShard`` chain of the dims they keep (uneven
``fsdp`` links for FSDP2's shards, ``pipeline`` for a stage's layers,
runtime/optim.py) and gather over each group the same way.
Under ``pipeline`` above 1 each stage holds its own layers (marked with
their ``Stage``, parallel/pipeline.py): a save gathers every stage's
layer parameters under their global names and every stage's entries of
the optimizer's per-parameter lists, in stage order; the replicated
parameters are this rank's.  The files are those of a
one-device save, each weight whole in the JAX layout, so a trainer
without a mesh resumes them.  A restore reads the full state on every
rank and keeps each rank's shards of the sharded tensors: its stage's
layers, its tensor slice, then its FSDP2 shard of that, so a
tensor-parallel or pipelined trainer resumes a save without a mesh
too.

Fault hook sites (testing/faults.py): ``checkpoint.save`` fires in the
background finalize, between the step's commit and the manifest write (a
``raise`` models a save that died before its manifest);
``checkpoint.restore`` fires per restore attempt.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from kubeflow_tpu_torch.parallel import pipeline
from kubeflow_tpu_torch.parallel import tensor as tp
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)

MANIFEST_FORMAT = 1
STATE_FILE = "state.pt"
_MANIFEST_GLOB = "kft-manifest-*.json"
_TMP_MARK = ".tmp-"
_DIGEST_CHUNK = 1 << 20


class CheckpointError(RuntimeError):
    """A background checkpoint save failed.  Raised at the next
    ``save()``/``wait()`` after the failure, so the training supervisor
    restarts from the last verified step instead of training on past a
    dead checkpoint path."""


def manifest_path(directory: str | Path, step: int) -> Path:
    return Path(directory) / f"kft-manifest-{int(step):08d}.json"


def _digest_file(path: Path) -> Tuple[int, str]:
    h = hashlib.blake2b(digest_size=16)
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_DIGEST_CHUNK)
            if not chunk:
                break
            size += len(chunk)
            h.update(chunk)
    return size, h.hexdigest()


def _fsync_dir(path: Path) -> None:
    dir_fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def _atomic_write_json(path: Path, payload: dict) -> None:
    """tmp + fsync + rename + directory fsync: the manifest exists
    complete or not at all."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    _fsync_dir(path.parent)


def build_manifest(step_dir: Path, step: int,
                   tree_meta: Optional[List[dict]] = None) -> dict:
    files: Dict[str, dict] = {}
    for f in sorted(p for p in step_dir.rglob("*") if p.is_file()):
        size, digest = _digest_file(f)
        files[f.relative_to(step_dir).as_posix()] = {
            "size": size, "blake2b": digest}
    return {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        "files": files,
        "leaves": tree_meta or [],
    }


def verify_step(directory: str | Path, step: int) -> Tuple[bool, str]:
    """Check one step against its manifest: (ok, the first failure's
    reason, '' when verified).  Extra files in the step directory are
    tolerated; missing, truncated or corrupted listed files are not."""
    directory = Path(directory)
    step_dir = directory / str(int(step))
    mpath = manifest_path(directory, step)
    if not step_dir.is_dir():
        return False, "step directory missing"
    if not mpath.exists():
        return False, "manifest missing (save died before commit?)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"manifest unreadable: {e}"
    if manifest.get("format") != MANIFEST_FORMAT \
            or manifest.get("step") != int(step) \
            or not isinstance(manifest.get("files"), dict):
        return False, "manifest malformed"
    for rel, want in manifest["files"].items():
        path = step_dir / rel
        if not path.is_file():
            return False, f"file missing: {rel}"
        try:
            size, digest = _digest_file(path)
        except OSError as e:
            return False, f"file unreadable: {rel}: {e}"
        if size != want.get("size"):
            return False, (f"file truncated: {rel} "
                           f"({size} != {want.get('size')} bytes)")
        if digest != want.get("blake2b"):
            return False, f"digest mismatch: {rel}"
    return True, ""


def list_checkpoint_steps(directory: str | Path) -> List[int]:
    """Step directories under a checkpoint root, ascending (an unverified
    step still lists)."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    return sorted(int(c.name) for c in directory.iterdir()
                  if c.is_dir() and c.name.isdigit())


# -- state <-> tensors and plain containers ----------------------------------


def _is_sharded(t: Any) -> bool:
    """Whether ``t`` is a DTensor (its ``full_tensor`` gathers it)."""
    return isinstance(t, torch.Tensor) and callable(
        getattr(t, "full_tensor", None))


def _whole_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the whole tensor ``t`` is a share of: its own (a
    DTensor's is the global one) or, for a tensor slice, the whole's."""
    shard = tp.shard_of(t)
    return tuple(t.shape) if shard is None else shard.whole_shape(t.shape)


def _local_shard(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``full`` as the DTensor ``like`` places it
    (``torch.chunk`` along each sharded dim, as FSDP2 splits)."""
    mesh, coord = like.device_mesh, like.device_mesh.get_coordinate()
    local = full
    for i, placement in enumerate(like.placements):
        if placement.is_shard():
            chunks = torch.chunk(local, mesh.size(i), dim=placement.dim)
            local = chunks[coord[i]]
    want = like.to_local().shape
    if local.shape != want:
        raise ValueError(f"shard {tuple(local.shape)} of {tuple(full.shape)}"
                         f" does not match the local {tuple(want)}")
    return local


def _world() -> Tuple[int, int]:
    """(rank, ranks) of the job's process group; (0, 1) without one."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _encode(obj: Any) -> Any:
    """The state as tensors (host copies) and plain containers, the only
    things ``torch.load(weights_only=True)`` reads back.  A sharded
    tensor is gathered, and a tensor slice too (collectives: every rank
    encodes)."""
    if isinstance(obj, torch.Tensor):
        shard = tp.shard_of(obj)
        obj = obj.detach()
        if _is_sharded(obj):
            obj = obj.full_tensor()
        if shard is not None:
            obj = shard.gather(obj)
        return obj.to("cpu", copy=True)
    if isinstance(obj, nn.Module):
        current = obj.state_dict(keep_vars=True)
        return pipeline.whole_named({k: _encode(v)
                                     for k, v in current.items()},
                                    _stage_of(current.values()))
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _encode(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return pipeline.whole_list([_encode(v) for v in obj],
                                   [tp.stage_of(v) for v in obj])
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _stage_of(values) -> Any:
    """The pipeline ``Stage`` marked on any of ``values``, or None."""
    return next((tp.stage_of(v) for v in values
                 if tp.stage_of(v) is not None), None)


def _decode(template: Any, saved: Any, path: str,
            later: List[Callable[[], Any]]) -> Any:
    """``saved`` in the form of ``template``: tensors onto the template's
    device and dtype, dataclasses rebuilt.  A module or a generator is
    restored in place, by an action appended to ``later`` and run only
    once the whole tree has decoded, so a checkpoint that does not fit
    changes nothing."""
    if isinstance(template, nn.Module):
        want = template.state_dict(keep_vars=True)
        if isinstance(saved, dict):
            saved = pipeline.stage_named(saved, _stage_of(want.values()))
        if not isinstance(saved, dict) or set(saved) != set(want) or any(
                tuple(saved[k].shape) != _whole_shape(want[k])
                for k in want):
            raise ValueError(f"{path}: saved parameters do not match the "
                             "model")
        later.append(lambda: _load_module(template, saved))
        return template
    if isinstance(template, torch.Generator):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{path}: no generator state saved")
        later.append(lambda: template.set_state(saved))
        return template
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or \
                tuple(saved.shape) != _whole_shape(template):
            raise ValueError(f"{path}: saved {getattr(saved, 'shape', '?')}"
                             f", want {_whole_shape(template)}")
        return _place_like(saved, template)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        names = [f.name for f in dataclasses.fields(template)]
        if not isinstance(saved, dict) or set(saved) != set(names):
            raise ValueError(f"{path}: saved fields do not match "
                             f"{type(template).__name__}")
        return dataclasses.replace(template, **{
            n: _decode(getattr(template, n), saved[n], f"{path}.{n}", later)
            for n in names})
    if isinstance(template, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"{path}: saved {type(saved).__name__}, want "
                             "a dict")
        return {k: _decode(template.get(k), v, f"{path}[{k!r}]", later)
                for k, v in saved.items()}
    if isinstance(template, (list, tuple)):
        if isinstance(saved, list):
            saved = pipeline.stage_list(saved, [tp.stage_of(t)
                                                for t in template])
        if not isinstance(saved, list) or len(saved) != len(template):
            raise ValueError(f"{path}: saved list does not match")
        return type(template)(_decode(t, s, f"{path}[{i}]", later)
                              for i, (t, s) in enumerate(zip(template,
                                                             saved)))
    return saved


def _place_like(saved: torch.Tensor, template: torch.Tensor
                ) -> torch.Tensor:
    """``saved`` on the template's device and dtype; for a tensor slice
    or a sharded template, this rank's share of it, placed and marked as
    the template is."""
    shard = tp.shard_of(template)
    if shard is not None:
        saved = shard.take(saved)
    if not _is_sharded(template):
        return tp.mark(saved.to(template.device, template.dtype,
                                copy=True), shard)
    from torch.distributed.tensor import DTensor

    local = _local_shard(saved, template).to(template.device,
                                             template.dtype)
    return tp.mark(DTensor.from_local(
        local.contiguous(), template.device_mesh, template.placements,
        run_check=False, shape=template.shape, stride=template.stride()),
        shard)


def _load_module(module: nn.Module, saved: Dict[str, torch.Tensor]
                 ) -> None:
    """The saved full tensors into ``module``: ``load_state_dict``, or
    for sharded parameters and tensor slices each rank's share copied
    into its own."""
    current = module.state_dict(keep_vars=True).values()
    if not any(_is_sharded(t) or tp.shard_of(t) is not None
               for t in current):
        module.load_state_dict(saved)
        return
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    with torch.no_grad():
        for name, value in saved.items():
            target = targets[name]
            shard = tp.shard_of(target)
            if shard is not None:
                value = shard.take(value)
            if _is_sharded(target):
                target.to_local().copy_(_local_shard(value, target))
            else:
                target.copy_(value)


def _tree_metadata(tree: Any, path: str = "") -> List[dict]:
    """Leaf inventory of an encoded state: path, shape, dtype."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _tree_metadata(v, f"{path}[{k!r}]")]
    if isinstance(tree, list):
        return [leaf for i, v in enumerate(tree)
                for leaf in _tree_metadata(v, f"{path}[{i}]")]
    if isinstance(tree, torch.Tensor):
        return [{"path": path, "shape": list(tree.shape),
                 "dtype": str(tree.dtype).replace("torch.", "")}]
    return [{"path": path, "shape": [], "dtype": type(tree).__name__}]


def _count(name: str, help_: str) -> None:
    REGISTRY.counter(name, help_).inc()


def _count_verify_failure() -> None:
    _count("kft_checkpoint_verify_failures_total",
           "checkpoint steps that failed manifest verification")


class CheckpointManager:
    """Verified checkpoints of a trainer's state under ``directory``.

    Saves write in a background thread, one at a time, each finalized by
    its manifest; GC keeps ``max_to_keep`` steps but never the newest
    verified one; ``restore_or_init`` resumes from the newest verified
    step."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._lock = threading.Lock()
        self._async_error: Optional[BaseException] = None
        self._finalize_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._queued: set = set()

    # -- save path ---------------------------------------------------------

    def save(self, step: int, state: Any) -> bool:
        """Copy ``state`` to the host and queue its write; False if
        ``step`` is already saved or queued.  Raises
        :class:`CheckpointError` first if an earlier save failed in the
        background.  In a multi-process job the save is collective and
        returns once the step is committed (module docstring)."""
        self._raise_pending()
        step = int(step)
        if _world()[1] > 1:
            return self._save_together(step, state)
        with self._lock:
            if step in self._queued or step in self.all_steps():
                return False
            self._queued.add(step)
        tree = _encode(state)
        thread = threading.Thread(
            target=self._finalize, args=(step, tree),
            name=f"kft-ckpt-finalize-{step}", daemon=True)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(thread)
        log.info("checkpoint save queued at step %d -> %s", step,
                 self.directory)
        thread.start()
        return True

    def _save_together(self, step: int, state: Any) -> bool:
        """Every rank gathers, rank 0 writes and commits, and every rank
        learns rank 0's outcome at the barrier that ends the save."""
        import torch.distributed as dist

        # Rank 0's look at the directory decides for every rank: a rank
        # that looked once rank 0 had written the step would skip the
        # collectives below and hang the others.
        saved = [step in self.all_steps()]
        dist.broadcast_object_list(saved, src=0)
        if saved[0]:
            return False
        tree = _encode(state)
        error = ""
        if _world()[0] == 0:
            self._finalize(step, tree)
            with self._lock:
                err, self._async_error = self._async_error, None
            error = "" if err is None else repr(err)
        outcome = [error]
        dist.broadcast_object_list(outcome, src=0)
        if outcome[0]:
            raise CheckpointError(
                f"checkpoint save of step {step} failed on rank 0: "
                f"{outcome[0]}")
        return True

    def _write_step(self, step: int, tree: Any) -> Path:
        """The step's files under a temporary name, fsynced, then renamed
        into place: a directory named ``<step>`` is always complete."""
        step_dir = self.directory / str(step)
        tmp = self.directory / f"{step}{_TMP_MARK}{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        # The commit is the DIRECTORY rename below, not a rename of this
        # file: the file is fsynced inside the temporary directory, whose
        # entry is fsynced before the rename makes ``<step>`` appear.
        # kft: allow=atomic-write
        with open(tmp / STATE_FILE, "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        os.rename(tmp, step_dir)
        _fsync_dir(self.directory)
        return step_dir

    def _finalize(self, step: int, tree: Any) -> None:
        """Background: write the step, fire ``checkpoint.save``, then
        commit the manifest (the LAST artifact) and run GC, whatever the
        outcome.  A failure is kept for the next save()/wait()."""
        with self._finalize_lock:
            certified = False
            try:
                step_dir = self._write_step(step, tree)
                faults.fire("checkpoint.save")
                _atomic_write_json(
                    manifest_path(self.directory, step),
                    build_manifest(step_dir, step, _tree_metadata(tree)))
                _count("kft_checkpoint_saves_total",
                       "checkpoints committed durable + verified manifest")
                certified = True
            except BaseException as e:  # surfaced at next save()/wait()
                log.exception("checkpoint save of step %d failed", step)
                _count("kft_checkpoint_failures_total",
                       "checkpoint saves that failed in the background")
                with self._lock:
                    if self._async_error is None:
                        self._async_error = e
            finally:
                with self._lock:
                    self._queued.discard(step)
                try:
                    self._gc(verified_hint=step if certified else None)
                except Exception:
                    log.warning("checkpoint GC pass failed", exc_info=True)

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._async_error = self._async_error, None
        if err is not None:
            raise CheckpointError(
                f"background checkpoint save failed: {err}") from err

    def _gc(self, verified_hint: Optional[int] = None) -> None:
        """Keep the newest ``max_to_keep`` steps plus, always, the newest
        verified one (``verified_hint``: a step just certified, not
        digested again).  Runs under ``_finalize_lock``, so no write is
        in flight: leftover temporary step directories go too."""
        for tmp in self.directory.glob(f"*{_TMP_MARK}*"):
            shutil.rmtree(tmp, ignore_errors=True)
        if not self.max_to_keep or self.max_to_keep < 1:
            return
        steps = self.all_steps()
        keep = set(steps[-self.max_to_keep:])
        for step in reversed(steps):
            if step == verified_hint or verify_step(self.directory,
                                                    step)[0]:
                keep.add(step)
                break
        for step in steps:
            if step in keep:
                continue
            shutil.rmtree(self.directory / str(step), ignore_errors=True)
            manifest_path(self.directory, step).unlink(missing_ok=True)
        # A manifest whose step directory is gone verifies nothing.
        for mpath in self.directory.glob(_MANIFEST_GLOB):
            try:
                mstep = int(mpath.stem.rsplit("-", 1)[1])
            except (IndexError, ValueError):
                continue
            if not (self.directory / str(mstep)).is_dir():
                mpath.unlink(missing_ok=True)

    # -- restore path ------------------------------------------------------

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Step ``step`` (default: the latest) in the form of
        ``state_like``, on its devices; its module and generator are
        restored in place."""
        target = step if step is not None else self.latest_step()
        if target is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        faults.fire("checkpoint.restore")
        saved = torch.load(self.directory / str(target) / STATE_FILE,
                           map_location="cpu", weights_only=True)
        later: List[Callable[[], Any]] = []
        state = _decode(state_like, saved, "state", later)
        for action in later:
            action()
        return state

    def verify(self, step: int) -> bool:
        ok, reason = verify_step(self.directory, step)
        if not ok:
            _count_verify_failure()
            log.warning("checkpoint step %d failed verification: %s",
                        step, reason)
        return ok

    def latest_verified_step(self) -> Optional[int]:
        for step in reversed(self.all_steps()):
            if self.verify(step):
                return step
        return None

    def restore_or_init(self, init_state: Any) -> Tuple[Any, int]:
        """Restore the newest VERIFIED step, walking back over corrupt or
        partial ones, else return ``init_state``: (state, start step).
        A step without a manifest at or after the oldest manifested one
        died before its commit and is skipped; one older than every
        manifested step predates manifests and is tried."""
        steps = self.all_steps()
        if not steps:
            return init_state, 0
        manifested = [s for s in steps
                      if manifest_path(self.directory, s).exists()]
        legacy_below = min(manifested) if manifested else None
        for step in reversed(steps):
            if legacy_below is not None and step >= legacy_below \
                    and not self.verify(step):
                log.warning("skipping unverified checkpoint step %d; "
                            "walking back", step)
                continue
            try:
                state = self.restore(init_state, step)
            except Exception:
                _count_verify_failure()
                log.exception("restore of checkpoint step %d failed; "
                              "walking back", step)
                continue
            log.info("resuming from checkpoint step %d", step)
            return state, step + 1
        log.error("no restorable checkpoint under %s (%d step(s), none "
                  "verified); starting from scratch", self.directory,
                  len(steps))
        return init_state, 0

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return list_checkpoint_steps(self.directory)

    def wait(self) -> None:
        """Block until queued saves are written and finalized; raises
        :class:`CheckpointError` if any failed."""
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join()
        self._raise_pending()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()
