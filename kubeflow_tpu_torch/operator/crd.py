"""TPUJob spec model: the port's copy of kubeflow_tpu/operator/crd.py.

The wire format is the JAX package's (group ``kubeflow-tpu.org``, kind
``TPUJob``, the camelCase field names), so one apiserver holds the jobs
of both packages.  What differs is the shape vocabulary: a job names a
gang shape of the port's ``runtime/topology.py`` (``h100-N``,
``a3-highgpu-Ng``, ``h100-HxG`` or ``cpu-N``), and ``hosts`` (one pod a
host) and ``chips`` (one process a GPU) come from it.

* The reference TFJob's replica taxonomy {MASTER, WORKER, PS} encodes
  asynchronous parameter-server data parallelism; an SPMD gang has no
  PS.  PS/MASTER specs are accepted and folded into the worker gang
  (``_fold_compat_replicas``); the native shape is {chief?, worker},
  where chief is only process 0 of the same gang.
* The replica count is derived from the shape (one pod per host).
* The mesh axes {data, fsdp, pipeline, model, sequence, expert} are part
  of the spec, so axis sizes are validated against the shape before
  admission.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

from kubeflow_tpu_torch.runtime.topology import SliceTopology, parse_slice_type

GROUP = "kubeflow-tpu.org"
VERSION = "v1alpha1"
KIND = "TPUJob"
PLURAL = "tpujobs"


class SpecError(ValueError):
    """Invalid TPUJob spec."""


def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part.title() for part in rest)


def _snake(name: str) -> str:
    import re

    return re.sub(r"(?<!^)([A-Z])", r"_\1", name).lower()


class _SpecBase:
    """Shared (de)serialization for CR sub-specs.

    The wire schema is uniformly camelCase (k8s convention); Python fields
    are snake_case.  Unknown keys are rejected with SpecError so a typo'd
    user CR is an admission error, not an operator traceback.
    """

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            value = getattr(self, f.name)
            if value is None:
                continue
            out[_camel(f.name)] = value
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        field_names = {  # type: ignore[arg-type]
            f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in d.items():
            name = key if key in field_names else _snake(key)
            if name not in field_names:
                raise SpecError(
                    f"{cls.__name__}: unknown field {key!r}; "
                    f"known: {sorted(_camel(n) for n in field_names)}"
                )
            kwargs[name] = value
        return cls(**kwargs)


@dataclasses.dataclass
class MeshSpec:
    """Logical mesh axes the job's SPMD program shards over.

    Axis order is the physical layout order: axes earlier in the list get
    NVLink-contiguous device groups (see parallel/mesh.py).  A size of 1 means
    the axis is unused; -1 means "fill with remaining devices".
    """

    data: int = -1
    fsdp: int = 1
    pipeline: int = 1
    model: int = 1
    sequence: int = 1
    expert: int = 1

    AXES = ("data", "fsdp", "pipeline", "model", "sequence", "expert")

    def sizes(self) -> Dict[str, int]:
        return {axis: getattr(self, axis) for axis in self.AXES}

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """Fill the single -1 axis so the product equals n_devices."""
        sizes = self.sizes()
        bad = [axis for axis, n in sizes.items() if n < 1 and n != -1]
        if bad:
            raise SpecError(
                f"mesh axis sizes must be >= 1 (or -1 for auto), got "
                f"{ {a: sizes[a] for a in bad} }"
            )
        wild = [axis for axis, n in sizes.items() if n == -1]
        if len(wild) > 1:
            raise SpecError(f"at most one mesh axis may be -1, got {wild}")
        fixed = math.prod(n for n in sizes.values() if n != -1)
        if wild:
            if n_devices % fixed:
                raise SpecError(
                    f"mesh axes {sizes} do not divide {n_devices} devices"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise SpecError(
                f"mesh axes {sizes} (product {fixed}) != {n_devices} devices"
            )
        return sizes

    def to_dict(self) -> Dict[str, int]:
        return self.sizes()

    def runtime_axes(self) -> Dict[str, int]:
        """This spec in the runtime vocabulary of parallel/mesh.py
        (which calls the tensor-parallel axis 'tensor', not 'model') —
        the bridge for anything translating an admitted spec.mesh into
        worker flags or a parallel.MeshSpec."""
        sizes = self.sizes()
        sizes["tensor"] = sizes.pop("model")
        return sizes

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MeshSpec":
        d = dict(d)
        if "tensor" in d:
            # Runtime spelling (parallel/mesh.py) accepted as an alias
            # so specs can be written in either vocabulary.
            if "model" in d:
                raise SpecError(
                    "mesh declares both 'model' and its alias 'tensor'")
            d["model"] = d.pop("tensor")
        unknown = set(d) - set(cls.AXES)
        if unknown:
            raise SpecError(f"unknown mesh axes {sorted(unknown)}")
        return cls(**{k: int(v) for k, v in d.items()})


# Reference replica types (kubeflow/tf-job/tf-job.libsonnet:6) and their SPMD fate.
COMPAT_REPLICA_TYPES = ("MASTER", "WORKER", "PS", "CHIEF")


@dataclasses.dataclass
class WorkerSpec(_SpecBase):
    """The gang's pod template: same program on every slice host."""

    image: str = "ghcr.io/kubeflow-tpu/worker:latest"
    command: List[str] = dataclasses.field(default_factory=list)
    args: List[str] = dataclasses.field(default_factory=list)
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    working_dir: Optional[str] = None
    image_pull_secrets: List[str] = dataclasses.field(default_factory=list)



@dataclasses.dataclass
class StorageSpec(_SpecBase):
    """Checkpoint/data storage plumbing.

    Heir of the reference's credential mixins: GCS via
    GOOGLE_APPLICATION_CREDENTIALS secret mount
    (kubeflow/tf-serving/tf-serving.libsonnet:342-382), S3 via env vars
    (:310-339), NFS PVC (:151-155).
    """

    kind: str = "gcs"  # gcs | s3 | nfs | local
    base_path: str = ""
    secret_name: Optional[str] = None
    s3_endpoint: Optional[str] = None
    aws_region: Optional[str] = None
    nfs_claim: Optional[str] = None



@dataclasses.dataclass
class RestartPolicy(_SpecBase):
    """Gang failure semantics.

    The reference leaned on per-pod `restartPolicy: OnFailure`
    (kubeflow/tf-job/tf-job.libsonnet:32), which forced launchers to sleep
    forever after success (tf-controller-examples/tf-cnn/launcher.py:86-90).
    On a slice, one lost worker invalidates the whole gang: the policy here
    is restart-the-gang-from-checkpoint, bounded by max_restarts.
    """

    max_restarts: int = 3
    restart_on_preemption: bool = True
    checkpoint_interval_steps: int = 100



@dataclasses.dataclass
class TPUJobSpec:
    name: str
    namespace: str = "kubeflow"
    slice_type: str = "h100-8"
    num_slices: int = 1
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    worker: WorkerSpec = dataclasses.field(default_factory=WorkerSpec)
    storage: Optional[StorageSpec] = None
    restart: RestartPolicy = dataclasses.field(default_factory=RestartPolicy)
    queue: Optional[str] = None  # gang-scheduler queue name

    def __post_init__(self) -> None:
        self.validate()

    @property
    def topology(self) -> SliceTopology:
        return parse_slice_type(self.slice_type)

    @property
    def num_workers(self) -> int:
        """One pod per host per gang — derived, not user-set."""
        return self.topology.hosts * self.num_slices

    @property
    def num_devices(self) -> int:
        return self.topology.chips * self.num_slices

    def validate(self) -> None:
        if self.num_slices < 1:
            raise SpecError("num_slices must be >= 1")
        topo = self.topology  # raises on unknown slice type
        self.mesh.resolve(topo.chips * self.num_slices)  # raises on mismatch

    def to_custom_resource(self) -> dict:
        """Render as the TPUJob CR the operator watches.

        Wire schema is uniformly camelCase; optional/None fields are
        omitted (absent and null are equivalent on parse).
        """
        spec = {
            "sliceType": self.slice_type,
            "numSlices": self.num_slices,
            "mesh": self.mesh.to_dict(),
            "worker": self.worker.to_dict(),
            "restartPolicy": self.restart.to_dict(),
        }
        if self.storage is not None:
            spec["storage"] = self.storage.to_dict()
        if self.queue is not None:
            spec["queue"] = self.queue
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": KIND,
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": spec,
        }

    @classmethod
    def from_custom_resource(cls, cr: Dict[str, Any]) -> "TPUJobSpec":
        meta = cr.get("metadata", {})
        spec = dict(cr.get("spec", {}))
        compat = spec.pop("replicaSpecs", None)
        job = cls(
            name=meta.get("name", "unnamed"),
            namespace=meta.get("namespace", "kubeflow"),
            slice_type=spec.get("sliceType", "h100-8"),
            num_slices=int(spec.get("numSlices", 1)),
            mesh=MeshSpec.from_dict(spec.get("mesh") or {}),
            worker=WorkerSpec.from_dict(spec.get("worker") or {}),
            storage=(StorageSpec.from_dict(spec["storage"])
                     if spec.get("storage") else None),
            restart=RestartPolicy.from_dict(spec.get("restartPolicy") or {}),
            queue=spec.get("queue"),
        )
        if compat:
            job = _fold_compat_replicas(job, compat)
        return job


def _fold_compat_replicas(job: TPUJobSpec,
                          replica_specs: Sequence[Dict[str, Any]]) -> TPUJobSpec:
    """Accept reference-shaped TFJob replicaSpecs and fold them into the gang.

    The reference CR shape (kubeflow/tf-job/tf-job.libsonnet:45-57) lists
    {tfReplicaType, replicas, template}.  Under SPMD there is no PS tier and
    no separate master process: PS replicas are dropped (their role — holding
    sharded state — is what FSDP mesh axes do), MASTER/CHIEF merely selects
    process 0.  The WORKER template's image/args become the gang template.
    """
    for rs in replica_specs:
        rtype = str(rs.get("tfReplicaType", rs.get("replicaType", "WORKER"))).upper()
        if rtype not in COMPAT_REPLICA_TYPES:
            raise SpecError(f"unknown replica type {rtype!r}")
        if rtype in ("WORKER", "MASTER", "CHIEF"):
            template = rs.get("template", {})
            containers = template.get("spec", {}).get("containers", [])
            if containers:
                c0 = containers[0]
                job.worker = WorkerSpec(
                    image=c0.get("image", job.worker.image),
                    command=list(c0.get("command", [])),
                    args=list(c0.get("args", [])),
                    env={e["name"]: e.get("value", "")
                         for e in c0.get("env", [])},
                )
            if rtype == "WORKER":
                break  # worker template wins over master's
    return job
