"""One rank of the CNN gang jobs of tests/test_torch_cnn_train.py.

JAX-free: the test writes the narrow ResNet-18's converted variables,
the global batches and the entry point's flags to ``WORKDIR/inputs.pt``,
starts the ranks with ``kubeflow_tpu_torch.testing.ranks.run_ranks``
(the ``KFT_*`` variables name each), and reads what each rank writes to
``WORKDIR/<job>-rank<r>.pt``:

    python tests/torch_cnn_gang_worker.py trainer WORKDIR     # 2 ranks
    python tests/torch_cnn_gang_worker.py train_cnn WORKDIR   # 2 ranks

``trainer`` steps ``classification_task`` + ``Trainer`` over
``MeshSpec(data=2)``, each rank on its rows of the global batches, from
the given variables (sgd 0.1, momentum 0.9): each step's loss,
grad_norm and accuracy, the whole parameters and the batch statistics
after them, and how far bn_init's batch mean over the rank's own rows
lies from the global one; ``train_cnn`` is ``tools/train_cnn.run`` as a
gang of two on the given flags.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kubeflow_tpu_torch.models.classification import (  # noqa: E402
    classification_task,
)
from kubeflow_tpu_torch.models.resnet import (  # noqa: E402
    ResNet18,
    set_batch_group,
)
from kubeflow_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from kubeflow_tpu_torch.runtime import bootstrap, optim  # noqa: E402
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger  # noqa: E402
from kubeflow_tpu_torch.runtime.train import Trainer  # noqa: E402


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _whole(p):
    """A parameter gathered whole (FSDP2's DTensor: a collective)."""
    full = getattr(p, "full_tensor", None)
    return (full() if callable(full) else p).detach().clone()


def trainer(spec, workdir):
    bootstrap.initialize(device="cpu", timeout_s=60)
    mesh = MeshSpec(data=2).build("cpu", timeout_s=60)
    rank, size = mesh.get_local_rank("data"), 2
    model = ResNet18(dtype=torch.float32, device="cpu", **spec["narrow"])
    base_init, loss_fn = classification_task(model, spec["input_shape"],
                                             device="cpu", mesh=mesh)

    def init_fn(gen):
        net, _ = base_init(gen)
        net.load_state_dict(spec["state"])
        return net, {"batch_stats": _clone(spec["stats"])}

    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                 tx=optim.sgd(0.1, momentum=0.9), device="cpu", mesh=mesh,
                 metrics=MetricsLogger(stream=open(os.devnull, "w")))

    def rows(batch):
        b = batch["label"].shape[0] // size
        return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}

    state = tr.create_state(seed=0)
    step = tr.compile_step()
    metrics = {"loss": [], "grad_norm": [], "accuracy": []}
    for batch in spec["batches"]:
        state, m = step(state, tr.shard_batch(rows(batch)))
        for key, values in metrics.items():
            values.append(float(m[key]))
    out = {"metrics": metrics,
           "params": {n: _whole(p) for n, p in
                      state.params.named_parameters()},
           "batch_stats": state.mutable["batch_stats"]}
    # bn_init's batch mean over this rank's rows alone against the global
    # one, on the first batch at the trained weights.
    first = tr.shard_batch(rows(spec["batches"][0]))
    means = []
    with torch.no_grad():
        for group in (model.bn_init.group, None):
            set_batch_group(model, group)
            _, stats = state.params(first["image"],
                                    state.mutable["batch_stats"], train=True)
            means.append(stats["bn_init"]["mean"])
    out["local_mean_gap"] = float((means[0] - means[1]).abs().max())
    return out


def train_cnn(spec, workdir):
    from kubeflow_tpu_torch.tools import train_cnn as tool

    run = tool.run(spec["train_cnn_argv"])
    return {"history": run.metrics.history, "world": dist.get_world_size()}


def main(scenario, workdir):
    workdir = Path(workdir)
    spec = torch.load(workdir / "inputs.pt", weights_only=True)
    out = {"trainer": trainer, "train_cnn": train_cnn}[scenario](spec,
                                                                 workdir)
    rank = dist.get_rank() if dist.is_initialized() else 0
    torch.save(out, workdir / f"{scenario}-rank{rank}.pt")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
