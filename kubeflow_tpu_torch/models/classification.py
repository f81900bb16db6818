"""Image-classification task glue: the port of
kubeflow_tpu/models/classification.py.

``classification_task`` turns a CNN of this package (models/resnet.py,
models/inception.py) into the ``Trainer``'s ``(init_fn, loss_fn)``
(runtime/train.py): softmax cross-entropy with integer labels, accuracy,
and the BatchNorm running statistics as the ``mutable`` collection
``{"batch_stats": ...}``, threaded through every step as the JAX task
threads ``apply(mutable=...)``.  ``eval_step`` uses the running averages
and changes nothing.

Under a data-parallel mesh (``classification_task(..., mesh=...)``, the
trainer's ``DeviceMesh``; JAX's ``train_cnn`` trains as
``MeshSpec(data=n)``) each rank feeds its own rows, and the task is the
JAX one on the global batch: every BatchNorm takes its statistics over
the ranks that hold the other rows (models/resnet.py
``set_batch_group``), the loss is the cross-entropy summed over every
rank's rows over the global count, its value on every rank and its
gradient the rank's share (the trainer's reduction sums the shares, as
for the LM), and the accuracy is the global batch's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.models.resnet import reset_parameters, set_batch_group
from kubeflow_tpu_torch.models.transformer import _global_loss
from kubeflow_tpu_torch.parallel import p2p
from kubeflow_tpu_torch.parallel.mesh import batch_group


def classification_task(
    model: nn.Module, input_shape: Sequence[int],
    device: DeviceLike = None, mesh=None,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, loss_fn) for softmax cross-entropy training.

    ``init_fn(generator) -> (model, {"batch_stats": ...})`` moves
    ``model`` to ``device`` (CUDA when none is given) and draws its
    weights from ``generator`` as flax initializes them.  ``input_shape``
    is the NHWC shape of one batch ``[b, h, w, 3]``; the port's modules
    know their widths, so it is only checked.
    ``loss_fn(model, mutable, batch, rng) -> (loss, ({"accuracy"},
    new_mutable))`` takes ``{"image": [b, h, w, 3], "label": [b] int}``
    (under ``mesh``, this rank's rows: the module docstring).
    """
    if len(input_shape) != 4 or input_shape[-1] != 3:
        raise ValueError(f"input_shape must be NHWC [b, h, w, 3], got "
                         f"{tuple(input_shape)}")
    dev = resolve_device(device)
    # The group of the ranks that hold the other rows, created here,
    # where every rank builds its task.
    group = None if mesh is None else batch_group(mesh)
    rows = 1 if group is None else p2p.rank_and_size(group)[1]
    set_batch_group(model, group)

    def init_fn(gen: Optional[torch.Generator] = None):
        model.to(dev)
        reset_parameters(model, gen)
        return model, {"batch_stats": model.init_batch_stats()}

    def loss_fn(params: nn.Module, mutable: Dict[str, Any], batch,
                rng: Optional[torch.Generator]):
        images, labels = batch["image"], batch["label"].long()
        logits, stats = params(images, mutable["batch_stats"], train=True,
                               rng=rng)
        hits = (logits.argmax(-1) == labels).float()
        if rows == 1:
            loss = F.cross_entropy(logits.float(), labels)
            accuracy = hits.mean()
        else:
            count = labels.shape[0] * rows
            loss = _global_loss(F.cross_entropy(
                logits.float(), labels, reduction="sum") / count, group)
            accuracy = p2p.all_reduce(hits.sum() / count, group)
        return loss, ({"accuracy": accuracy.detach()},
                      {**mutable, "batch_stats": stats})

    return init_fn, loss_fn


def eval_step(model: nn.Module) -> Callable[[nn.Module, Any, Dict], Dict]:
    """Eval step: running BatchNorm averages, no mutation, no gradient.
    ``step(params, mutable, batch) -> {"loss", "accuracy"}``."""

    @torch.no_grad()
    def step(params: nn.Module, mutable: Dict[str, Any], batch):
        labels = batch["label"].long()
        logits = params(batch["image"], mutable["batch_stats"])
        return {
            "loss": F.cross_entropy(logits.float(), labels),
            "accuracy": (logits.argmax(-1) == labels).float().mean(),
        }

    return step
