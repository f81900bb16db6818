"""Image-classification task glue: the port of
kubeflow_tpu/models/classification.py.

``classification_task`` turns a CNN of this package (models/resnet.py,
models/inception.py) into the ``Trainer``'s ``(init_fn, loss_fn)``
(runtime/train.py): softmax cross-entropy with integer labels, accuracy,
and the BatchNorm running statistics as the ``mutable`` collection
``{"batch_stats": ...}``, threaded through every step as the JAX task
threads ``apply(mutable=...)``.  ``eval_step`` uses the running averages
and changes nothing.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.models.resnet import reset_parameters


def classification_task(
    model: nn.Module, input_shape: Sequence[int],
    device: DeviceLike = None,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, loss_fn) for softmax cross-entropy training.

    ``init_fn(generator) -> (model, {"batch_stats": ...})`` moves
    ``model`` to ``device`` (CUDA when none is given) and draws its
    weights from ``generator`` as flax initializes them.  ``input_shape``
    is the NHWC shape of one batch ``[b, h, w, 3]``; the port's modules
    know their widths, so it is only checked.
    ``loss_fn(model, mutable, batch, rng) -> (loss, ({"accuracy"},
    new_mutable))`` takes ``{"image": [b, h, w, 3], "label": [b] int}``.
    """
    if len(input_shape) != 4 or input_shape[-1] != 3:
        raise ValueError(f"input_shape must be NHWC [b, h, w, 3], got "
                         f"{tuple(input_shape)}")
    dev = resolve_device(device)

    def init_fn(gen: Optional[torch.Generator] = None):
        model.to(dev)
        reset_parameters(model, gen)
        return model, {"batch_stats": model.init_batch_stats()}

    def loss_fn(params: nn.Module, mutable: Dict[str, Any], batch,
                rng: Optional[torch.Generator]):
        images, labels = batch["image"], batch["label"].long()
        logits, stats = params(images, mutable["batch_stats"], train=True,
                               rng=rng)
        loss = F.cross_entropy(logits.float(), labels)
        accuracy = (logits.argmax(-1) == labels).float().mean()
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
