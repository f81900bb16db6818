"""Inception-v3: the port of kubeflow_tpu/models/inception.py, the JAX
package's serving showcase model.

Stem -> 3 x InceptionA -> InceptionB -> 4 x InceptionC -> InceptionD ->
2 x InceptionE -> mean pool -> dropout -> logits; 299 x 299 canonical
input, NHWC at the interface, bf16 compute, float32 head.  The building
blocks are models/resnet.py's (flax ``SAME``/``VALID`` convs, flax
BatchNorm, pools), with this model's BatchNorm momentum 0.9997 and
epsilon 1e-3, and ``avg_pool`` counting the padding as flax's default
does.

Parameter names are flax's: ``ConvBN_0``..``ConvBN_4`` in the stem,
``InceptionA_0``.., and in each block ``ConvBN_i`` numbered in flax's
construction order (a branch's outer unit is built before the units it
is applied to), each holding ``Conv_0`` and ``BatchNorm_0``; the head is
``logits``.

Dropout (rate 0.2 in training) draws its mask from the explicit
``rng`` generator of the forward: flax's dropout bits cannot be matched,
so it is held to "same generator state, same mask" and, at rate 0, to
the JAX model.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.resnet import (
    BatchNorm,
    Conv,
    Stats,
    avg_pool,
    collect_stats,
    dense_head,
    max_pool,
    reset_parameters,
    to_internal,
)

# Canonical forward FLOPs per 299x299 image (~5.7 GFLOPs, 2*MAC).
FWD_FLOPS_299 = 11.4e9 / 2


class ConvBN(nn.Module):
    """conv -> BN -> relu, the basic Inception unit."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides=(1, 1), padding="SAME",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding,
                           dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9997, epsilon=1e-3,
                                     dtype=dtype, device=device)

    def forward(self, x, stats: Stats, train: bool):
        y, new = self.BatchNorm_0(self.Conv_0(x), stats["BatchNorm_0"], train)
        return F.relu(y), {"BatchNorm_0": new}


def _pool(x, window=(3, 3), strides=(1, 1)):
    return avg_pool(x, window, strides, "SAME")


class _Block(nn.Module):
    """An Inception block: ``units`` are its ConvBN specs in flax's
    construction order, ``(in, features, kernel[, strides, padding])``
    with in = None for the block's input width.  A subclass's
    ``branches(chain, x)`` lists the branch outputs to concatenate, where
    ``chain(y, i, j, ...)`` applies ConvBN_i, then ConvBN_j, ...."""

    def __init__(self, in_features: int, units: Sequence[tuple],
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        for i, (inp, *spec) in enumerate(units):
            self.add_module(f"ConvBN_{i}", ConvBN(
                in_features if inp is None else inp, *spec, dtype=dtype,
                device=device))

    def forward(self, x, stats: Stats, train: bool):
        new: Stats = {}

        def chain(y, *indices):
            """Apply ConvBN_i for i in ``indices``, innermost first."""
            for i in indices:
                key = f"ConvBN_{i}"
                y, new[key] = getattr(self, key)(y, stats[key], train)
            return y

        return torch.cat(self.branches(chain, x), dim=1), new


class InceptionA(_Block):
    def __init__(self, in_features, pool_features, dtype=torch.bfloat16,
                 device=None):
        super().__init__(in_features, [
            (None, 64, (1, 1)),             # 0: b1
            (48, 64, (5, 5)),               # 1: b2 outer
            (None, 48, (1, 1)),             # 2: b2 inner
            (96, 96, (3, 3)),               # 3: b3 outer
            (64, 96, (3, 3)),               # 4: b3 middle
            (None, 64, (1, 1)),             # 5: b3 inner
            (None, pool_features, (1, 1)),  # 6: b4
        ], dtype, device)
        self.out_features = 64 + 64 + 96 + pool_features

    def branches(self, chain, x):
        return [chain(x, 0), chain(x, 2, 1), chain(x, 5, 4, 3),
                chain(_pool(x), 6)]


class InceptionB(_Block):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, in_features, dtype=torch.bfloat16, device=None):
        super().__init__(in_features, [
            (None, 384, (3, 3), (2, 2), "VALID"),  # 0: b1
            (96, 96, (3, 3), (2, 2), "VALID"),     # 1: b2 outer
            (64, 96, (3, 3)),                      # 2: b2 middle
            (None, 64, (1, 1)),                    # 3: b2 inner
        ], dtype, device)
        self.out_features = 384 + 96 + in_features

    def branches(self, chain, x):
        return [chain(x, 0), chain(x, 3, 2, 1),
                max_pool(x, (3, 3), (2, 2), "VALID")]


class InceptionC(_Block):
    def __init__(self, in_features, channels_7x7, dtype=torch.bfloat16,
                 device=None):
        c7 = channels_7x7
        super().__init__(in_features, [
            (None, 192, (1, 1)),  # 0: b1
            (c7, 192, (7, 1)),    # 1: b2 outer
            (c7, c7, (1, 7)),     # 2
            (None, c7, (1, 1)),   # 3: b2 inner
            (c7, 192, (1, 7)),    # 4: b3 outer
            (c7, c7, (7, 1)),     # 5
            (c7, c7, (1, 7)),     # 6
            (c7, c7, (7, 1)),     # 7
            (None, c7, (1, 1)),   # 8: b3 inner
            (None, 192, (1, 1)),  # 9: b4
        ], dtype, device)
        self.out_features = 4 * 192

    def branches(self, chain, x):
        return [chain(x, 0), chain(x, 3, 2, 1), chain(x, 8, 7, 6, 5, 4),
                chain(_pool(x), 9)]


class InceptionD(_Block):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, in_features, dtype=torch.bfloat16, device=None):
        super().__init__(in_features, [
            (192, 320, (3, 3), (2, 2), "VALID"),  # 0: b1 outer
            (None, 192, (1, 1)),                  # 1: b1 inner
            (192, 192, (3, 3), (2, 2), "VALID"),  # 2: b2 outer
            (192, 192, (7, 1)),                   # 3
            (192, 192, (1, 7)),                   # 4
            (None, 192, (1, 1)),                  # 5: b2 inner
        ], dtype, device)
        self.out_features = 320 + 192 + in_features

    def branches(self, chain, x):
        return [chain(x, 1, 0), chain(x, 5, 4, 3, 2),
                max_pool(x, (3, 3), (2, 2), "VALID")]


class InceptionE(_Block):
    def __init__(self, in_features, dtype=torch.bfloat16, device=None):
        super().__init__(in_features, [
            (None, 320, (1, 1)),  # 0: b1
            (None, 384, (1, 1)),  # 1: b2 in
            (384, 384, (1, 3)),   # 2: b2 left
            (384, 384, (3, 1)),   # 3: b2 right
            (448, 384, (3, 3)),   # 4: b3 in, outer
            (None, 448, (1, 1)),  # 5: b3 in, inner
            (384, 384, (1, 3)),   # 6: b3 left
            (384, 384, (3, 1)),   # 7: b3 right
            (None, 192, (1, 1)),  # 8: b4
        ], dtype, device)
        self.out_features = 320 + 768 + 768 + 192

    def branches(self, chain, x):
        b2in = chain(x, 1)
        b3in = chain(x, 5, 4)
        return [chain(x, 0), chain(b2in, 2), chain(b2in, 3), chain(b3in, 6),
                chain(b3in, 7), chain(_pool(x), 8)]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep with probability 1 - rate,
    scale the kept entries by 1 / (1 - rate); the mask is drawn from
    ``generator``.  Rate 0 is the identity."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator (the "
                         "forward's rng)")
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class InceptionV3(nn.Module):
    """``forward(x, batch_stats, train=False, rng=None)``: x NHWC
    ``[b, h, w, 3]``; float32 logits, or in training ``(logits,
    new_batch_stats)`` with dropout drawn from ``rng``.  ``device`` as
    for ``ResNet``: CUDA when none is given (an error without a GPU)."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if device is None or torch.device(device).type != "meta":
            device = resolve_device(device)
        self.dtype, self.dropout_rate = dtype, dropout_rate
        c = functools.partial(ConvBN, dtype=dtype, device=device)
        self.ConvBN_0 = c(3, 32, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = c(32, 32, (3, 3), padding="VALID")
        self.ConvBN_2 = c(32, 64, (3, 3))
        self.ConvBN_3 = c(64, 80, (1, 1), padding="VALID")
        self.ConvBN_4 = c(80, 192, (3, 3), padding="VALID")
        blocks = [("InceptionA", lambda n: InceptionA(n, 32, dtype, device)),
                  ("InceptionA", lambda n: InceptionA(n, 64, dtype, device)),
                  ("InceptionA", lambda n: InceptionA(n, 64, dtype, device)),
                  ("InceptionB", lambda n: InceptionB(n, dtype, device))]
        blocks += [("InceptionC", functools.partial(
            InceptionC, channels_7x7=c7, dtype=dtype, device=device))
            for c7 in (128, 160, 160, 192)]
        blocks += [("InceptionD", lambda n: InceptionD(n, dtype, device))]
        blocks += [("InceptionE", lambda n: InceptionE(n, dtype, device))] * 2
        self.block_names = []
        features, seen = 192, {}
        for kind, make in blocks:
            name = f"{kind}_{seen.get(kind, 0)}"
            seen[kind] = seen.get(kind, 0) + 1
            block = make(features)
            self.add_module(name, block)
            self.block_names.append(name)
            features = block.out_features
        self.logits = dense_head(features, num_classes, device)
        reset_parameters(self, generator)

    def init_batch_stats(self) -> Stats:
        return collect_stats(self)

    def forward(self, x: torch.Tensor, batch_stats: Stats,
                train: bool = False,
                rng: Optional[torch.Generator] = None):
        new: Stats = {}
        x = to_internal(x, self.dtype)
        for i in range(5):
            key = f"ConvBN_{i}"
            x, new[key] = getattr(self, key)(x, batch_stats[key], train)
            if i in (2, 4):
                x = max_pool(x, (3, 3), (2, 2), "VALID")
        for name in self.block_names:
            x, new[name] = getattr(self, name)(x, batch_stats[name], train)
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)
        if train:
            x = dropout(x, self.dropout_rate, rng)
        logits = self.logits(x.to(torch.float32))
        return (logits, new) if train else logits
