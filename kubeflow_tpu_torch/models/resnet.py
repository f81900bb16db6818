"""ResNet family (v1.5): the port of kubeflow_tpu/models/resnet.py.

The JAX package's image-classification reference model, in PyTorch, held
to the flax modules by tests/test_torch_resnet.py.  What carries over:

  - compute dtype bfloat16 end to end, float32 master parameters and
    batch statistics; the head (mean over H and W, then the dense layer)
    in float32;
  - the interface is NHWC ``[b, h, w, 3]`` as in JAX.  Inside, tensors
    are NCHW in ``channels_last`` memory format (the permuted NHWC input
    already has those strides), cuDNN's fast layout on the GPU;
  - ``padding="SAME"`` is flax's: ``same_padding`` gives XLA's pads, and
    where they are uneven (stride 2 on an even size: the extra row and
    column go to the bottom and right) the input is padded explicitly,
    with -inf before a max-pool;
  - BatchNorm is flax's, not ``nn.BatchNorm2d``'s: momentum 0.9 and
    epsilon 1e-5 here, the running statistics updated as
    ``ra = m * ra + (1 - m) * batch`` with the biased batch variance
    E[x^2] - E[x]^2, reduced in float32 and clipped at 0 (torch's
    training-mode batch norm would update with the unbiased variance);
    the output cast to the compute dtype;
  - the last BatchNorm scale of every block starts at zero, so a fresh
    network's residual branches are zero;
  - parameter names are flax's (``conv_init``, ``bn_init``,
    ``BottleneckBlock_3.Conv_1``, ``head``), so the weight bridge
    (models/convert_cnn.py) is a walk over the tree.

The running statistics are not module state: as in flax they are the
``batch_stats`` collection, a nested dict (``{"bn_init": {"mean",
"var"}, "BottleneckBlock_0": {"BatchNorm_0": ...}}``) passed to the
forward and, in training, returned updated.  ``model(x, batch_stats)``
gives the logits; ``model(x, batch_stats, train=True)`` gives
``(logits, new_batch_stats)``.  ``remat=True`` recomputes each residual
block in the backward (``torch.utils.checkpoint``), as ``nn.remat`` does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.transformer import _lecun_normal

Stats = Dict[str, Any]
Pair = Tuple[int, int]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` pads (low, high) along one dim: the output has
    ceil(size / stride) positions, and an odd total puts the extra pad
    at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kernel: Pair, strides: Pair,
          padding: str) -> Tuple[Pair, Pair]:
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return (same_padding(x.shape[2], kernel[0], strides[0]),
            same_padding(x.shape[3], kernel[1], strides[1]))


def _pad(x: torch.Tensor, ph: Pair, pw: Pair, value: float = 0.0
         ) -> torch.Tensor:
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def max_pool(x: torch.Tensor, window: Pair, strides: Pair,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.max_pool`` on NCHW: SAME pads with -inf."""
    ph, pw = _pads(x, window, strides, padding)
    return F.max_pool2d(_pad(x, ph, pw, -math.inf), window, strides)


def avg_pool(x: torch.Tensor, window: Pair, strides: Pair,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.avg_pool`` on NCHW with its default
    ``count_include_pad=True``: SAME pads with zeros and every window
    divides by its full size."""
    ph, pw = _pads(x, window, strides, padding)
    return F.avg_pool2d(_pad(x, ph, pw), window, strides)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: input and kernel cast to the
    compute dtype.  ``weight`` is ``[out, in, kh, kw]`` float32 (flax's
    kernel ``[kh, kw, in, out]`` transposed)."""

    def __init__(self, in_features: int, features: int, kernel: Pair,
                 strides: Pair = (1, 1), padding: str = "SAME",
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_features, *kernel), dtype=torch.float32,
            device=device))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """flax's default kernel init, lecun normal over the fan-in
        kh * kw * in, drawn in flax's layout."""
        out, inp, kh, kw = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(_lecun_normal(
                (kh, kw, inp, out), generator,
                self.weight.device).permute(3, 2, 0, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.kernel == (1, 1):
            # A strided 1x1 conv reads every stride-th pixel: take them
            # first.  (On the CPU, torch 2.13's backward of a strided 1x1
            # conv corrupts the heap and can give a wrong weight
            # gradient; 3x3 and 7x7 strided convs are sound.)
            sh, sw = self.strides
            return F.conv2d(x[:, :, ::sh, ::sw], w)
        ph, pw = _pads(x, self.kernel, self.strides, self.padding)
        if ph[0] != ph[1] or pw[0] != pw[1]:
            x, ph, pw = _pad(x, ph, pw), (0, 0), (0, 0)
        return F.conv2d(x, w, None, self.strides, (ph[0], pw[0]))


def init_stats(features: int, device=None) -> Stats:
    """flax's initial running statistics: mean 0, variance 1, float32."""
    return {"mean": torch.zeros(features, dtype=torch.float32, device=device),
            "var": torch.ones(features, dtype=torch.float32, device=device)}


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of NCHW, with
    ``scale`` and ``bias`` float32 parameters.

    ``forward(x, stats, train) -> (y, new_stats)``.  In training, y is
    normalized by the batch's float32 E[x] and E[x^2] - E[x]^2 (clipped
    at 0), the gradient flowing through both, and ``new_stats`` holds
    the running averages updated with them; in eval, y uses ``stats``
    (torch's fused batch norm, the same arithmetic) and ``new_stats`` is
    ``stats``.  The arithmetic runs in float32 and y is cast to the
    compute dtype.
    """

    def __init__(self, features: int, momentum: float, epsilon: float,
                 dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False, device=None):
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.empty(features, dtype=torch.float32,
                                              device=device))
        self.bias = nn.Parameter(torch.empty(features, dtype=torch.float32,
                                             device=device))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()

    def init_stats(self) -> Stats:
        return init_stats(self.scale.shape[0], self.scale.device)

    def forward(self, x: torch.Tensor, stats: Stats, train: bool
                ) -> Tuple[torch.Tensor, Stats]:
        if not train:
            y = F.batch_norm(x, stats["mean"], stats["var"], self.scale,
                             self.bias, training=False, eps=self.epsilon)
            return y.to(self.dtype), stats
        # flax's arithmetic, written out: torch's fused batch norm takes
        # the variance by Welford's method and would own the running
        # update (with the unbiased variance).
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp(torch.square(xf).mean(dim=(0, 2, 3))
                          - torch.square(mean), min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        with torch.no_grad():
            m = self.momentum
            new = {"mean": m * stats["mean"] + (1 - m) * mean,
                   "var": m * stats["var"] + (1 - m) * var}
        return y.to(self.dtype), new


def collect_stats(module: nn.Module) -> Stats:
    """The initial ``batch_stats`` tree of ``module``: one {"mean",
    "var"} entry per BatchNorm, nested under its submodules' names."""
    out: Stats = {}
    for name, child in module.named_children():
        if isinstance(child, BatchNorm):
            out[name] = child.init_stats()
        else:
            sub = collect_stats(child)
            if sub:
                out[name] = sub
    return out


def reset_parameters(module: nn.Module,
                     generator: Optional[torch.Generator] = None) -> None:
    """Draw every parameter of a CNN as flax initializes it: lecun
    normal kernels, dense bias 0, BatchNorm scale 1 (0 where flax's
    ``scale_init`` is zeros) and bias 0."""
    for m in module.modules():
        if isinstance(m, (Conv, BatchNorm)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Linear):
            with torch.no_grad():
                m.weight.copy_(_lecun_normal(
                    (m.in_features, m.out_features), generator,
                    m.weight.device).T)
                m.bias.zero_()


def dense_head(features: int, num_classes: int, device=None) -> nn.Linear:
    """flax ``nn.Dense`` in float32: ``weight [classes, features]`` is the
    flax kernel ``[features, classes]`` transposed."""
    return nn.Linear(features, num_classes, dtype=torch.float32,
                     device=device)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2))`` of the NHWC tensor, then the cast to
    float32: the mean accumulates in float32 and rounds to x's dtype
    first, as XLA's does."""
    return x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype).to(
        torch.float32)


def to_internal(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC input -> NCHW in the compute dtype with channels_last
    strides (no copy for a contiguous NHWC input)."""
    x = x.to(dtype).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last)


class ResNetBlock(nn.Module):
    """Basic 3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, norm: Callable,
                 strides: Pair = (1, 1), dtype=torch.bfloat16, device=None):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype, device=device)
        self.Conv_0 = conv(in_features, filters, (3, 3), strides)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = norm(filters, zero_scale=True)
        if tuple(strides) != (1, 1) or in_features != filters:
            self.conv_proj = conv(in_features, filters, (1, 1), strides)
            self.norm_proj = norm(filters)

    def forward(self, x, stats: Stats, train: bool):
        new: Stats = {}
        y = self.Conv_0(x)
        y, new["BatchNorm_0"] = self.BatchNorm_0(y, stats["BatchNorm_0"],
                                                 train)
        y = F.relu(y)
        y = self.Conv_1(y)
        y, new["BatchNorm_1"] = self.BatchNorm_1(y, stats["BatchNorm_1"],
                                                 train)
        return _residual(self, x, y, stats, new, train)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (ResNet-50/101/152), v1.5: the stride
    is on the 3x3."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, norm: Callable,
                 strides: Pair = (1, 1), dtype=torch.bfloat16, device=None):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype, device=device)
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, (1, 1))
        self.BatchNorm_2 = norm(filters * 4, zero_scale=True)
        if tuple(strides) != (1, 1) or in_features != filters * 4:
            self.conv_proj = conv(in_features, filters * 4, (1, 1), strides)
            self.norm_proj = norm(filters * 4)

    def forward(self, x, stats: Stats, train: bool):
        new: Stats = {}
        y = x
        for i in range(3):
            y = getattr(self, f"Conv_{i}")(y)
            key = f"BatchNorm_{i}"
            y, new[key] = getattr(self, key)(y, stats[key], train)
            if i < 2:
                y = F.relu(y)
        return _residual(self, x, y, stats, new, train)


def _residual(block: nn.Module, x, y, stats: Stats, new: Stats,
              train: bool):
    """relu(residual + y), the residual projected where the block has
    ``conv_proj`` (a change of stride or width)."""
    if hasattr(block, "conv_proj"):
        x = block.conv_proj(x)
        x, new["norm_proj"] = block.norm_proj(x, stats["norm_proj"], train)
    return F.relu(x + y), new


class ResNet(nn.Module):
    """Configurable ResNet; the factories below give the standard depths.

    ``forward(x, batch_stats, train=False, rng=None)``: x is NHWC
    ``[b, h, w, 3]`` (any float dtype; cast to ``dtype``).  Returns
    float32 logits, or in training ``(logits, new_batch_stats)``.  ``rng``
    is unused (no dropout here); Inception-v3's forward takes it too.

    Parameters are drawn from ``generator`` on ``device``: CUDA when none
    is given (an error without a GPU), ``"cpu"`` when asked, ``"meta"``
    for a model whose weights are loaded afterwards.
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls: type,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if device is None or torch.device(device).type != "meta":
            device = resolve_device(device)
        self.dtype, self.remat = dtype, remat
        norm = functools.partial(BatchNorm, momentum=0.9, epsilon=1e-5,
                                 dtype=dtype, device=device)
        self.conv_init = Conv(3, num_filters, (7, 7), (2, 2), dtype=dtype,
                              device=device)
        self.bn_init = norm(num_filters)
        self.block_names = []
        features = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                filters = num_filters * 2 ** i
                self.add_module(name, block_cls(
                    features, filters, norm, strides, dtype=dtype,
                    device=device))
                self.block_names.append(name)
                features = filters * block_cls.expansion
        self.head = dense_head(features, num_classes, device)
        reset_parameters(self, generator)

    def init_batch_stats(self) -> Stats:
        return collect_stats(self)

    def forward(self, x: torch.Tensor, batch_stats: Stats,
                train: bool = False,
                rng: Optional[torch.Generator] = None):
        new: Stats = {}
        x = to_internal(x, self.dtype)
        x = self.conv_init(x)
        x, new["bn_init"] = self.bn_init(x, batch_stats["bn_init"], train)
        x = max_pool(F.relu(x), (3, 3), (2, 2), "SAME")
        for name in self.block_names:
            block = getattr(self, name)
            if self.remat and train and torch.is_grad_enabled():
                x, new[name] = checkpoint(block, x, batch_stats[name], train,
                                          use_reentrant=False)
            else:
                x, new[name] = block(x, batch_stats[name], train)
        logits = self.head(spatial_mean(x))
        return (logits, new) if train else logits


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckBlock)

# Forward-pass useful FLOPs per image for MFU accounting; the canonical
# figures for 224x224 inputs (multiply-accumulate counted as 2 FLOPs).
FWD_FLOPS_224 = {
    "resnet18": 3.6e9,
    "resnet34": 7.3e9,
    "resnet50": 8.2e9,
    "resnet101": 15.7e9,
    "resnet152": 23.1e9,
}

@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """Typed model selector: the JAX package's ``ResNetConfig``."""

    name: str = "resnet50"
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False

    _FACTORIES = {
        "resnet18": ResNet18,
        "resnet34": ResNet34,
        "resnet50": ResNet50,
        "resnet101": ResNet101,
        "resnet152": ResNet152,
    }

    def build(self, device=None,
              generator: Optional[torch.Generator] = None) -> ResNet:
        try:
            factory = self._FACTORIES[self.name]
        except KeyError:
            raise ValueError(
                f"unknown resnet {self.name!r}; known: "
                f"{sorted(self._FACTORIES)}") from None
        return factory(num_classes=self.num_classes, dtype=self.dtype,
                       remat=self.remat, device=device, generator=generator)

    @property
    def fwd_flops_per_image(self) -> float:
        return FWD_FLOPS_224[self.name]
