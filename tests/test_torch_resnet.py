"""The port's ResNet (kubeflow_tpu_torch/models/resnet.py) against the
JAX package's flax ResNet, and the CNN weight bridge
(models/convert_cnn.py).

Every comparison runs float32 on the CPU (the bf16 one excepted), the
same numpy inputs and the same weights going to both.  Every leaf is
drawn from a seeded numpy generator (``random_variables``), BatchNorm
scales included and running variances positive, so every block counts
(flax zero-inits the last scale of each block, which would make every
residual branch zero).  The last scale of a block is drawn small,
U(0.1, 0.3), as training keeps it: with scales near 1 there, the
train-mode forward of the narrow ResNet-50 is ill-conditioned, JAX's own
float32 logits lying further than 1e-4 from its float64 ones, and no
float32 port could be held to 1e-4.  Tolerances:

  - eval logits and blocks: atol 1e-4;
  - train-mode logits and the updated batch_stats: atol 1e-4;
  - bf16 eval logits against JAX's bf16: relative Frobenius error
    <= 2e-2 and the same argmax (both round activations to bf16 at
    every layer, in other orders);
  - the weight round trip: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax import lax

from kubeflow_tpu.models import resnet as jr
from kubeflow_tpu_torch.models import resnet as tr
from kubeflow_tpu_torch.models.convert_cnn import (
    cnn_variables_from_jax,
    cnn_variables_to_jax,
    load_cnn_variables,
)

ATOL = 1e-4
BF16_REL = 2e-2
NARROW = dict(num_classes=10, num_filters=8)


def _is_last_norm(keys) -> bool:
    """The last BatchNorm of a residual block (flax zero-inits its
    scale): BatchNorm_1 of a basic block, BatchNorm_2 of a bottleneck."""
    block = next((k for k in keys if "Block_" in k), "")
    last = "BatchNorm_1" if block.startswith("ResNetBlock") else "BatchNorm_2"
    return block != "" and last in keys


def random_variables(model: nn.Module, input_shape, seed: int = 0,
                     **init_kwargs):
    """Every leaf of ``model``'s variables drawn from numpy: kernels
    N(0, 1 / fan_in), scales U(0.5, 1) (the last of a residual block
    U(0.1, 0.3)), biases and running means 0.1 N(0, 1), running
    variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros(input_shape), **init_kwargs))

    def draw(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        name = keys[-1]
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            lo, hi = (0.1, 0.3) if _is_last_norm(keys) else (0.5, 1.0)
            return rng.uniform(lo, hi, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def images(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_trees_close(got, want, **tol):
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
    want_flat = dict(jax.tree_util.tree_leaves_with_path(want))
    assert got_flat.keys() == want_flat.keys()
    for path, value in want_flat.items():
        np.testing.assert_allclose(np.asarray(got_flat[path]),
                                   np.asarray(value),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def _port(name, dtype=torch.float32, **kw):
    return getattr(tr, name)(dtype=dtype, device="cpu", **kw)


def _jax(name, dtype=jnp.float32, **kw):
    return getattr(jr, name)(dtype=dtype, **kw)


def test_same_padding_is_xla_same():
    for size in range(1, 40):
        for kernel in (1, 2, 3, 5, 7):
            for stride in (1, 2, 3):
                want = lax.padtype_to_pads((size,), (kernel,), (stride,),
                                           "SAME")[0]
                assert tr.same_padding(size, kernel, stride) == tuple(want)
    # The stem's sites: the 7x7/2 conv on 224 and the 3x3/2 pool on 112.
    assert tr.same_padding(224, 7, 2) == (2, 3)
    assert tr.same_padding(112, 3, 2) == (0, 1)
    assert tr.same_padding(56, 1, 2) == (0, 0)


class _JaxStem(nn.Module):
    """ResNet.__call__'s stem, as the flax model builds it."""

    @nn.compact
    def __call__(self, x, train):
        x = nn.Conv(8, (7, 7), (2, 2), use_bias=False, dtype=jnp.float32,
                    padding="SAME", name="conv_init")(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                         epsilon=1e-5, dtype=jnp.float32, name="bn_init")(x)
        return nn.max_pool(nn.relu(x), (3, 3), strides=(2, 2),
                           padding="SAME")


class _PortStem(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_init = tr.Conv(3, 8, (7, 7), (2, 2), dtype=torch.float32)
        self.bn_init = tr.BatchNorm(8, 0.9, 1e-5, dtype=torch.float32)

    def forward(self, x, stats, train):
        x = tr.to_internal(x, torch.float32)
        x, new = self.bn_init(self.conv_init(x), stats["bn_init"], train)
        x = tr.max_pool(torch.relu(x), (3, 3), (2, 2), "SAME")
        return x.permute(0, 2, 3, 1), {"bn_init": new}


def _run_pair(jmodel, pmodel, x, train, **jkw):
    """Apply the flax module and its port on the same random variables;
    returns ((jax out, jax stats), (port out, port stats as numpy))."""
    variables = random_variables(jmodel, (1,) + x.shape[1:], train=False,
                                 **jkw)
    stats = load_cnn_variables(pmodel, variables)
    if train:
        jout, jnew = jmodel.apply(variables, x, train=True,
                                  mutable=["batch_stats"])
        jnew = jnew["batch_stats"]
    else:
        jout, jnew = jmodel.apply(variables, x, train=False), \
            variables["batch_stats"]
    with torch.no_grad():
        out, new = pmodel(torch.from_numpy(x), stats, train)
    new = cnn_variables_to_jax(pmodel, new)["batch_stats"]
    return (jout, jnew), (out.numpy(), new)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("size", [16, 17])
def test_stem_even_and_odd_sizes(size, train):
    x = images((2, size, size, 3))
    (jout, jnew), (out, new) = _run_pair(_JaxStem(), _PortStem(), x, train)
    assert out.shape == jout.shape
    np.testing.assert_allclose(out, jout, atol=ATOL)
    assert_trees_close(new, jnew, atol=ATOL)


class _PortBlock(torch.nn.Module):
    """A port block wrapped to take and give NHWC, for the comparison."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x, stats, train):
        x = tr.to_internal(x, torch.float32)
        y, new = self.block(x, stats["block"], train)
        return y.permute(0, 2, 3, 1), {"block": new}


class _JaxBlock(nn.Module):
    block_cls: type
    filters: int
    strides: tuple

    @nn.compact
    def __call__(self, x, train):
        conv = functools.partial(nn.Conv, use_bias=False, dtype=jnp.float32,
                                 padding="SAME")
        norm = functools.partial(nn.BatchNorm, use_running_average=not train,
                                 momentum=0.9, epsilon=1e-5,
                                 dtype=jnp.float32)
        return self.block_cls(filters=self.filters, conv=conv, norm=norm,
                              act=nn.relu, strides=self.strides,
                              name="block")(x)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kind", ["ResNetBlock", "BottleneckBlock"])
def test_blocks_at_stride_two(kind, size, train):
    x = images((2, size, size, 16))
    jblock = _JaxBlock(getattr(jr, kind), 8, (2, 2))
    norm = functools.partial(tr.BatchNorm, momentum=0.9, epsilon=1e-5,
                             dtype=torch.float32)
    pblock = _PortBlock(getattr(tr, kind)(16, 8, norm, (2, 2),
                                          dtype=torch.float32))
    (jout, jnew), (out, new) = _run_pair(jblock, pblock, x, train)
    assert out.shape == jout.shape == (2, -(-size // 2), -(-size // 2),
                                       8 * pblock.block.expansion)
    assert "norm_proj" in jnew["block"]  # the projected residual
    np.testing.assert_allclose(out, jout, atol=ATOL)
    assert_trees_close(new, jnew, atol=ATOL)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
def test_narrow_resnet_eval_logits(name, size):
    jmodel, pmodel = _jax(name, **NARROW), _port(name, **NARROW)
    variables = random_variables(jmodel, (1, size, size, 3), train=False)
    x = images((2, size, size, 3))
    want = jmodel.apply(variables, x, train=False)
    stats = load_cnn_variables(pmodel, variables)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), stats)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
def test_narrow_resnet_train_logits_and_batch_stats(name):
    jmodel, pmodel = _jax(name, **NARROW), _port(name, **NARROW)
    variables = random_variables(jmodel, (1, 33, 33, 3), train=False)
    x = images((4, 33, 33, 3))
    want, jnew = jmodel.apply(variables, x, train=True,
                              mutable=["batch_stats"])
    stats = load_cnn_variables(pmodel, variables)
    got, new = pmodel(torch.from_numpy(x), stats, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    assert_trees_close(cnn_variables_to_jax(pmodel, new)["batch_stats"],
                       jnew["batch_stats"], atol=ATOL)
    # The input statistics are left as they were (functional update).
    assert_trees_close(cnn_variables_to_jax(pmodel, stats)["batch_stats"],
                       variables["batch_stats"], atol=0)


def test_bf16_eval_logits_near_jax_bf16():
    jmodel = _jax("ResNet18", dtype=jnp.bfloat16, **NARROW)
    pmodel = _port("ResNet18", dtype=torch.bfloat16, **NARROW)
    variables = random_variables(jmodel, (1, 32, 32, 3), train=False)
    x = images((4, 32, 32, 3))
    want = np.asarray(jmodel.apply(variables, x, train=False))
    stats = load_cnn_variables(pmodel, variables)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), stats).numpy()
    assert got.dtype == np.float32
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL, rel
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
def test_weight_round_trip_is_exact(name):
    jmodel, pmodel = _jax(name, **NARROW), _port(name, **NARROW)
    variables = jax.tree.map(np.asarray, random_variables(
        jmodel, (1, 32, 32, 3), train=False))
    stats = load_cnn_variables(pmodel, variables)
    back = cnn_variables_to_jax(pmodel, stats)
    assert_trees_close(back, variables, atol=0, rtol=0)
    state, stats2 = cnn_variables_from_jax(back)
    for key, value in pmodel.state_dict().items():
        assert torch.equal(state[key], value), key
    assert set(stats2) == set(variables["batch_stats"])


def test_full_width_resnet50_matches_the_flax_tree():
    """ResNet-50 at 224 with 1000 classes: the same leaves, shapes and
    25,557,032 parameters as flax's, built without memory (meta)."""
    model = tr.ResNet50(device="meta")
    shapes = jax.eval_shape(lambda: jr.ResNet50().init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    n = sum(p.numel() for p in model.parameters())
    assert n == 25_557_032 == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    flat = {".".join(p.key for p in path).replace(".kernel", ".weight"):
            leaf.shape for path, leaf in
            jax.tree_util.tree_leaves_with_path(shapes["params"])}
    ours = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert set(flat) == set(ours)
    for key, shape in flat.items():
        assert int(np.prod(shape)) == int(np.prod(ours[key])), key
    stats = tr.collect_stats(model)
    assert len(jax.tree.leaves(shapes["batch_stats"])) == sum(
        len(v) for v in _leaves(stats))


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict) and "mean" in value:
            yield value
        elif isinstance(value, dict):
            yield from _leaves(value)


def test_fresh_init_follows_flax_and_zeroes_residual_branches():
    model = tr.ResNet18(dtype=torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0), **NARROW)
    for name in model.block_names:
        block = getattr(model, name)
        assert torch.count_nonzero(block.BatchNorm_1.scale) == 0
        assert torch.all(block.BatchNorm_0.scale == 1)
    assert torch.count_nonzero(model.head.bias) == 0
    w = model.conv_init.weight  # lecun normal over fan-in 7 * 7 * 3
    assert abs(w.std().item() - (1 / 147) ** 0.5) < 0.02
    other = tr.ResNet18(dtype=torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0), **NARROW)
    assert torch.equal(other.conv_init.weight, w)  # same seed, same draw


def test_remat_gives_the_same_loss_and_grads():
    variables = random_variables(_jax("ResNet18", **NARROW), (1, 32, 32, 3),
                                 train=False)
    x = torch.from_numpy(images((2, 32, 32, 3)))
    grads = []
    for remat in (False, True):
        model = _port("ResNet18", remat=remat, **NARROW)
        stats = load_cnn_variables(model, variables)
        logits, _ = model(x, stats, train=True)
        logits.square().mean().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for key, g in grads[0].items():
        torch.testing.assert_close(grads[1][key], g, atol=1e-6, rtol=1e-6)


def _contiguous_nchw(x, dtype):
    return x.to(dtype).permute(0, 3, 1, 2).contiguous()


def test_channels_last_and_contiguous_give_the_same_logits(monkeypatch):
    variables = random_variables(_jax("ResNet18", **NARROW), (1, 33, 33, 3),
                                 train=False)
    x = torch.from_numpy(images((2, 33, 33, 3)))
    model = _port("ResNet18", **NARROW)
    stats = load_cnn_variables(model, variables)
    out = []
    for layout in (tr.to_internal, _contiguous_nchw):
        monkeypatch.setattr(tr, "to_internal", layout)
        with torch.no_grad():
            out.append(model(x, stats))
    assert out[0].shape == out[1].shape
    torch.testing.assert_close(out[0], out[1], atol=1e-5, rtol=1e-5)


def test_config_builds_every_depth_and_keeps_the_flops_table():
    assert tr.FWD_FLOPS_224 == jr.FWD_FLOPS_224
    for name in jr.FWD_FLOPS_224:
        cfg = tr.ResNetConfig(name=name, num_classes=7)
        assert cfg.fwd_flops_per_image == jr.ResNetConfig(
            name=name).fwd_flops_per_image
        model = cfg.build(device="meta")
        assert model.head.out_features == 7
        assert len(model.block_names) == sum(
            jr.ResNetConfig(name=name).build().stage_sizes)
    with pytest.raises(ValueError, match="unknown resnet"):
        tr.ResNetConfig(name="resnet7").build()


@pytest.mark.parametrize("size", [12, 11])
def test_strided_1x1_conv_gradients_match_jax(size):
    """conv_proj's 1x1 stride-2 conv, whose last row goes unread at an
    even size: output, kernel and input gradients as flax's."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, size, size, 8)).astype(np.float32)
    kernel = rng.standard_normal((1, 1, 8, 16)).astype(np.float32)
    conv = nn.Conv(16, (1, 1), (2, 2), use_bias=False, dtype=jnp.float32,
                   padding="SAME")

    def loss(k, xx):
        return jnp.sum(conv.apply({"params": {"kernel": k}}, xx) ** 2)

    want_k, want_x = jax.grad(loss, argnums=(0, 1))(kernel, x)
    port = tr.Conv(8, 16, (1, 1), (2, 2), dtype=torch.float32)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
    xt = tr.to_internal(torch.from_numpy(x),
                        torch.float32).requires_grad_(True)
    y = port(xt)
    assert y.shape == (4, 16, -(-size // 2), -(-size // 2))
    y.square().sum().backward()
    np.testing.assert_allclose(
        port.weight.grad.permute(2, 3, 1, 0).numpy(), np.asarray(want_k),
        atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_x), atol=ATOL, rtol=1e-5)
