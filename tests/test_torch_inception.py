"""The port's Inception-v3 (kubeflow_tpu_torch/models/inception.py)
against the JAX package's flax model.

float32 on the CPU, the same numpy inputs and weights given to both;
every leaf drawn from a seeded numpy generator (tests/test_torch_resnet.py
``random_variables``).  Tolerances: blocks and the whole model, eval and
train mode, atol 1e-4.  Dropout cannot match flax's bits: it is held to
equality with JAX at rate 0 and to "same generator state, same mask".
The whole model in train mode is compared at 139 x 139 (the last blocks
at 3 x 3): at 96 x 96 they run at 1 x 1, their batch statistics over two
rows, and JAX's own float32 logits lie further than 1e-4 from its
float64 ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import inception as ji
from kubeflow_tpu_torch.models import inception as ti
from kubeflow_tpu_torch.models.convert_cnn import (
    cnn_variables_to_jax,
    load_cnn_variables,
)
from kubeflow_tpu_torch.models.resnet import to_internal
from kubeflow_tpu_torch.testing.cnn import random_cnn_variables
from test_torch_resnet import assert_trees_close, images, random_variables

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

ATOL = 1e-4

# (JAX block, port block, input [b, h, w, c] at the block's true width)
BLOCKS = {
    "A": (lambda: ji.InceptionA(32, jnp.float32),
          lambda: ti.InceptionA(192, 32, torch.float32), (2, 5, 5, 192)),
    "B": (lambda: ji.InceptionB(jnp.float32),
          lambda: ti.InceptionB(288, torch.float32), (2, 7, 7, 288)),
    "C": (lambda: ji.InceptionC(128, jnp.float32),
          lambda: ti.InceptionC(768, 128, torch.float32), (2, 5, 5, 768)),
    "D": (lambda: ji.InceptionD(jnp.float32),
          lambda: ti.InceptionD(768, torch.float32), (2, 7, 7, 768)),
    "E": (lambda: ji.InceptionE(jnp.float32),
          lambda: ti.InceptionE(1280, torch.float32), (2, 3, 3, 1280)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_blocks_at_their_true_width(kind, train):
    make_jax, make_port, shape = BLOCKS[kind]
    jblock, pblock = make_jax(), make_port()
    variables = random_variables(jblock, (1,) + shape[1:], train=False)
    x = images(shape)
    if train:
        want, jnew = jblock.apply(variables, x, train=True,
                                  mutable=["batch_stats"])
        jnew = jnew["batch_stats"]
    else:
        want = jblock.apply(variables, x, train=False)
        jnew = variables["batch_stats"]
    stats = load_cnn_variables(pblock, variables)
    with torch.no_grad():
        got, new = pblock(to_internal(torch.from_numpy(x), torch.float32),
                          stats, train)
    got = got.permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert got.shape[-1] == pblock.out_features
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert_trees_close(cnn_variables_to_jax(pblock, new)["batch_stats"],
                       jnew, atol=ATOL)


def _pair(size, dropout_rate=0.2, num_classes=16):
    jmodel = ji.InceptionV3(num_classes=num_classes, dtype=jnp.float32,
                            dropout_rate=dropout_rate)
    pmodel = ti.InceptionV3(num_classes=num_classes, dtype=torch.float32,
                            dropout_rate=dropout_rate, device="cpu")
    variables = random_variables(jmodel, (1, size, size, 3), train=False)
    return jmodel, pmodel, variables, load_cnn_variables(pmodel, variables)


def test_whole_model_eval_at_96():
    jmodel, pmodel, variables, stats = _pair(96)
    x = images((2, 96, 96, 3))
    want = jmodel.apply(variables, x, train=False)
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), stats)
    assert got.shape == (2, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_train_mode_at_rate_zero_equals_jax():
    jmodel, pmodel, variables, stats = _pair(139, dropout_rate=0.0)
    x = images((2, 139, 139, 3))
    want, jnew = jmodel.apply(variables, x, train=True,
                              mutable=["batch_stats"])
    with torch.no_grad():
        got, new = pmodel(torch.from_numpy(x), stats, train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert_trees_close(cnn_variables_to_jax(pmodel, new)["batch_stats"],
                       jnew["batch_stats"], atol=ATOL)


def test_dropout_same_seed_same_mask():
    x = torch.randn(4, 2048, generator=torch.Generator().manual_seed(0))
    a = ti.dropout(x, 0.2, torch.Generator().manual_seed(7))
    b = ti.dropout(x, 0.2, torch.Generator().manual_seed(7))
    c = ti.dropout(x, 0.2, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert 0.75 < kept.float().mean().item() < 0.85
    torch.testing.assert_close(a[kept], x[kept] / 0.8)
    assert torch.equal(ti.dropout(x, 0.0, None), x)
    with pytest.raises(ValueError, match="generator"):
        ti.dropout(x, 0.2, None)


def test_dropout_in_the_model_is_seeded():
    pmodel = ti.InceptionV3(num_classes=16, dtype=torch.float32,
                            device="cpu")
    stats = load_cnn_variables(pmodel, random_cnn_variables(pmodel, 0))
    x = torch.from_numpy(images((2, 75, 75, 3)))
    with torch.no_grad():
        runs = [pmodel(x, stats, train=True,
                       rng=torch.Generator().manual_seed(s))[0]
                for s in (3, 3, 4)]
        plain = pmodel(x, stats)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], plain)
    with pytest.raises(ValueError, match="generator"):
        pmodel(x, stats, train=True)


def test_flops_and_parameter_count_match():
    assert ti.FWD_FLOPS_299 == ji.FWD_FLOPS_299
    shapes = jax.eval_shape(lambda: ji.InceptionV3().init(
        jax.random.key(0), jnp.zeros((1, 299, 299, 3)), train=False))
    model = ti.InceptionV3(device="meta")
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
