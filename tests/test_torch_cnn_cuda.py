"""The CNN family (models/resnet.py, models/inception.py) on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_cnn_cuda.py

Elsewhere every test skips.  Weights are drawn from a seeded numpy
generator (kubeflow_tpu_torch/testing/cnn.py), TF32 is off.  Tolerances:

  - the bf16 ResNet-50 (224 x 224) and Inception-v3 (299 x 299) forwards
    against float32 runs of the same weights on the card: relative
    Frobenius error of the logits <= 2.6e-3 and 1.9e-3 (chip_smoke.py's
    bounds), and a control run with BatchNorm normalizing in bf16 must
    exceed them;
  - one float32 training step on the card against the same step on the
    CPU (narrow ResNet-50 at 64 x 64, batch 8, sgd(0.1, momentum 0.9)),
    for three seeds of weights and batch: loss and updated batch_stats
    within atol=rtol=1e-4; each parameter's update within 1e-2 of the
    CPU's (relative Frobenius): cuDNN and the CPU sum the float32
    gradients in other orders, and the backward through 53 train-mode
    BatchNorms magnifies that past an absolute 1e-4 on the updated
    parameters.  On an H100 the worst leaf reads 6.5e-3 for the first
    seed (a BatchNorm bias of the second stage) and 3.2e-5 and 3.5e-5
    for the other two; a wrong gradient moves it by order 1;
  - channels_last against contiguous NCHW on the card: float32 logits
    within atol=rtol=1e-4, bf16 within relative Frobenius 2e-2 with the
    same argmax (cuDNN picks other algorithms for the two layouts).
"""

import contextlib

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models.classification import classification_task
from kubeflow_tpu_torch.models.convert_cnn import (
    cnn_variables_to_jax,
    load_cnn_variables,
)
from kubeflow_tpu_torch.models import resnet
from kubeflow_tpu_torch.models.inception import InceptionV3
from kubeflow_tpu_torch.models.resnet import ResNet50
from kubeflow_tpu_torch.runtime import optim
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.testing.cnn import random_cnn_variables

SEED = 20261017
# Each model's bound lies between its sound bf16 readings (NVIDIA H100
# 80GB HBM3 at 700 W: ResNet-50 2.10e-3, Inception-v3 1.47e-3 here;
# 2.05e-3 and 1.49e-3 on chip_smoke.py's images) and its control with
# BatchNorm normalizing in bf16 (3.59e-3 and 2.62e-3 here; 3.30e-3 and
# 2.42e-3 there), about 1.25x from each.
BF16_REL = {ResNet50: 2.6e-3, InceptionV3: 1.9e-3}
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
UPDATE_REL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CNN's card path (cuDNN in "
                    "bf16) has no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _images(n, size, device, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((n, size, size, 3),
                                       dtype=np.float32)).to(device)


def _contiguous_nchw(x, dtype):
    return x.to(dtype).permute(0, 3, 1, 2).contiguous()


def _rel(got, want):
    return ((got.float() - want).norm() / want.norm()).item()


@contextlib.contextmanager
def _bf16_batchnorm():
    """The control run: eval-mode BatchNorm normalizing in bf16 (its
    statistics, scale and bias rounded to bf16, the arithmetic in bf16)
    where the models normalize in float32.  A loss of precision of this
    size must fail the bf16 bound."""
    forward = resnet.BatchNorm.forward

    def bf16_forward(self, x, stats, train):
        if train or x.dtype != torch.bfloat16:
            return forward(self, x, stats, train)

        def channel(t):
            return t.to(torch.bfloat16)[:, None, None]

        inv = torch.rsqrt(channel(stats["var"]) + self.epsilon)
        return (x - channel(stats["mean"])) * inv * channel(self.scale) \
            + channel(self.bias), stats

    resnet.BatchNorm.forward = bf16_forward
    try:
        yield
    finally:
        resnet.BatchNorm.forward = forward


@pytest.mark.cuda
@pytest.mark.parametrize("build, size", [(ResNet50, 224),
                                         (InceptionV3, 299)])
def test_bf16_forward_near_float32(cuda_device, build, size):
    variables = random_cnn_variables(build(device="meta"), SEED)
    x = _images(4, size, cuda_device)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = build(dtype=dtype, device=cuda_device)
        stats = load_cnn_variables(model, variables)
        with torch.inference_mode():
            out[dtype] = model(x, stats)
            if dtype == torch.bfloat16:
                with _bf16_batchnorm():
                    control = model(x, stats)
    assert out[torch.bfloat16].dtype == torch.float32
    assert out[torch.bfloat16].shape == (4, 1000)
    assert torch.isfinite(out[torch.bfloat16]).all()
    sound = _rel(out[torch.bfloat16], out[torch.float32])
    lossy = _rel(control, out[torch.float32])
    bound = BF16_REL[build]
    print(f"{type(model).__name__} {size}: bf16 logits from float32: "
          f"{sound:.4e}; with BatchNorm normalizing in bf16: {lossy:.4e} "
          f"(bound {bound})")
    assert sound <= bound < lossy


def _one_step(device, variables, batch):
    model = ResNet50(num_classes=10, num_filters=16, dtype=torch.float32,
                     device=device)
    init_fn, loss_fn = classification_task(model, (1, 64, 64, 3),
                                           device=device)
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.sgd(0.1, momentum=0.9), device=device)
    state = trainer.create_state(0)
    state.mutable = {"batch_stats": load_cnn_variables(state.params,
                                                       variables)}
    state, metrics = trainer.compile_step()(state,
                                            trainer.shard_batch(batch))
    return (metrics["loss"].item(),
            cnn_variables_to_jax(state.params, state.mutable["batch_stats"]))


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


@pytest.mark.cuda
@pytest.mark.parametrize("seed, batch_seed", [(SEED, 3), (1, 4), (2, 5)])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, seed,
                                                batch_seed):
    variables = random_cnn_variables(
        ResNet50(num_classes=10, num_filters=16, device="meta"), seed)
    rng = np.random.RandomState(batch_seed)
    batch = {"image": rng.randn(8, 64, 64, 3).astype(np.float32),
             "label": rng.randint(0, 10, size=(8,))}
    loss_gpu, gpu = _one_step(cuda_device, variables, batch)
    loss_cpu, cpu = _one_step(torch.device("cpu"), variables, batch)
    np.testing.assert_allclose(loss_gpu, loss_cpu, **STEP_TOL)
    got, want = dict(_flat(gpu)), dict(_flat(cpu))
    assert got.keys() == want.keys()
    before = dict(_flat(variables))
    worst = {}
    for key, value in want.items():
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got[key], value, err_msg=key,
                                       **STEP_TOL)
            continue
        # The step's update, -lr * (momentum trace = gradient).
        update = value - before[key]
        worst[key] = float(np.linalg.norm(got[key] - value)
                           / np.linalg.norm(update))
    key = max(worst, key=worst.get)
    print(f"seed {seed}: largest relative update error {worst[key]:.3e} "
          f"at {key}")
    assert worst[key] <= UPDATE_REL, (key, worst[key])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channels_last_and_contiguous_give_the_same_logits(cuda_device,
                                                           dtype,
                                                           monkeypatch):
    variables = random_cnn_variables(ResNet50(device="meta"), SEED)
    x = _images(4, 224, cuda_device, seed=2)
    model = ResNet50(dtype=dtype, device=cuda_device)
    stats = load_cnn_variables(model, variables)
    out = []
    for layout in (resnet.to_internal, _contiguous_nchw):
        monkeypatch.setattr(resnet, "to_internal", layout)
        with torch.inference_mode():
            out.append(model(x, stats))
    if dtype == torch.float32:
        torch.testing.assert_close(out[0], out[1], **STEP_TOL)
    else:
        assert _rel(out[0], out[1]) <= 2e-2
        assert torch.equal(out[0].argmax(-1), out[1].argmax(-1))
