"""Ring attention and the mesh trainer on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_parallel_cuda.py

Elsewhere every test skips.  The ring runs as 4 processes sharing the one
GPU, joined over gloo (each hop staged through host memory,
parallel/ring.py), at b 1, s 4096 (1024 a rank), 8 query heads of 128 in
bf16, causal and non-causal, and causal GQA with 2 kv heads.  Each case's
o, dq, dk and dv, joined over the ranks, against the kernel's
``flash_attention`` on the whole sequence in this process within 1e-2 in
relative Frobenius norm (both round p, ds and their outputs to bf16, at
other points of the sum), and against float32 softmax attention within
phase 2's bounds of chip_smoke.py (o 1e-2, dq, dk, dv 2e-2); the kernels'
launches summed over the ranks are the ring's live hops: 10 each of
flash_fwd, flash_dq and flash_dkv causal (R (R + 1) / 2 at R = 4), 16
non-causal, and no other kernel.  The trainer over a one-rank mesh (NCCL,
FSDP2 over a group of one) takes the same losses as the trainer without
a mesh on the same weights and batches within 1e-3 in bf16, with remat,
and launches flash_fwd, flash_dq and flash_dkv once a layer a step.  The
trainer over ``tensor=2`` runs as 2 processes sharing the GPU over gloo
(each holding half the heads, mlp and vocab), at a small width with
flash and remat: its losses equal on both ranks and within 1e-2 of the
trainer without a mesh in bf16 on the same weights and batches (each
row-parallel output is two bf16 partial sums added in bf16), and each
rank launches flash_fwd, flash_dq and flash_dkv once a layer a step at
its local bh.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.testing import ring_check

pytestmark = pytest.mark.cuda

WORLD, B, S, H, D = 4, 1, 4096, 8, 128
CASES = {"causal": (8, True), "full": (8, False), "gqa": (2, True)}
KERNEL_REL_TOL = 1e-2
F32_REL_TOL = {"o": 1e-2, "dq": 2e-2, "dk": 2e-2, "dv": 2e-2}


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for name, (hkv, causal) in CASES.items():
        def draw(heads):
            return torch.randn((B, S, heads, D), generator=gen,
                               device="cuda").to(torch.bfloat16)

        cases[name] = {"q": draw(H), "k": draw(hkv), "v": draw(hkv),
                       "g": draw(H), "causal": causal}
    results = ring_check.run_job(tmp_path_factory.mktemp("ring_cuda"),
                                 cases, WORLD, "cuda", timeout_s=600)
    return cases, results


@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_the_kernel_on_the_whole_sequence(ring, case):
    cases, results = ring
    c = cases[case]
    args = [c[x] for x in "qkvg"]
    whole = ring_check.whole_sequence(*args, c["causal"])
    f32 = ring_check.reference_f32(*args, c["causal"])
    for i, key in enumerate(("o", "dq", "dk", "dv")):
        got = ring_check.gathered(results, case, key)
        assert ring_check.rel_err(got, whole[i]) < KERNEL_REL_TOL, key
        assert ring_check.rel_err(got, f32[i]) < F32_REL_TOL[key], key


@pytest.mark.parametrize("case", list(CASES))
def test_ring_launches_one_kernel_per_live_hop(ring, case):
    _, results = ring
    hops = WORLD * (WORLD + 1) // 2 if CASES[case][1] else WORLD * WORLD
    want = {k: 0 for k in flash.launch_counts}
    want.update(flash_fwd=hops, flash_dq=hops, flash_dkv=hops)
    assert ring_check.totals(results, case, "launches") == want


def test_one_rank_mesh_trainer_matches_no_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import torch.distributed as dist

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.parallel.mesh import MeshSpec
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
    from kubeflow_tpu_torch.runtime.train import Trainer

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=256, head_dim=64,
                            max_seq_len=256, attention="flash", remat=True)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 256, (2, 256), dtype=np.int32)}
               for _ in range(3)]
    mesh = MeshSpec(data=1).build("cuda")
    try:
        runs = []
        for m in (None, mesh):
            init_fn, loss_fn = lm_task(cfg, device="cuda", mesh=m)
            tr = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                         tx=optim.adamw(1e-3), device="cuda", mesh=m,
                         metrics=MetricsLogger(stream=open("/dev/null",
                                                           "w")))
            state = tr.create_state(seed=0)
            step = tr.compile_step()
            for key in flash.launch_counts:
                flash.launch_counts[key] = 0
            losses = []
            for b in batches:
                state, metrics = step(state, tr.shard_batch(b))
                losses.append(float(metrics["loss"]))
            runs.append((losses, dict(flash.launch_counts)))
    finally:
        dist.destroy_process_group()
    (plain, plain_counts), (meshed, mesh_counts) = runs
    np.testing.assert_allclose(meshed, plain, atol=1e-3)
    per_run = cfg.n_layers * len(batches)
    for counts in (plain_counts, mesh_counts):
        assert counts["flash_fwd"] == counts["flash_dq"] == \
            counts["flash_dkv"] == per_run


# One rank of the tensor=2 trainer: its losses and launches, then (every
# rank alike, no mesh) the trainer without a mesh on the same batches.
_TENSOR_RANK = r"""
import json
import numpy as np
import torch
from kubeflow_tpu_torch.models.transformer import TransformerConfig, lm_task
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.parallel.mesh import MeshSpec
from kubeflow_tpu_torch.runtime import bootstrap, optim
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer
bootstrap.initialize(device="cuda", timeout_s=120)
mesh = MeshSpec(data=1, tensor=2).build("cuda", timeout_s=120)
cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=256, head_dim=64,
                        max_seq_len=256, attention="flash", remat=True)
rng = np.random.default_rng(0)
batches = [{"tokens": rng.integers(0, 256, (2, 256), dtype=np.int32)}
           for _ in range(3)]
out = {}
for name, m in (("tensor", mesh), ("plain", None)):
    init_fn, loss_fn = lm_task(cfg, device="cuda", mesh=m)
    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=optim.adamw(1e-3),
                 device="cuda", mesh=m,
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = tr.create_state(seed=0)
    step = tr.compile_step()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    losses = []
    for b in batches:
        state, metrics = step(state, tr.shard_batch(b))
        losses.append(float(metrics["loss"]))
    out[name] = {"losses": losses, "launches": dict(flash.launch_counts),
                 "wq": tuple(state.params.layers[0].attn.wq.shape)}
print("RESULT " + json.dumps(out), flush=True)
torch.distributed.destroy_process_group()
"""


def test_tensor_parallel_trainer_matches_no_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import os

    from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks

    results = run_ranks(["-c", _TENSOR_RANK], 2, timeout_s=600,
                        cwd=str(Path(__file__).resolve().parents[1]),
                        env=dict(os.environ, KFT_DIST_BACKEND="gloo"))
    check_ranks(results)
    ranks = [json.loads(next(ln for ln in r.stdout.splitlines()
                             if ln.startswith("RESULT "))[7:])
             for r in results]
    assert ranks[0]["tensor"]["losses"] == ranks[1]["tensor"]["losses"]
    for r in ranks:
        np.testing.assert_allclose(r["tensor"]["losses"],
                                   r["plain"]["losses"], atol=1e-2)
        assert r["tensor"]["wq"] == [128, 2, 64]  # 4 heads / 2 ranks
        per_run = 2 * 3  # layers x steps
        for run in ("tensor", "plain"):
            counts = r[run]["launches"]
            assert counts["flash_fwd"] == counts["flash_dq"] == \
                counts["flash_dkv"] == per_run, (run, counts)
