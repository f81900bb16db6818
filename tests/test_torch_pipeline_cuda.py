"""The GPipe trainer (parallel/pipeline.py) on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_pipeline_cuda.py

Elsewhere every test skips.  The trainer over ``pipeline=2`` runs as 2
processes sharing the one GPU over gloo (each stage holding 2 of the 4
layers, its hops staged through host memory), at a small width with
flash and remat in bf16, 4 microbatches of 2 rows: its losses equal on
both ranks and within 1e-3 of the trainer without a mesh on the same
weights and batches (the microbatches' GEMMs round otherwise than the
whole batch's), its embedding equal on both stages after the steps, and
each rank launches flash_fwd, flash_dq and flash_dkv once a (layer,
microbatch) a step, at bh 8 (2 rows x 4 heads).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

LAYERS, MICRO, ROWS, HEADS, STEPS = 4, 4, 8, 4, 3

# One rank of the pipelined trainer: its losses, launches and kernel bh,
# then (every rank alike, no mesh) the trainer without a mesh.
_PIPELINE_RANK = r"""
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
mesh = MeshSpec(data=1, pipeline=2).build("cuda", timeout_s=120)
shapes = set()
fwd, bwd = flash.flash_fwd, flash.flash_bwd


def recorded(fn, kind):
    def call(q, *args, **kw):
        shapes.add((kind, q.shape[0]))
        return fn(q, *args, **kw)
    return call


flash.flash_fwd = recorded(fwd, "fwd")
flash.flash_bwd = recorded(bwd, "bwd")
rng = np.random.default_rng(0)
batches = [{"tokens": rng.integers(0, 256, (8, 256), dtype=np.int32)}
           for _ in range(3)]
out = {}
for name, m, micro in (("pipeline", mesh, 4), ("plain", None, 0)):
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=4,
                            n_heads=4, n_kv_heads=2, d_ff=256, head_dim=64,
                            max_seq_len=256, attention="flash", remat=True,
                            pipeline_microbatches=micro)
    init_fn, loss_fn = lm_task(cfg, device="cuda", mesh=m)
    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=optim.adamw(1e-3),
                 device="cuda", mesh=m,
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = tr.create_state(seed=0)
    step = tr.compile_step()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    shapes.clear()
    losses = []
    for b in batches:
        state, metrics = step(state, tr.shard_batch(b))
        losses.append(float(metrics["loss"]))
    embed = state.params.embed
    embed = embed.full_tensor() if hasattr(embed, "full_tensor") else embed
    out[name] = {"losses": losses, "launches": dict(flash.launch_counts),
                 "bh": sorted(shapes), "layers": len(state.params.layers),
                 "embed_sum": float(embed.double().sum())}
print("RESULT " + json.dumps(out), flush=True)
torch.distributed.destroy_process_group()
"""


def test_pipelined_trainer_matches_no_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks

    results = run_ranks(["-c", _PIPELINE_RANK], 2, timeout_s=600,
                        cwd=str(Path(__file__).resolve().parents[1]),
                        env=dict(os.environ, KFT_DIST_BACKEND="gloo"))
    check_ranks(results)
    ranks = [json.loads(next(ln for ln in r.stdout.splitlines()
                             if ln.startswith("RESULT "))[7:])
             for r in results]
    first, second = (r["pipeline"] for r in ranks)
    assert first["losses"] == second["losses"]
    assert first["embed_sum"] == second["embed_sum"]
    for r in ranks:
        np.testing.assert_allclose(r["pipeline"]["losses"],
                                   r["plain"]["losses"], atol=1e-3)
        assert r["pipeline"]["layers"] == LAYERS // 2
        per_stage = LAYERS // 2 * MICRO * STEPS
        counts = r["pipeline"]["launches"]
        assert counts["flash_fwd"] == counts["flash_dq"] == \
            counts["flash_dkv"] == per_stage, counts
        bh = ROWS // MICRO * HEADS
        assert r["pipeline"]["bh"] == [["bwd", bh], ["fwd", bh]]
