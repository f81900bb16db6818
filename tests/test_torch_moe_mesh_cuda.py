"""The MoE LM over the expert axis (models/moe.py under ``--mesh
expert=2``) on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_moe_mesh_cuda.py

Elsewhere every test skips.  The trainer over ``expert=2`` runs as 2
processes sharing the one GPU over gloo (each holding 2 of the 4
experts of every layer and all 8 rows), at a small width with flash and
remat in bf16: its losses equal on both ranks and within 1e-3 of the
trainer without a mesh on the same weights and batches (each rank's
experts' partial outputs are summed in bf16, where one device rounds
the whole combine once), its first ``moe_aux`` within 1e-4 (relative)
and the later ones within 5e-3, and each rank launches flash_fwd,
flash_dq and flash_dkv once a layer a step, at bh 32 (8 rows x 4
heads).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

LAYERS, ROWS, HEADS, STEPS, EXPERTS = 2, 8, 4, 3, 4

# One rank of the expert-parallel trainer: its losses, auxes, launches,
# kernel bh and local experts, then (every rank alike, no mesh) the
# trainer without a mesh.
_EXPERT_RANK = r"""
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
mesh = MeshSpec(expert=2).build("cuda", timeout_s=120)
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
for name, m in (("expert", mesh), ("plain", None)):
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=256, head_dim=64,
                            max_seq_len=256, attention="flash", remat=True,
                            moe_experts=4)
    init_fn, loss_fn = lm_task(cfg, device="cuda", mesh=m)
    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=optim.adamw(1e-3),
                 device="cuda", mesh=m,
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = tr.create_state(seed=0)
    step = tr.compile_step()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    shapes.clear()
    losses, auxes = [], []
    for b in batches:
        state, metrics = step(state, tr.shard_batch(b))
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["moe_aux"]))
    wi = state.params.layers[0].moe.wi
    wi = wi.to_local() if hasattr(wi, "to_local") else wi
    out[name] = {"losses": losses, "auxes": auxes,
                 "launches": dict(flash.launch_counts),
                 "bh": sorted(shapes), "experts": wi.shape[0]}
print("RESULT " + json.dumps(out), flush=True)
torch.distributed.destroy_process_group()
"""


def test_expert_parallel_trainer_matches_no_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks

    results = run_ranks(["-c", _EXPERT_RANK], 2, timeout_s=600,
                        cwd=str(Path(__file__).resolve().parents[1]),
                        env=dict(os.environ, KFT_DIST_BACKEND="gloo"))
    check_ranks(results)
    ranks = [json.loads(next(ln for ln in r.stdout.splitlines()
                             if ln.startswith("RESULT "))[7:])
             for r in results]
    first, second = (r["expert"] for r in ranks)
    assert first["losses"] == second["losses"]
    assert first["auxes"] == second["auxes"]
    for r in ranks:
        np.testing.assert_allclose(r["expert"]["losses"],
                                   r["plain"]["losses"], atol=1e-3)
        # The first step's aux comes from the same weights; a later one
        # from weights an adamw update apart, whose bf16 differences move
        # the routing (0.9e-3 relative seen on an H100).
        np.testing.assert_allclose(r["expert"]["auxes"][0],
                                   r["plain"]["auxes"][0], rtol=1e-4)
        np.testing.assert_allclose(r["expert"]["auxes"],
                                   r["plain"]["auxes"], rtol=5e-3)
        assert r["expert"]["experts"] == EXPERTS // 2
        assert r["plain"]["experts"] == EXPERTS
        counts = r["expert"]["launches"]
        assert counts["flash_fwd"] == counts["flash_dq"] == \
            counts["flash_dkv"] == LAYERS * STEPS, counts
        bh = ROWS * HEADS
        assert r["expert"]["bh"] == [["bwd", bh], ["fwd", bh]]
