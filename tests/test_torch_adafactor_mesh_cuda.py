"""adafactor over a mesh (runtime/optim.py ``Adafactor`` on FSDP2's
shards and on tensor slices) on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_adafactor_mesh_cuda.py

Elsewhere every test skips.  The LM trainer with adafactor runs as 2
processes sharing the one GPU over gloo, at ``fsdp=2`` (4 of the 8 rows
a rank, every weight's embed dim split over the two) and at ``tensor=2``
(the heads, mlp and vocab split, all 8 rows), at a width whose matrices
factor (d_model 128, d_ff 256, vocab 256) with flash and remat in bf16:
its losses equal on both ranks and within 1e-3 of the trainer without a
mesh on the same weights and global batches, its first grad_norm within
3e-3 (relative; each rank's partial products round to bf16 before the
sum), its factored statistics this rank's share of the whole leaf's, and
each rank launches flash_fwd, flash_dq and flash_dkv once a layer a
step, at bh 16 (4 rows x 4 heads, or 8 rows x 2 heads).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

LAYERS, STEPS = 2, 3

# One rank of an adafactor trainer over ``--mesh`` argv[1]: its losses,
# first grad_norm, launches, kernel bh and the embedding's v_row shape,
# then (every rank alike, no mesh) the trainer on the global batch.
_ADAFACTOR_RANK = r"""
import json, sys
import numpy as np
import torch
from kubeflow_tpu_torch.models.transformer import TransformerConfig, lm_task
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.parallel.mesh import MeshSpec
from kubeflow_tpu_torch.runtime import bootstrap, optim
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.tools.train_lm import parse_mesh
bootstrap.initialize(device="cuda", timeout_s=120)
axes = parse_mesh(sys.argv[1])
mesh = MeshSpec(**axes).build("cuda", timeout_s=120)
rank = torch.distributed.get_rank()
rows = 8 // axes.get("fsdp", 1)
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
batches = [rng.integers(0, 256, (8, 256), dtype=np.int32) for _ in range(3)]
out = {}
for name, m in (("mesh", mesh), ("plain", None)):
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=256, head_dim=64,
                            max_seq_len=256, attention="flash", remat=True)
    init_fn, loss_fn = lm_task(cfg, device="cuda", mesh=m)
    tr = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=optim.adafactor(1e-3),
                 device="cuda", mesh=m,
                 metrics=MetricsLogger(stream=open("/dev/null", "w")))
    state = tr.create_state(seed=0)
    step = tr.compile_step()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    shapes.clear()
    losses, norms = [], []
    for b in batches:
        mine = b if m is None or rows == 8 else \
            b[rank * rows:(rank + 1) * rows]
        state, metrics = step(state, tr.shard_batch({"tokens": mine}))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out[name] = {"losses": losses, "norms": norms,
                 "launches": dict(flash.launch_counts),
                 "bh": sorted(shapes),
                 "embed_v_row": list(state.opt_state.v_row["embed"].shape)}
print("RESULT " + json.dumps(out), flush=True)
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("mesh,v_row", [("fsdp=2", [64]),
                                        ("tensor=2", [128])])
def test_adafactor_mesh_trainer_matches_no_mesh(mesh, v_row):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks

    results = run_ranks(["-c", _ADAFACTOR_RANK, mesh], 2, timeout_s=600,
                        cwd=str(Path(__file__).resolve().parents[1]),
                        env=dict(os.environ, KFT_DIST_BACKEND="gloo"))
    check_ranks(results)
    ranks = [json.loads(next(ln for ln in r.stdout.splitlines()
                             if ln.startswith("RESULT "))[7:])
             for r in results]
    first, second = (r["mesh"] for r in ranks)
    assert first["losses"] == second["losses"]
    for r in ranks:
        np.testing.assert_allclose(r["mesh"]["losses"], r["plain"]["losses"],
                                   atol=1e-3)
        np.testing.assert_allclose(r["mesh"]["norms"][0],
                                   r["plain"]["norms"][0], rtol=3e-3)
        # embed [256, 128] factors: v_row (the mean over the vocab) keeps
        # the embed dim, half of it a rank under fsdp; under tensor the
        # vocab is split and v_row is whole on both ranks.
        assert r["mesh"]["embed_v_row"] == v_row
        assert r["plain"]["embed_v_row"] == [128]
        counts = r["mesh"]["launches"]
        assert counts["flash_fwd"] == counts["flash_dq"] == \
            counts["flash_dkv"] == LAYERS * STEPS, counts
        assert r["mesh"]["bh"] == [["bwd", 16], ["fwd", 16]]
