"""Tensor-parallel decode on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_serving_mesh_cuda.py

Elsewhere every test skips.  The engine over ``tensor=2`` runs as two
processes sharing the one GPU over gloo (``KFT_DIST_BACKEND=gloo``;
tests/torch_serving_mesh_worker.py's ``cuda`` job), on the tiny float32
LM drawn from a seed: its greedy tokens, per-step and in fused rounds,
must equal a one-rank engine's on the same weights (captured as CUDA
graphs), and both ranks' slot scalars must be equal after each case.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models.generate import DecodeConfig
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.serving.engine import DecodeEngine
from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_serving_mesh_worker.py")
TINY = {"vocab_size": 96, "d_model": 32, "n_layers": 2, "n_heads": 4,
        "n_kv_heads": 4, "d_ff": 64, "head_dim": 8, "max_seq_len": 64}
NEW_TOKENS = 10
GEOMETRY = dict(slots=2, prefill_len=16, prefill_chunk_tokens=4,
                kv_block_tokens=4)


def _params(model):
    from kubeflow_tpu_torch.models.convert import param_tree

    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        return node.cpu()

    return host(param_tree(model))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    work = tmp_path_factory.mktemp("mesh_cuda")
    cfg = TransformerConfig(dtype=torch.float32, **TINY)
    model = Transformer(cfg, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, TINY["vocab_size"], size=(n,)).tolist()
               for n in (8, 5, 11, 16)]
    torch.save({"cfg": {"base": TINY}, "params": {"base": _params(model)},
                "device": "cuda", "new_tokens": NEW_TOKENS,
                "prompts": prompts}, work / "inputs.pt")
    env = dict(os.environ, KFT_DIST_BACKEND="gloo")
    results = run_ranks([WORKER, "cuda", str(work)], 2, timeout_s=300,
                        cwd=str(REPO), env=env, threads=1)
    check_ranks(results)
    want = {}
    for name, rounds in (("greedy", 1), ("fused", 8)):
        eng = DecodeEngine(model, DecodeConfig(max_new_tokens=NEW_TOKENS),
                           decode_rounds=rounds, name=f"one-{name}",
                           **GEOMETRY)
        try:
            want[name] = [eng.submit({"tokens": np.asarray(p, np.int32)})
                          ["tokens"][0].tolist() for p in prompts]
        finally:
            eng.close()
    out = torch.load(work / "cuda.pt", weights_only=False)
    ranks = [torch.load(work / f"cuda-rank{r}.pt", weights_only=False)
             for r in range(2)]
    return out, ranks, want


@pytest.mark.parametrize("case", ["greedy", "fused"])
def test_two_ranks_equal_one_rank(job, case):
    out, ranks, want = job
    assert out[case] == want[case]
    assert out[f"{case}_stats"]["mesh_devices"] == 2
    for name, value in ranks[0][case].items():
        assert torch.equal(value, ranks[1][case][name]), name
