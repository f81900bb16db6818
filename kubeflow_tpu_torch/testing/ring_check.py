"""Ring attention across processes, one rank of it: each rank takes its
shard of the sequence from the cases its caller wrote, runs
``ring_attention`` forward and backward over the job's process group and
writes its o, dq, dk and dv with the launches they took.  The caller
holds them to attention on the whole sequence (``whole_sequence``, and
``reference_f32`` in float32).  ``tests/test_torch_ring.py`` runs it on
the CPU, ``tests/test_torch_parallel_cuda.py`` and ``chip_smoke.py``
phase 7f as several processes sharing one GPU.

    python -m kubeflow_tpu_torch.testing.ring_check WORKDIR

runs one rank (the ``KFT_*`` variables name it; ``run_job`` starts the
job through ``ranks.run_ranks``), over gloo.  ``WORKDIR/inputs.pt``
holds ``{"device": "cpu" or "cuda", "timeout_s": s, "time_reps": n,
"cases": {name: {"q", "k", "v", "g": [b, S, h or hkv, d] tensors of
the whole sequence, "causal": bool}}}``; rank r writes
``WORKDIR/rank<r>.pt``: per case its shards of o, dq, dk, dv, the
kernel launches (``ops/flash.py`` counts, CUDA) and the plain versions'
calls by mask (CPU) over its forward and backward, and, with
``time_reps`` on CUDA, the forward's and the backward's ms.

With ``"mesh"`` in the inputs (``MeshSpec`` sizes) the ranks build that
mesh and run ``make_ring_attention`` over it, each on its rows (data x
fsdp), its sequence shard and its heads (query and kv heads alike over
``tensor``), as the JAX package's mixed-mesh ring runs; each rank also
writes where its shard lies (``"split"``), and ``gathered`` puts the
shards back together.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from kubeflow_tpu_torch.ops import flash

REPO = Path(__file__).resolve().parents[2]


def _count_plain_calls() -> Dict[str, int]:
    """Count the plain versions' calls by mask from here on (the CPU's
    counterpart of the kernels' launch counts)."""
    calls = {"fwd_causal": 0, "fwd_full": 0, "bwd_causal": 0,
             "bwd_full": 0}
    fwd, bwd = flash.flash_fwd_reference, flash.flash_bwd_reference

    def fwd_counted(q, k, v, *, causal, kv_start=None):
        calls["fwd_causal" if causal else "fwd_full"] += 1
        return fwd(q, k, v, causal=causal, kv_start=kv_start)

    def bwd_counted(q, k, v, g, lse, delta, *, causal):
        calls["bwd_causal" if causal else "bwd_full"] += 1
        return bwd(q, k, v, g, lse, delta, causal=causal)

    flash.flash_fwd_reference = fwd_counted
    flash.flash_bwd_reference = bwd_counted
    return calls


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _splits(spec, rank: int, world: int):
    """(the ring's attention function of (q, k, v, causal), and this
    rank's (index, count) along the batch, sequence and head dims)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import mesh as mesh_lib
    from kubeflow_tpu_torch.parallel.ring import (
        make_ring_attention,
        ring_attention,
    )

    if spec.get("mesh") is None:
        def attend(q, k, v, causal):
            return ring_attention(q, k, v, group=dist.group.WORLD,
                                  causal=causal)

        return attend, ((0, 1), (rank, world), (0, 1))
    mesh = mesh_lib.MeshSpec(**spec["mesh"]).build(
        spec["device"], timeout_s=spec.get("timeout_s", 120))
    sizes = mesh_lib.axis_sizes(mesh)
    rings = {c: make_ring_attention(mesh, causal=c) for c in (True, False)}
    rows = (mesh.get_local_rank(mesh_lib.DATA) * sizes[mesh_lib.FSDP]
            + mesh.get_local_rank(mesh_lib.FSDP),
            sizes[mesh_lib.DATA] * sizes[mesh_lib.FSDP])
    return (lambda q, k, v, causal: rings[causal](q, k, v),
            (rows, (mesh.get_local_rank(mesh_lib.SEQUENCE),
                    sizes[mesh_lib.SEQUENCE]),
             mesh_lib.tensor_shard(mesh)))


def run_rank(workdir: Path) -> None:
    import torch.distributed as dist

    from kubeflow_tpu_torch.runtime import bootstrap

    spec = torch.load(workdir / "inputs.pt", weights_only=True)
    bootstrap.initialize(device=spec["device"],
                         timeout_s=spec.get("timeout_s", 120))
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(spec["device"])
    attend, split = _splits(spec, rank, world)
    calls = _count_plain_calls()
    out = {}
    for name, case in spec["cases"].items():
        def shard(t):
            for dim, (i, n) in enumerate(split):
                t = t.chunk(n, dim=dim)[i]
            return t.to(dev).contiguous()

        q, k, v = (shard(case[x]).requires_grad_() for x in "qkv")
        g = shard(case["g"])
        causal = bool(case["causal"])
        for key in flash.launch_counts:
            flash.launch_counts[key] = 0
        for key in calls:
            calls[key] = 0
        o = attend(q, k, v, causal)
        o.backward(g)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        res = {"o": o.detach().cpu(), "dq": q.grad.cpu(),
               "dk": k.grad.cpu(), "dv": v.grad.cpu(),
               "launches": dict(flash.launch_counts),
               "plain_calls": dict(calls), "split": split}
        reps = int(spec.get("time_reps", 0))
        if reps and dev.type == "cuda":
            dist.barrier()
            with torch.no_grad():
                res["fwd_ms"] = _time_ms(
                    lambda: attend(q, k, v, causal), reps)
            o = attend(q, k, v, causal)
            dist.barrier()
            res["bwd_ms"] = _time_ms(
                lambda: torch.autograd.grad(o, (q, k, v), g,
                                            retain_graph=True), reps)
        out[name] = res
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def run_job(workdir: Path, cases: Dict[str, dict], world: int,
            device: str, *, time_reps: int = 0, timeout_s: float = 300.0,
            threads: Optional[int] = None,
            mesh: Optional[Dict[str, int]] = None) -> List[dict]:
    """Write ``cases`` ({name: {"q", "k", "v", "g", "causal"}}, whole
    sequences) and run the ring on ``world`` ranks of ``device`` over
    them (over ``mesh``'s sequence axis, each rank on its rows and heads
    too, when ``mesh`` gives ``MeshSpec`` sizes); each rank's results, in
    rank order.  Raises if a rank fails or the job outlasts
    ``timeout_s``."""
    from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks

    host = {name: {k: v.detach().cpu() if torch.is_tensor(v) else v
                   for k, v in case.items()} for name, case in cases.items()}
    torch.save({"device": device, "timeout_s": min(timeout_s, 120.0),
                "time_reps": time_reps, "cases": host, "mesh": mesh},
               workdir / "inputs.pt")
    # gloo: on the card the ranks share one GPU, which NCCL refuses.
    check_ranks(run_ranks(
        ["-m", "kubeflow_tpu_torch.testing.ring_check", str(workdir)],
        world, timeout_s=timeout_s, cwd=str(REPO), threads=threads,
        env=dict(os.environ, KFT_DIST_BACKEND="gloo")))
    return [torch.load(workdir / f"rank{r}.pt", weights_only=True)
            for r in range(world)]


def gathered(results: List[dict], case: str, key: str) -> torch.Tensor:
    """The ranks' shards of ``key`` put back together: along the
    sequence, and along the rows and heads of a mesh's ring."""
    first = results[0][case]
    shape = [n * c for n, (_, c) in zip(first[key].shape, first["split"])]
    out = torch.empty(shape + list(first[key].shape[3:]),
                      dtype=first[key].dtype)
    for r in results:
        part = r[case][key]
        index = tuple(slice(i * n, (i + 1) * n) for n, (i, _) in
                      zip(part.shape, r[case]["split"]))
        out[index] = part
    return out


def totals(results: List[dict], case: str, field: str) -> Dict[str, int]:
    """``field`` ("launches" or "plain_calls") summed over the ranks."""
    out: Dict[str, int] = {}
    for r in results:
        for key, n in r[case][field].items():
            out[key] = out.get(key, 0) + n
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative Frobenius error of ``got`` against ``want``, in float32."""
    want = want.float()
    return float((got.float().to(want.device) - want).norm()
                 / want.norm().clamp_min(1e-30))


def whole_sequence(q, k, v, g, causal: bool
                   ) -> Tuple[torch.Tensor, ...]:
    """(o, dq, dk, dv) of ``flash_attention`` on the whole sequence in
    one process: the kernels on CUDA tensors, the plain versions on CPU
    ones."""
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = flash.flash_attention(q, k, v, causal=causal)
    o.backward(g)
    return o.detach(), q.grad, k.grad, v.grad


def reference_f32(q, k, v, g, causal: bool, chunk: int = 1024
                  ) -> Tuple[torch.Tensor, ...]:
    """(o, dq, dk, dv) of softmax attention in float32 on the inputs'
    device, ``chunk`` query rows at a time (at s 16384 the whole score
    matrix would not fit twice): o and dq per chunk, dk and dv summed
    over the chunks.  GQA kv heads are repeated and their gradients
    folded back by autograd."""
    b, s, h, d = q.shape
    q32, g32 = q.float(), g.float()
    k32 = k.detach().float().requires_grad_()
    v32 = v.detach().float().requires_grad_()
    o = torch.empty_like(q32)
    dq = torch.empty_like(q32)
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        qc = q32[:, lo:hi].detach().requires_grad_()
        kr, vr = flash.repeat_kv(k32, v32, h)
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, kr) * d ** -0.5
        if causal:
            keep = (torch.arange(lo, hi, device=q.device)[:, None]
                    >= torch.arange(s, device=q.device)[None, :])
            scores = scores.masked_fill(~keep, float("-inf"))
        oc = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), vr)
        oc.backward(g32[:, lo:hi])
        o[:, lo:hi] = oc.detach()
        dq[:, lo:hi] = qc.grad
    return o, dq, k32.grad, v32.grad


if __name__ == "__main__":
    run_rank(Path(sys.argv[1]))
