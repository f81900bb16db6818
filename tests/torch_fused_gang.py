"""The fused gang of the model-axis parity jobs, on the ranks' side.

JAX-free: the rank workers (tests/torch_mesh_train_worker.py ``tensor2``
and ``dropout4``, tests/torch_moe_mesh_worker.py ``moe_batch4``,
tests/torch_pipeline_worker.py ``pipe2``) run ``gang`` on one of their
meshes, and the test in the pytest process holds what it returns to the
JAX ``FusedTrainer`` on the same mesh shape (tests/torch_fused_jax.py).
The gang is ``GANG``: m0 and m1 from seeds 0 and 1 at lr 1e-3 and 2e-3,
m1 stopping at step 2, ``GANG_STEPS`` fused steps of
``FusedTrainer.fit``, every rank given the global batch.  ``strict_map``
turns torch.func.vmap's fallback warning into an error: no member loop
may hide in the map, and no collective may run on a member's view.
"""

import os
import warnings

import torch

from kubeflow_tpu_torch.models.convert import whole_parameters
from kubeflow_tpu_torch.models.transformer import lm_task
from kubeflow_tpu_torch.runtime.hfta import FusedTrainer, MemberSpec
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger

GANG = [dict(name="m0", seed=0, lr=1e-3),
        dict(name="m1", seed=1, lr=2e-3, stop_step=2)]
GANG_STEPS = 3


def strict_map():
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    warnings.filterwarnings("error", "There is a performance drop")


def stacked(state):
    """Every tensor of a fused adamw state (parameters, moments, counts,
    learning rates, steps), copied, by name."""
    out = {f"params.{k}": v.detach().clone()
           for k, v in state.params.items()}
    out["step"] = state.step.clone()
    inner = state.opt_state.inner
    out["count"] = inner.count.clone()
    out["lr"] = state.opt_state.learning_rate.clone()
    for name in ("mu", "nu"):
        for i, t in enumerate(getattr(inner, name)):
            out[f"{name}.{i}"] = t.clone()
    return out


def _whole(ft, state, i):
    """Member ``i``'s whole parameters (gathered over the splits: a
    collective)."""
    return {k: v.clone() for k, v in
            whole_parameters(ft.member_state(state, i).params).items()}


def gang(cfg, mesh, batches, ckpt=None):
    """``GANG`` over ``mesh`` through ``FusedTrainer.fit`` on the global
    ``batches`` (each [B, S]): each step's per-member loss and grad_norm,
    the member steps, m1's rows of this rank's stacked state at its stop
    and at the end, and each member's whole parameters after the steps.
    With ``ckpt``, the fit checkpoints each member there every step."""
    strict_map()
    init_fn, loss_fn = lm_task(cfg, device="cpu", mesh=mesh)
    ft = FusedTrainer(init_fn=init_fn, loss_fn=loss_fn,
                      members=[MemberSpec(**m) for m in GANG], mesh=mesh,
                      device="cpu", checkpoint_dir=ckpt and str(ckpt),
                      checkpoint_every=1,
                      metrics=MetricsLogger(stream=open(os.devnull, "w")))
    body, out = ft._fused_step, {"metrics": []}

    def step(state, active, stops, batch):
        state, active, m = body(state, active, stops, batch)
        out["metrics"].append({k: m[k].clone()
                               for k in ("loss", "grad_norm")})
        if len(out["metrics"]) == GANG[1]["stop_step"]:
            out["m1_at_stop"] = {k: v[1] for k, v in stacked(state).items()}
        return state, active, m

    ft.compile_step = lambda: step
    state = ft.fit(iter({"tokens": b} for b in batches), GANG_STEPS,
                   log_every=0)
    out["m1_at_end"] = {k: v[1] for k, v in stacked(state).items()}
    out["steps"] = state.step.tolist()
    out["params"] = [_whole(ft, state, i) for i in range(len(GANG))]
    return out
