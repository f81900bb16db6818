"""Mixture-of-Experts MLP on one device: the port of
kubeflow_tpu/models/moe.py.

GShard-style routing in fixed-size token groups, as in the JAX package:

  - routing in float32: softmax over the router logits, ``top_k``
    experts per token (ties to the lower expert index, as
    ``jax.lax.top_k``), the kept gates renormalized;
  - greedy per-choice slot positions by a cumsum along each group's
    token axis, with a per-group capacity ``C = max(top_k, ceil(g *
    top_k / E * capacity_factor))``; tokens past it are dropped (the
    residual connection carries them);
  - ``impl="einsum"``: one-hot dispatch and combine tensors ``[G, g, E,
    C]`` contracted with the tokens; the dispatch tensor and the tokens
    are rounded to bfloat16 whatever the compute dtype, as JAX builds
    them;
  - ``impl="gather"``: the same decisions as a slot -> token index map
    (dropped tokens write an extra column that is cut off), a row gather
    into the expert batch and a per-choice row gather back out, in the
    compute dtype;
  - the Switch load-balancing aux loss over all tokens, from the top-1
    choice: ``E * sum_e fraction_e * mean_prob_e``.

The dispatch, combine and expert einsums are XLA ops in JAX, not Pallas
kernels, so they are torch ops here.  ``forward`` returns ``(out,
aux)``; models/transformer.py sums ``aux`` over the layers.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def default_group_size(impl: str) -> int:
    """Each impl's routing group when ``group_size`` is 0 (the JAX
    package's v5e optimum: einsum 128, gather 256)."""
    return 256 if impl == "gather" else 128


def fit_divisor(n: int, limit: int, label: str, consequence: str) -> int:
    """Largest divisor of ``n`` <= ``limit``: the tiling fit of the MoE
    routing group and the chunked-CE loop.

    Below limit//4 a warning names the ``label`` and its
    ``consequence`` so the config is fixed rather than silently paid
    every step."""
    want = min(limit, n)
    got = next(c for c in range(want, 0, -1) if n % c == 0)
    if got < want // 4:
        warnings.warn(
            f"{label} degenerated: {n} has no divisor near {limit} "
            f"(fitted {got}).  {consequence}",
            stacklevel=3,
        )
    return got


def top_k_lower_first(probs: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values and
    their indices, equal values in index order (a stable descending
    sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEMLP(nn.Module):
    """Drop-in replacement for the dense SwiGLU MLP: ``x [b, s, d] ->
    (out [b, s, d] in ``dtype``, aux scalar float32)``.

    Parameters keep the JAX names and layouts: ``router [d, E]``, ``wi
    [E, 2, d, f]``, ``wo [E, f, d]``, float32, lecun-normal from
    ``generator``."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 group_size: int = 0, dtype: torch.dtype = torch.bfloat16,
                 impl: str = "einsum",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        from kubeflow_tpu_torch.models.transformer import _param

        if impl not in ("einsum", "gather"):
            raise ValueError(f"unknown moe impl {impl!r}")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.group_size = group_size
        self.dtype, self.impl = dtype, impl
        self.router = _param((d_model, num_experts), generator, device)
        self.wi = _param((num_experts, 2, d_model, d_ff), generator, device)
        self.wo = _param((num_experts, d_ff, d_model), generator, device)

    def _route(self, tokens: torch.Tensor, capacity: int):
        """Float32 routing of tokens [G, g, d]: probs [G, g, E], the
        renormalized gates and the top-k experts [G, g, k], and per
        choice the expert, slot position and kept flag, each [G, g]."""
        e = self.num_experts
        logits = torch.einsum("gnd,de->gne", tokens.float(), self.router)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = top_k_lower_first(probs, self.top_k)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
        routes = []
        counts = torch.zeros((tokens.shape[0], e), dtype=torch.int64,
                             device=tokens.device)
        for choice in range(self.top_k):
            idx = gate_idx[..., choice]
            onehot = F.one_hot(idx, e)
            pos = counts[:, None, :] + torch.cumsum(onehot, dim=1) - 1
            my_pos = torch.gather(pos, 2, idx[..., None])[..., 0]
            counts = counts + onehot.sum(1)
            routes.append((idx, my_pos, my_pos < capacity))
        return probs, gate_vals, gate_idx, routes

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        e, k, dt = self.num_experts, self.top_k, self.dtype
        b, s, d = x.shape
        n_tokens = b * s
        g = fit_divisor(
            n_tokens, self.group_size or default_group_size(self.impl),
            "MoE routing group",
            "Per-group capacity clamps to top_k and expert "
            "compute/memory inflates by up to num_experts/top_k x.  "
            "Choose batch*seq with a divisor close to group_size.")
        n_groups = n_tokens // g
        capacity = max(k, int(math.ceil(g * k / e * self.capacity_factor)))
        tokens = x.reshape(n_groups, g, d)
        probs, gate_vals, gate_idx, routes = self._route(tokens, capacity)
        rows = torch.arange(n_groups, device=x.device)

        if self.impl == "gather":
            # Slot -> source token; dropped tokens write column
            # `capacity`, cut off below.  Sentinel g reads the zero row
            # appended to the token table, so empty slots see zeros.
            slot_src = torch.full((n_groups, e, capacity + 1), g,
                                  dtype=torch.int64, device=x.device)
            token_ids = torch.arange(g, device=x.device).expand(n_groups, g)
            # Out of place, so that the fused trainer's member map
            # (runtime/member_map.py) batches it: an in-place scatter of
            # mapped indices into an unmapped table has no batching rule.
            for idx, pos, keep in routes:
                col = torch.where(keep, pos, capacity)
                slot_src = slot_src.view(n_groups, -1).scatter(
                    1, idx * (capacity + 1) + col, token_ids).view(
                        n_groups, e, capacity + 1)
            slot_src = slot_src[:, :, :capacity]
            tokens_pad = torch.cat(
                [tokens.to(dt), tokens.new_zeros((n_groups, 1, d), dtype=dt)],
                dim=1)
            expert_in = tokens_pad[rows[:, None, None], slot_src]
            expert_out = self._experts(expert_in, "gecd,edf->gecf",
                                       "gecf,efd->gecd")
            out = torch.zeros((n_groups, g, d), dtype=expert_out.dtype,
                              device=x.device)
            for choice, (idx, pos, keep) in enumerate(routes):
                picked = expert_out[rows[:, None], idx,
                                    torch.clamp(pos, 0, capacity - 1)]
                w = (gate_vals[..., choice] * keep).to(dt)[..., None]
                out = out + picked * w
        else:
            dispatch = torch.zeros((n_groups, g, e, capacity),
                                   dtype=torch.bfloat16, device=x.device)
            combine = torch.zeros((n_groups, g, e, capacity),
                                  dtype=torch.float32, device=x.device)
            for choice, (idx, pos, keep) in enumerate(routes):
                onehot = F.one_hot(idx, e).float()
                pos_onehot = F.one_hot(
                    torch.where(keep, pos, capacity),
                    capacity + 1).float()[..., :capacity]
                contrib = onehot[..., :, None] * pos_onehot[..., None, :]
                dispatch = dispatch + contrib.to(torch.bfloat16)
                combine = combine \
                    + contrib * gate_vals[..., choice, None, None]
            # Expert axis leading, [E, G*C, d]: one batched product per
            # expert through the MLP.
            expert_in = torch.einsum("gnec,gnd->egcd", dispatch,
                                     tokens.to(torch.bfloat16))
            expert_out = self._experts(
                expert_in.reshape(e, n_groups * capacity, d),
                "end,edf->enf", "enf,efd->end",
            ).reshape(e, n_groups, capacity, d)
            out = torch.einsum("gnec,egcd->gnd",
                               combine.to(expert_out.dtype), expert_out)

        top1 = F.one_hot(gate_idx[..., 0].reshape(n_tokens), e).float()
        fraction = top1.mean(0)
        mean_prob = probs.reshape(n_tokens, e).mean(0)
        aux = e * torch.sum(fraction * mean_prob)
        return out.reshape(b, s, d).to(dt), aux

    def _experts(self, x: torch.Tensor, up: str, down: str) -> torch.Tensor:
        """Batched SwiGLU over the expert slots: ``up`` is the gate/up
        einsum, ``down`` the projection back.  Mixed operands compute in
        their promoted dtype, as jnp.einsum does (bfloat16 slots and
        float32 weights at float32).  Each einsum widens ``x`` on its
        own, so the backward rounds each one's input gradient to the
        slots' dtype before the two are summed, as JAX's transposed
        mixed-precision dots do."""
        ct = torch.promote_types(x.dtype, self.dtype)
        wi = self.wi.to(self.dtype).to(ct)
        gate = torch.einsum(up, x.to(ct), wi[:, 0])
        upv = torch.einsum(up, x.to(ct), wi[:, 1])
        return torch.einsum(down, F.silu(gate) * upv,
                            self.wo.to(self.dtype).to(ct))
