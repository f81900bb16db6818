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

Under a mesh (models/transformer.py sets it up) the layer runs on this
rank's tokens, where JAX's runs on the global arrays under XLA's
partitioner; three attributes say how:

  - ``spread`` (a ``Spread``): how many ranks hold the tokens of one
    routing call and how.  The routing group is fitted to the call's
    global token count, as JAX fits it, over JAX's order of the call's
    tokens (the global row-major ``[B, S]``, or under a pipeline JAX's
    microbatch).  Where the groups tile the rank's own tokens (a run of
    whole rows, or, split over ``sequence``, a slice of every row) the
    rank routes them alone.  Where a group spans ranks, each rank still
    routes only its own tokens, with the whole router: routing is per
    token but for the slot position, and that comes from the counts of
    the group's tokens before the rank's own in JAX's order (``_Spanning``:
    an all-gather of integer per-expert counts, no token moves), with the
    capacity of the global group; the dispatch and combine then run on
    the rank's segments of its groups.  The aux loss is the global one:
    the per-expert top-1
    counts and probability sums are summed over ``spread.group``, so its
    value is JAX's over all the call's tokens on every rank, and its
    gradient is this rank's share of the global aux's (the convention of
    ``lm_task(mesh=)``'s loss);
  - ``first_expert``: the global index of the rank's first expert when
    ``wi`` and ``wo`` hold a slice of the experts (the ``expert`` axis);
  - ``group``: the ranks that hold the other experts or the other slices
    of the mlp dim (``expert`` x ``tensor``).  Every rank routes all of
    its tokens with the whole router, builds the dispatch and combine of
    its own experts only and runs their slots through its slices of
    ``wi`` and ``wo``; the combine is linear in the experts' outputs, so
    its result is a partial sum that one ``reduce_from_parallel`` over
    the group completes.  The tokens enter the dispatch, and the gates
    the combine, through ``copy_to_parallel``: each rank's gradients of
    them cover its own slots, and the backward sums them over the group.
    The router's softmax and the aux read the tokens outside those
    copies, so the aux's gradient is counted once, not once a rank, and
    the router's gradient is whole and equal on every rank of the group.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.parallel import tensor as tp
from kubeflow_tpu_torch.parallel.p2p import all_gather, all_reduce


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


@dataclasses.dataclass(frozen=True)
class Spread:
    """How the tokens of one routing call lie over ranks: ``ranks`` ranks
    hold equal shares of them (1: this rank holds them all), with the
    process ``group`` over which their statistics are summed, in the
    group's rank order; ``shards`` above 1: the rows are split over that
    many ranks (the sequence axis, innermost in that order) and each rank
    holds a slice of every row of its run of rows, else each rank holds a
    run of whole rows."""

    ranks: int = 1
    group: Any = None
    shards: int = 1


class _Spanning:
    """The layout of a routing call on this rank (index ``index`` of
    ``spread``'s group, tokens ``[b, s]``) when its groups of ``g`` tokens
    span ranks.

    JAX's order of the call's tokens is the global row-major one; it is
    cut into runs of ``length`` tokens, each held whole by one rank: the
    rank's rows (one run), or with the rows split over ``shards`` ranks
    each row's slice (``b`` runs).  A run meets at most ``slots`` groups;
    its tokens of one group, a segment, are contiguous.  This rank's
    tokens are laid out as ``[runs x slots, width]`` segments
    (``pad``, ``unpad``; ``valid`` marks the padding off), and a token's
    slot position in its group is JAX's: the group's counts of the
    earlier choices, the counts of its expert in the segments of the
    group before its own (every rank's, all-gathered: integers, no
    gradient) and the cumsum within its segment (``routes``).  Every
    index here depends on the shapes alone."""

    def __init__(self, b: int, s: int, g: int, spread: Spread, index: int,
                 device):
        shards = spread.shards
        n_runs, length = (b, s) if shards > 1 else (1, b * s)

        def runs_of(k):
            if shards == 1:
                return [k]
            rows, q = divmod(k, shards)
            return [(rows * b + i) * shards + q for i in range(b)]

        def groups(u):
            return u * length // g, ((u + 1) * length - 1) // g

        every = [runs_of(k) for k in range(spread.ranks)]
        slots = max(hi - lo + 1 for runs in every for lo, hi in
                    map(groups, runs))
        width = min(g, length)
        # Every rank's segments in all-gather order (rank, run, slot),
        # then sorted into JAX's order: by run, then slot.
        keys, group_of = [], []
        for runs in every:
            for u in runs:
                lo, hi = groups(u)
                for w in range(slots):
                    keys.append((u, w))
                    group_of.append(lo + w if lo + w <= hi else -1)
        order = sorted(range(len(keys)), key=keys.__getitem__)
        at = {old: new for new, old in enumerate(order)}
        sorted_groups = [group_of[i] for i in order]
        # Each sorted segment's group's first and last segments (padding
        # slots, which hold no token, stand for themselves).
        bounds: dict = {}
        for pos, grp in enumerate(sorted_groups):
            if grp >= 0:
                bounds.setdefault(grp, [pos, pos])[1] = pos
        first = [bounds[grp][0] if grp >= 0 else pos
                 for pos, grp in enumerate(sorted_groups)]
        last = [bounds[grp][1] if grp >= 0 else pos
                for pos, grp in enumerate(sorted_groups)]
        n_local = b * s
        src = torch.full((n_runs * slots, width), n_local, dtype=torch.int64)
        mine = []
        for i, u in enumerate(every[index]):
            lo, hi = groups(u)
            for w in range(slots):
                mine.append(at[(index * n_runs + i) * slots + w])
                if lo + w > hi:
                    continue
                start = max(0, (lo + w) * g - u * length)
                end = min(length, (lo + w + 1) * g - u * length)
                src[i * slots + w, :end - start] = torch.arange(
                    i * length + start, i * length + end)
        valid = src < n_local
        inv = torch.empty(n_local, dtype=torch.int64)
        inv[src[valid]] = torch.arange(src.numel())[valid.flatten()]
        self.shape = (n_runs * slots, width)
        self.src, self.valid, self.inv = (t.to(device)
                                          for t in (src, valid, inv))
        self.order, self.first, self.last, self.mine = (
            torch.tensor(t, dtype=torch.int64, device=device)
            for t in (order, first, last, mine))

    def pad(self, flat: torch.Tensor) -> torch.Tensor:
        """Tokens ``[b s, ...]`` laid out as segments ``[runs x slots,
        width, ...]``, the padding zero."""
        table = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
        return table[self.src]

    def unpad(self, t: torch.Tensor) -> torch.Tensor:
        """Segments ``[runs x slots, width, ...]`` back to this rank's
        tokens ``[b s, ...]``."""
        return t.reshape((-1,) + t.shape[2:])[self.inv]

    def routes(self, gate_idx: torch.Tensor, capacity: int, experts: int,
               group) -> list:
        """Per choice the expert, JAX's slot position and the kept flag of
        each segment token, ``[runs x slots, width]`` each, from the
        top-k experts ``gate_idx`` ``[runs x slots, width, k]``."""
        k = gate_idx.shape[-1]
        onehots = [F.one_hot(gate_idx[..., c], experts)
                   * self.valid[..., None] for c in range(k)]
        counts = torch.stack([oh.sum(1) for oh in onehots])
        every = all_gather(counts, group)  # [ranks, k, segments, E]
        table = every.movedim(0, 1).reshape(k, -1, experts)[:, self.order]
        cum = table.cumsum(1)
        start = (cum - table)[:, self.first]
        before = (cum - table - start)[:, self.mine]
        total = (cum[:, self.last] - start)[:, self.mine]
        routes, base = [], torch.zeros_like(total[0])
        for c in range(k):
            idx = gate_idx[..., c]
            pos = (base + before[c])[:, None, :] \
                + torch.cumsum(onehots[c], dim=1) - 1
            my_pos = torch.gather(pos, 2, idx[..., None])[..., 0]
            base = base + total[c]
            routes.append((idx, my_pos, self.valid & (my_pos < capacity)))
        return routes


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
        # Under a mesh (the module docstring): the tokens' spread over
        # ranks, this rank's first expert, the group of its partial sums
        # (expert x tensor) and the groups of its expert and of its mlp
        # slices.
        self.spread = Spread()
        self.first_expert = 0
        self.group = self.expert_group = self.tensor_group = None
        # ``_Spanning`` layouts by shape, spread and device.
        self._layouts: dict = {}

    def _route(self, tokens: torch.Tensor, capacity: int,
               spanning: Optional[_Spanning] = None):
        """Float32 routing of tokens [G, g, d]: probs [G, g, E], the
        renormalized gates and the top-k experts [G, g, k], and per
        choice the expert, slot position and kept flag, each [G, g].
        ``spanning``: the tokens are this rank's segments of groups that
        span ranks, whose positions it gives."""
        e = self.num_experts
        logits = torch.einsum("gnd,de->gne", tokens.float(), self.router)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = top_k_lower_first(probs, self.top_k)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
        if spanning is not None:
            return probs, gate_vals, gate_idx, spanning.routes(
                gate_idx, capacity, e, self.spread.group)
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

    def fit(self, b: int, s: int) -> int:
        """The routing group of tokens ``[b, s]``: fitted to the routing
        call's global token count, as JAX fits it."""
        return fit_divisor(
            b * s * self.spread.ranks,
            self.group_size or default_group_size(self.impl),
            "MoE routing group",
            "Per-group capacity clamps to top_k and expert "
            "compute/memory inflates by up to num_experts/top_k x.  "
            "Choose batch*seq with a divisor close to group_size.")

    def _spanning(self, b: int, s: int, g: int,
                  device) -> Optional[_Spanning]:
        """The layout of this rank's tokens when groups of ``g`` span
        ranks; None when they tile its rows (or, split over the sequence,
        its slice of each row)."""
        spread = self.spread
        if (s if spread.shards > 1 else b * s) % g == 0:
            return None
        import torch.distributed as dist

        key = (b, s, g, spread.ranks, spread.shards, id(spread.group),
               str(device))
        if key not in self._layouts:
            self._layouts[key] = _Spanning(
                b, s, g, spread, dist.get_rank(spread.group), device)
        return self._layouts[key]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        e, k, dt = self.num_experts, self.top_k, self.dtype
        b, s, d = x.shape
        n_tokens = b * s
        g = self.fit(b, s)
        capacity = max(k, int(math.ceil(g * k / e * self.capacity_factor)))
        spanning = self._spanning(b, s, g, x.device)
        if spanning is None:
            tokens = x.reshape(n_tokens // g, g, d)
        else:
            # This rank's segments of groups that span ranks, each padded
            # to ``width`` tokens; the padding is never kept.
            tokens = spanning.pad(x.reshape(n_tokens, d))
        n_groups, g = tokens.shape[:2]
        probs, gate_vals, gate_idx, routes = self._route(tokens, capacity,
                                                         spanning)
        rows = torch.arange(n_groups, device=x.device)
        # This rank's experts [lo, lo + n_local).  The gates' gradient
        # covers only its slots: the backward sums it over ``group``.
        lo, n_local = self.first_expert, self.wi.shape[0]
        gate_vals = tp.copy_to_parallel(gate_vals, self.group)
        # Copied in the dispatch's dtype: the gradients' sum over the
        # experts rounds once to it, as one device's dispatch einsum does.
        dispatched = tp.copy_to_parallel(
            tokens.to(dt if self.impl == "gather" else torch.bfloat16),
            self.expert_group)

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
            slot_src = slot_src[:, lo:lo + n_local, :capacity]
            tokens_pad = torch.cat(
                [dispatched, dispatched.new_zeros((n_groups, 1, d))], dim=1)
            expert_in = tokens_pad[rows[:, None, None], slot_src]
            expert_out = self._experts(expert_in, "gecd,edf->gecf",
                                       "gecf,efd->gecd")
            out = torch.zeros((n_groups, g, d), dtype=expert_out.dtype,
                              device=x.device)
            for choice, (idx, pos, keep) in enumerate(routes):
                mine = (idx >= lo) & (idx < lo + n_local)
                picked = expert_out[rows[:, None],
                                    torch.clamp(idx - lo, 0, n_local - 1),
                                    torch.clamp(pos, 0, capacity - 1)]
                w = (gate_vals[..., choice] * (keep & mine)).to(dt)[..., None]
                out = out + picked * w
        else:
            dispatch = torch.zeros((n_groups, g, n_local, capacity),
                                   dtype=torch.bfloat16, device=x.device)
            combine = torch.zeros((n_groups, g, n_local, capacity),
                                  dtype=torch.float32, device=x.device)
            for choice, (idx, pos, keep) in enumerate(routes):
                onehot = F.one_hot(idx, e).float()[..., lo:lo + n_local]
                pos_onehot = F.one_hot(
                    torch.where(keep, pos, capacity),
                    capacity + 1).float()[..., :capacity]
                contrib = onehot[..., :, None] * pos_onehot[..., None, :]
                dispatch = dispatch + contrib.to(torch.bfloat16)
                combine = combine \
                    + contrib * gate_vals[..., choice, None, None]
            # Expert axis leading, [E, G*C, d]: one batched product per
            # expert through the MLP.
            expert_in = torch.einsum("gnec,gnd->egcd", dispatch, dispatched)
            expert_out = self._experts(
                expert_in.reshape(n_local, n_groups * capacity, d),
                "end,edf->enf", "enf,efd->end",
            ).reshape(n_local, n_groups, capacity, d)
            out = torch.einsum("gnec,egcd->gnd",
                               combine.to(expert_out.dtype), expert_out)
        out = tp.reduce_from_parallel(out, self.group)
        top1 = gate_idx[..., 0]
        if spanning is None:
            out, top1, flat_probs = (out.reshape(n_tokens, d),
                                     top1.reshape(n_tokens),
                                     probs.reshape(n_tokens, e))
        else:
            out, top1, flat_probs = (spanning.unpad(t)
                                     for t in (out, top1, probs))
        top1 = F.one_hot(top1, e).float()
        if self.spread.group is None:
            fraction = top1.mean(0)
            mean_prob = flat_probs.mean(0)
            aux = e * torch.sum(fraction * mean_prob)
        else:
            aux = self._global_aux(top1.sum(0), flat_probs.sum(0),
                                   n_tokens * self.spread.ranks)
        return out.reshape(b, s, d).to(dt), aux

    def _global_aux(self, counts: torch.Tensor, prob_sums: torch.Tensor,
                    n_tokens: int) -> torch.Tensor:
        """The aux over the ``n_tokens`` of every rank of the spread from
        this rank's per-expert top-1 ``counts`` and probability sums: the
        global value, with this rank's share of its gradient (the counts
        take none)."""
        e = self.num_experts
        totals = all_reduce(torch.stack([counts, prob_sums.detach()]),
                            self.spread.group)
        fraction = totals[0] / n_tokens
        share = e * torch.sum(fraction * prob_sums / n_tokens)
        whole = e * torch.sum(fraction * totals[1] / n_tokens)
        return whole + (share - share.detach())

    def _experts(self, x: torch.Tensor, up: str, down: str) -> torch.Tensor:
        """Batched SwiGLU over the expert slots: ``up`` is the gate/up
        einsum, ``down`` the projection back (this rank's partial sum
        when the mlp dim is split over ``tensor``).  Mixed operands
        compute in their promoted dtype, as jnp.einsum does (bfloat16
        slots and float32 weights at float32)."""
        ct = torch.promote_types(x.dtype, self.dtype)
        wi = self.wi.to(self.dtype).to(ct)

        def widened():
            # Each einsum widens ``x`` on its own, so the backward rounds
            # each one's input gradient to the slots' dtype before the
            # two are summed, as JAX's transposed mixed-precision dots do;
            # with the mlp dim split, that gradient is summed over the
            # tensor group first, in ``ct``.
            return tp.copy_to_parallel(x.to(ct), self.tensor_group)

        gate = torch.einsum(up, widened(), wi[:, 0])
        upv = torch.einsum(up, widened(), wi[:, 1])
        return torch.einsum(down, F.silu(gate) * upv,
                            self.wo.to(self.dtype).to(ct))
