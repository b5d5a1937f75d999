"""Top-k Mixture of Experts with capacity-bounded, index-table dispatch.

The port of ``repro.models.moe``: GShard semantics (top-k routing, a
capacity factor, token dropping) with an ``(E, C)`` table of token ids per
expert instead of a ``(T, E, C)`` one-hot einsum.  Every integer result
(expert ids, queue positions, the keep mask, the table) equals the JAX
package's; so do the dtypes: the router runs in float32 (its weight stays
float32 under any model dtype), the softmax and the renormalisation in
float32, and the combine weights the expert outputs by the gates cast to
the activation's dtype.

* ``moe_layer`` — the prefill / training layer over ``(B, S, d)``: the
  ``T = B * S`` tokens form ``n_groups`` contiguous groups of ``T //
  n_groups`` (one group when ``T % n_groups``), each with its own
  capacity C and its own ``(E, C)`` table; in its group each (token, k)
  takes its place in its expert's queue by its rank, in the token-major
  (then k) order, among the entries that chose that expert; entries past
  C spill into column C, which is cut off.  The aux losses are means over
  all groups' tokens.  Pad rows are routed and take queue places like
  any other row.
* ``moe_decode`` — the decode step's layer over ``(M, d)``: every expert
  computes all M rows (batched matmuls that read the ``(E, d, F)``
  weights in place) and the gates select.

Ties in the top-k take the lower expert index, as ``jax.lax.top_k``
does: ``torch.topk`` promises no order among equal values, so the choice
is a stable descending sort.  The combine adds a token's k weighted
expert outputs in float32, one k at a time, so that a row's result does
not depend on how many rows the call holds (the speculative verify step
runs M = B·(K + 1) rows where the decode step runs B).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rows_gemm.ops import rows_bmm, rows_gemm


def moe_shapes(d_model: int, d_ff: int,
               n_experts: int) -> Dict[str, Tuple[int, ...]]:
    """The shapes of one layer's MoE weights as
    ``repro.models.moe.init_moe`` lays them out: ``router.w (d, E)``
    (always float32), ``gate``/``up (E, d, F)``, ``down (E, F, d)``."""
    return {"router": (d_model, n_experts),
            "gate": (n_experts, d_model, d_ff),
            "up": (n_experts, d_model, d_ff),
            "down": (n_experts, d_ff, d_model)}


def _capacity(tokens_per_group: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = int(math.ceil(tokens_per_group * top_k / n_experts
                      * capacity_factor))
    return max(4, ((c + 3) // 4) * 4)


def route(logits: torch.Tensor, top_k: int):
    """float32 router logits (..., E) -> (probs, gate_vals, expert_idx):
    the softmax, the top-k (ties to the lower index) and the gates
    renormalised over the k."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(
        min=1e-9)
    return probs, gate_vals, expert_idx


def _combine(out_tok: torch.Tensor, gates: torch.Tensor,
             dtype, ep=None) -> torch.Tensor:
    """sum_k gates[..., k] * out_tok[..., k, :] in float32, k in order,
    rounded to ``dtype``: ``out_tok`` (..., k, d), ``gates`` (..., k)
    already in the activation's dtype.  With ``ep`` the float32 sum is
    this rank's experts' part, summed over the model group before the
    rounding."""
    prod = out_tok * gates.float().unsqueeze(-1)      # float32 products
    acc = prod[..., 0, :]
    for j in range(1, gates.shape[-1]):
        acc = acc + prod[..., j, :]
    if ep is not None:
        acc = ep.sum(acc)
    return acc.to(dtype)


def _local_experts(p: dict, ep):
    """``(first, count)`` of the experts whose weights ``p`` holds: this
    rank's block where ``ep`` (a ``dist.megatron.ServingTP``) splits them
    over the model axis, else all (None)."""
    E = p["router"]["w"].shape[-1]
    n = p["gate"].shape[0]
    if ep is None or n == E:
        return None
    return ep.m * n, n


def _experts(p: dict, xin: torch.Tensor, act=F.silu,
             rows_invariant: bool = False) -> torch.Tensor:
    """SwiGLU of every expert over its own rows: ``xin`` (E, R, d) ->
    (E, R, d); batched matmuls over the weights as they lie.  ``act`` is
    the gate's activation; ``rows_invariant``: the rows-invariant
    kernel's ``rows_bmm`` (a row's bits then do not depend on R)."""
    dt = xin.dtype
    bmm = rows_bmm if rows_invariant else torch.bmm
    h = act(bmm(xin, p["gate"].to(dt)))
    h = h * bmm(xin, p["up"].to(dt))
    return bmm(h, p["down"].to(dt))


def moe_layer(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, n_groups: int = 1,
              trace: Optional[dict] = None, act=F.silu, ep=None,
              rows_invariant: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux).

    ``aux`` holds the float32 scalars ``lb_loss`` (Switch load balance),
    ``z_loss`` (router z-loss) and ``fraction_dropped``.  ``n_groups``:
    token groups for local dispatch (the JAX package sets it to the data
    shard count of a dry run's mesh).  ``trace``, when given, receives the
    routing's integer results (``expert_idx``, ``pos``, ``keep``, ``table``)
    for tests: with one group of shapes (T, k) and (E, C), else with the
    group dim in front, (g, Tg, k) and (g, E, C), as the JAX function
    holds them.

    ``ep`` (a ``dist.megatron.ServingTP``, ``p`` the rank's blocks, the
    experts split over the model axis) runs the layer expert-parallel:
    every rank routes all the tokens and sizes the queues as the whole
    layer does (so the same tokens drop), computes its experts' rows only,
    and the combine sums the ranks' parts.

    ``rows_invariant`` (``FwdOptions``'s): the router and the experts
    run through the rows-invariant kernel, so a token's logits and expert
    outputs do not depend on how many tokens the call holds (which tokens
    the capacity drops still does, as in the JAX package)."""
    B, S, D = x.shape
    E = p["router"]["w"].shape[-1]
    local = _local_experts(p, ep)
    T = B * S
    if T % n_groups:
        n_groups = 1
    G, Tg = n_groups, T // n_groups
    C = _capacity(Tg, E, top_k, capacity_factor)
    xt = x.reshape(T, D)
    dev = x.device

    router = p["router"]["w"].float()
    logits = (rows_gemm(xt.float(), router) if rows_invariant
              else xt.float() @ router)                          # (T, E)
    probs, gate_vals, expert_idx = route(logits, top_k)

    # position of each (token, k) in its group's expert queue: how many
    # entries before it, in the token-major, then k, order, chose the same
    # expert in the same group (the JAX package's cumsum of one-hot
    # selections, here as a stable sort of the entries by (group, expert))
    flat_e = expert_idx.reshape(-1)
    group = torch.arange(T * top_k, device=dev) // (Tg * top_k)
    key = flat_e + group * E                                     # (T*k,)
    counts = torch.zeros(G * E, dtype=key.dtype, device=dev).scatter_add_(
        0, key, torch.ones_like(key))               # no host sync (G*E,)
    order = torch.sort(key, stable=True).indices
    start = torch.cumsum(counts, dim=0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(T * top_k, device=dev) - start[key[order]]
    pos = pos.reshape(T, top_k)
    keep = pos < C
    gate_vals = gate_vals * keep

    # dispatch: group-local token ids + 1 into each group's (E, C) table;
    # drops spill to col C
    pos_c = torch.where(keep, pos, C)
    tok_ids = torch.arange(T, dtype=torch.int32, device=dev) % Tg
    table = torch.zeros((G * E, C + 1), dtype=torch.int32, device=dev)
    table.index_put_((key, pos_c.reshape(-1)),
                     (tok_ids[:, None].expand(T, top_k) + 1).reshape(-1))
    table = table[:, :C]                                         # (G*E, C)
    occupied = table > 0

    first = (torch.arange(G * E, device=dev) // E * Tg)[:, None]
    e0, ne = (0, E) if local is None else local
    rows = (table - 1).clamp(min=0) + first
    if local is not None:          # this rank's experts' queues only
        rows = rows.view(G, E, C)[:, e0:e0 + ne].reshape(G * ne, C)
        occupied = occupied.view(G, E, C)[:, e0:e0 + ne].reshape(G * ne, C)
    xin = xt[rows.long()]                                      # (G*ne,C,D)
    xin = torch.where(occupied[..., None], xin,
                      torch.zeros((), dtype=x.dtype, device=dev))
    # every expert over its rows of all groups, then back to (ne, G, C, D)
    xin = xin.reshape(G, ne, C, D).transpose(0, 1).reshape(ne, G * C, D)
    out_e = _experts(p, xin, act, rows_invariant).reshape(ne, G, C, D)

    # combine: each token's k expert outputs back, weighted by its gates
    # (on an expert-parallel rank, the other ranks' experts weigh zero)
    tok_group = (torch.arange(T, device=dev) // Tg)[:, None]
    gates = gate_vals
    if local is not None:
        mine = (expert_idx >= e0) & (expert_idx < e0 + ne)
        gates = gates * mine
        expert_idx_l = (expert_idx - e0).clamp(0, ne - 1)
    else:
        expert_idx_l = expert_idx
    out_tok = out_e[expert_idx_l, tok_group, pos_c.clamp(max=C - 1)]
    out = _combine(out_tok, gates.to(x.dtype), x.dtype,
                   None if local is None else ep)

    me = probs.mean(dim=0)                                       # (E,)
    # each token picks an expert at most once
    ce = counts.reshape(G, E).sum(dim=0).float() / T
    aux = {"lb_loss": E * torch.sum(me * ce),
           "z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
           "fraction_dropped": 1.0 - keep.float().mean()}
    if trace is not None:
        lead = (G, Tg) if G > 1 else (T,)
        trace.update(expert_idx=expert_idx.reshape(*lead, top_k),
                     pos=pos.reshape(*lead, top_k),
                     keep=keep.reshape(*lead, top_k),
                     table=table.reshape(G, E, C) if G > 1 else table)
    return out.reshape(B, S, D), aux


def moe_decode(p: dict, x: torch.Tensor, *, top_k: int,
               logits: Optional[torch.Tensor] = None,
               act=F.silu, ep=None) -> torch.Tensor:
    """Decode-time MoE for a few rows: x (M, d) -> (M, d) in x's dtype.
    Every expert computes all M rows (no capacity); the gates select.

    ``logits`` (M, E) are the float32 router logits ``x.float() @
    router.w``, computed here unless the caller took them at another
    shape (the verify step takes them one window position at a time).
    ``ep`` (a ``dist.megatron.ServingTP``, ``p`` the rank's blocks) runs
    it expert-parallel: the rank's experts over every row, the others'
    gates zero, one sum over the model group."""
    M, D = x.shape
    if logits is None:
        logits = x.float() @ p["router"]["w"].float()
    _, gate_vals, expert_idx = route(logits, top_k)
    local = _local_experts(p, ep)
    ne = p["gate"].shape[0]
    out_e = _experts(p, x.expand(ne, M, D), act)                # (ne,M,D)
    rows = torch.arange(M, device=x.device)[:, None]
    if local is None:
        return _combine(out_e[expert_idx, rows], gate_vals.to(x.dtype),
                        x.dtype)
    e0 = local[0]
    mine = (expert_idx >= e0) & (expert_idx < e0 + ne)
    return _combine(out_e[(expert_idx - e0).clamp(0, ne - 1), rows],
                    (gate_vals * mine).to(x.dtype), x.dtype, ep)
