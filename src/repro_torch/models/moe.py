"""Mixture-of-Experts FFN: top-k routing with capacity, scatter dispatch,
optional shared experts (ports ``repro/models/moe.py``).

The router stays f32 and is a ``generic`` leaf, so constant-parameter
compilation skips it (routing stability); the expert weights are stacked
``(E, d, d_ff)`` linear leaves under the axis ``experts_stack``, which
``compile_params`` packs expert by expert.

Routing (``route``) is a function of its own: the softmax, the top-K
picks (``pick_experts``, ties to the lower index as ``jax.lax.top_k``
breaks them), the normalised gates, the capacity and each pick's slot in
its expert's queue.  Dispatch writes the kept picks into an
``(E, cap + 1, d)`` buffer whose last row takes the dropped ones (JAX's
``mode="drop"``, with no host sync).  The experts run one after another,
each on its ``(cap, d)`` rows, empty rows too, as JAX's ``vmap`` runs
them: the compiled modes' activation scale is per expert.  The combine
adds each token's K weighted outputs in choice order in bf16, the order
of XLA's scatter-add on the CPU.  The expert buffers carry JAX's
``shard`` constraints (experts over the mesh's ``model`` axis), no-ops
without an active mesh (distributed/sharding.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.distributed.sharding import shard
from repro_torch.models.layers import ffn, ffn_init


class Routing(NamedTuple):
    logits: torch.Tensor       # (N, E) f32 router logits
    probs: torch.Tensor        # (N, E) softmax
    gate_vals: torch.Tensor    # (N, K) normalised gates
    expert_idx: torch.Tensor   # (N, K) int64 picks, best first
    cap: int                   # rows per expert queue
    slot: torch.Tensor         # (N*K,) position in the expert's queue
    keep: torch.Tensor         # (N*K,) bool, slot < cap


def moe_init(gen, cfg):
    m = cfg.moe
    p = {"router": nn.param(gen, (cfg.d_model, m.n_experts),
                            ("embed", "experts"), scale=0.02)}
    experts = nn.vmap_init(
        lambda g: ffn_init(g, cfg.d_model, m.d_ff_expert, gated=m.gated,
                           suffix=("ffn_in", "ffn_out")), gen, m.n_experts)
    # the stacked leading axis is the expert dim, not 'layers'
    p["experts"] = nn.tree_map(
        lambda q: nn.Param(q.value, ("experts_stack",) + q.axes[1:], q.kind),
        experts, is_leaf=lambda x: isinstance(x, nn.Param))
    if m.n_shared > 0:
        p["shared"] = ffn_init(gen, cfg.d_model, m.d_ff_expert * m.n_shared,
                               gated=m.gated)
    return p


def capacity(n_tok: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Rows per expert queue, with JAX's Python arithmetic: the mean load
    times the factor (at least 8), at most the token count, rounded up to
    a multiple of 8."""
    cap = int(max(8, -(-n_tok * top_k // n_experts) * capacity_factor))
    cap = min(cap, n_tok)
    return ((cap + 7) // 8) * 8


def pick_experts(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """(N, K) indices of each row's K largest probabilities, best first,
    equal ones in index order (``jax.lax.top_k``; ``torch.topk`` promises
    no order for ties)."""
    return torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[:, :top_k]


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int,
          capacity_factor: float) -> Routing:
    """Route the (N, d) tokens ``xt``: f32 logits, softmax, top-K picks,
    gates normalised by max(sum, 1e-9), and each (token, choice) pick's
    slot in its expert's queue in (token, choice)-major order."""
    n_tok, E = xt.shape[0], router.shape[-1]
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    expert_idx = pick_experts(probs, top_k)
    gate_vals = torch.gather(probs, 1, expert_idx)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    cap = capacity(n_tok, top_k, E, capacity_factor)
    flat_e = expert_idx.reshape(-1)
    pos = torch.cumsum(F.one_hot(flat_e, E).to(torch.int32), dim=0) - 1
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    return Routing(logits, probs, gate_vals, expert_idx, cap, slot,
                   slot < cap)


def moe_forward(p, x, cfg, qat=False, capacity_factor=1.25):
    """x: (B, T, d) -> (B, T, d); also returns the aux losses dict."""
    m = cfg.moe
    B, T, d = x.shape
    E, K = m.n_experts, m.top_k
    xt = x.reshape(B * T, d)
    n_tok = B * T
    r = route(xt, p["router"], K, capacity_factor)
    cap = r.cap

    # dispatch: the kept picks into (E, cap, d); dropped ones land in row
    # cap, which is cut off
    flat_e = r.expert_idx.reshape(-1)
    tok_id = torch.arange(n_tok, device=x.device).repeat_interleave(K)
    x_e = torch.zeros((E, cap + 1, d), dtype=x.dtype, device=x.device)
    x_e[flat_e, torch.where(r.keep, r.slot, cap)] = xt[tok_id]
    x_e = shard(x_e[:, :cap], "experts_stack", None, None)
    experts = nn.unstack(p["experts"], E)
    y_e = torch.stack([ffn(experts[e], x_e[e], act=m.act, qat=qat)
                       for e in range(E)])                  # (E, cap, d)
    y_e = shard(y_e, "experts_stack", None, None)

    # combine: each kept pick's output times its gate (in bf16), the K
    # terms of a token added one by one in choice order
    gathered = y_e[flat_e, torch.where(r.keep, r.slot, 0)]  # (N*K, d)
    gathered = gathered.masked_fill(~r.keep[:, None], 0)
    w = r.gate_vals.reshape(-1)[:, None].to(gathered.dtype)
    terms = (gathered * w).reshape(n_tok, K, d)
    out = torch.zeros_like(xt)
    for k in range(K):
        out = out + terms[:, k]

    if "shared" in p:
        out = out + ffn(p["shared"], xt, act=m.act, qat=qat)

    # aux: load-balance loss (Switch) + router z-loss
    me = torch.mean(r.probs, dim=0)
    ce = torch.mean(F.one_hot(r.expert_idx[:, 0], E).float(), dim=0)
    aux = {
        "lb_loss": E * torch.sum(me * ce),
        "z_loss": torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2),
        "dropped_frac": 1.0 - torch.mean(r.keep.float()),
    }
    return out.reshape(B, T, d), aux

