"""Explicit MoE dispatch/combine over all_to_all (ports
``repro/distributed/moe_a2a.py``).

Every rank bins its local tokens by target expert *shard*, exchanges the
bins across the expert-parallel process group
(``torch.distributed.all_to_all_single`` on ``mesh[ep_axis]``), runs its
local experts, and sends the results back.  JAX runs the same arithmetic
inside ``shard_map``; here each rank passes its own rows, which replace
``shard_map``'s per-device view, so the data axis stays outside: each
data row of the mesh performs its own independent exchange.

Capacity is per (source rank x target shard), so buffer shapes are
static: ``max(8, round(T_loc * K / E * capacity_factor * E_loc))``
rounded up to 8.  A pick past its bin's capacity is dropped (its term is
left out of the combine).  The received slots keep JAX's
correctness-first dense ``(E_loc, ep * cap, d)`` layout: each local
expert sees every received slot, masked to its own.

Exactness: equal to the scatter-based ``models.moe`` dispatch for picks
within capacity; the combine adds a token's K terms in choice order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh


def capacity(n_tok: int, top_k: int, n_experts: int, n_local: int,
             capacity_factor: float) -> int:
    """Slots per (source rank, target shard) bin."""
    cap = int(max(8, round(n_tok * top_k / n_experts * capacity_factor
                           * n_local)))
    return ((cap + 7) // 8) * 8


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def a2a_expert_exchange(x, expert_idx, gates, experts_apply, n_experts: int,
                        mesh: DeviceMesh, ep_axis: str = "model",
                        capacity_factor: float = 2.0):
    """MoE forward of this rank's tokens with explicit all_to_all dispatch.

    x: (T_loc, d) this rank's tokens; expert_idx: (T_loc, K) int picks;
    gates: (T_loc, K) f32; experts_apply(x_e) -> y_e applies this rank's
    LOCAL expert stack (experts ``r * E_loc ... (r + 1) * E_loc - 1`` for
    the rank's coordinate ``r`` on ``ep_axis``) to (E_loc, ep * cap, d).

    Returns the (T_loc, d) combined output in x's dtype.
    """
    group = mesh.get_group(ep_axis)
    ep = mesh[ep_axis].size()
    E_loc = n_experts // ep
    tl, d = x.shape
    K = expert_idx.shape[1]
    cap = capacity(tl, K, n_experts, E_loc, capacity_factor)
    dev = x.device

    flat_shard = (expert_idx.long() // E_loc).reshape(-1)
    flat_within = (expert_idx % E_loc).reshape(-1).to(torch.int32)
    tok = torch.arange(tl, device=dev).repeat_interleave(K)
    # slot of each (token, choice) within its target shard's bin
    pos = torch.cumsum(F.one_hot(flat_shard, ep).to(torch.int32), dim=0) - 1
    slot = torch.gather(pos, 1, flat_shard[:, None])[:, 0]
    keep = slot < cap
    slot_c = torch.where(keep, slot, cap).long()
    # send buffers: tokens + expert-within sideband (-1: empty slot); the
    # dropped picks land in slot cap, which is cut off
    send_x = torch.zeros((ep, cap + 1, d), dtype=x.dtype, device=dev)
    send_x[flat_shard, slot_c] = x[tok]
    send_m = torch.full((ep, cap + 1), -1, dtype=torch.int32, device=dev)
    send_m[flat_shard, slot_c] = flat_within
    recv_x = _exchange(send_x[:, :cap], group)       # for MY local experts
    recv_m = _exchange(send_m[:, :cap], group)
    flat_rx = recv_x.reshape(ep * cap, d)
    flat_rm = recv_m.reshape(ep * cap)
    # each local expert sees every received slot, masked to its own
    mine = flat_rm[None, :] == torch.arange(E_loc, device=dev)[:, None]
    x_e = torch.where(mine[:, :, None], flat_rx[None], 0)   # (E_loc, S, d)
    y_e = experts_apply(x_e)                                # (E_loc, S, d)
    rows = torch.arange(ep * cap, device=dev)
    y_flat = y_e[flat_rm.clamp_min(0).long(), rows]
    y_flat = torch.where((flat_rm >= 0)[:, None], y_flat, 0)
    # return to senders, then combine at the source: each kept choice's
    # result times its gate, a token's K terms added in choice order
    back = _exchange(y_flat.reshape(ep, cap, d), group)
    gathered = back[flat_shard, slot_c.clamp_max(cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    w = gates.reshape(-1)[:, None].to(gathered.dtype)
    terms = (gathered * w).reshape(tl, K, d)
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + terms[:, k]
    return out
