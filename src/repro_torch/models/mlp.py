"""Feed-forward mixers: SwiGLU and capacity-based MoE (GShard-style dropped
routing with sort-based dispatch — the production dropped-token regime).

MoE dispatch avoids the (tokens, E, capacity) one-hot einsum: slots are
sorted by expert id, each slot's position within its expert computed from
the sorted order, slots beyond capacity dropped, and tokens scattered into
an (E, capacity, d) buffer.  Expert FFNs run as batched matmuls.

Routing follows the reference to the index: top-k is a stable descending
sort (the lower expert wins a tie, as ``jax.lax.top_k`` picks), the sort by
expert is stable, and a token's k slots are summed in slot order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.sharding import rules as shrules

MOE_AUX_ALPHA = 0.01


class SwiGLU(common.Params):
    def __init__(self, cfg, generator, device, d_ff=None, name_axes="ffn"):
        super().__init__()
        d = cfg.d_model
        ff = d_ff if d_ff is not None else cfg.d_ff
        dt = common.dtype_of(cfg)
        self.param("wg", common.dense_init(generator, (d, ff), dt, device=device),
                   ("embed", name_axes))
        self.param("wu", common.dense_init(generator, (d, ff), dt, device=device),
                   ("embed", name_axes))
        self.param("wd", common.dense_init(generator, (ff, d), dt, in_axis_size=ff,
                                           device=device), (name_axes, "embed"))


def init_swiglu(generator, cfg, d_ff=None, name_axes="ffn", device=None):
    m = SwiGLU(cfg, generator, common.resolve_device(device), d_ff, name_axes)
    return m, m.param_axes()


def swiglu(params, x):
    g = F.silu(x @ params.wg)
    u = x @ params.wu
    return (g * u) @ params.wd


class MoE(common.Params):
    def __init__(self, cfg, generator, device):
        super().__init__()
        e = cfg.moe
        d, ff = cfg.d_model, cfg.d_ff
        dt = common.dtype_of(cfg)
        init = common.dense_init
        self.param("router", init(generator, (d, e.num_experts), torch.float32, device=device),
                   ("embed", "experts"))
        # wg / wu take the reference's fan-in, shape[0] (the expert count)
        self.param("wg", init(generator, (e.num_experts, d, ff), dt, device=device),
                   ("experts", "embed", "expert_ffn"))
        self.param("wu", init(generator, (e.num_experts, d, ff), dt, device=device),
                   ("experts", "embed", "expert_ffn"))
        self.param("wd", init(generator, (e.num_experts, ff, d), dt, in_axis_size=ff,
                              device=device), ("experts", "expert_ffn", "embed"))
        if e.num_shared:
            self.shared = SwiGLU(cfg, generator, device, d_ff=ff * e.num_shared)


def init_moe(generator, cfg, device=None):
    m = MoE(cfg, generator, common.resolve_device(device))
    return m, m.param_axes()


def moe_capacity(n_tokens: int, cfg) -> int:
    e = cfg.moe
    cap = int(n_tokens * e.top_k * e.capacity_factor / e.num_experts)
    return max(8, -(-cap // 8) * 8)


# Dispatch strategy.  "local": tokens are routed per data shard
# (``shrules.data_shard_count()`` shards, one in the port), so the dispatch
# never crosses the data axis.  "global": one dispatch buffer for all.
DISPATCH = "local"


def _dispatch_one(xf, params, cfg, cap):
    """Sort-based dropped dispatch for one token shard. xf: (n, d)."""
    e = cfg.moe
    n, d = xf.shape
    k = e.top_k
    dev = xf.device

    logits = xf.float() @ params.router
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]  # (n, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # load-balancing aux loss (Switch/GShard form); the one-hot as a
    # compare, which every device runs as the same ops (F.one_hot checks
    # its range on the host off meta), so a meta trace counts the card's
    me = torch.mean(probs, dim=0)
    one_hot = expert_idx[..., None] == torch.arange(e.num_experts, device=dev)
    ce = torch.mean(torch.sum(one_hot.float(), dim=1), dim=0) / k
    aux = MOE_AUX_ALPHA * e.num_experts * torch.sum(me * ce)

    # sort-based position-in-expert
    slot_expert = expert_idx.reshape(-1)                       # (n*k,)
    slot_token = torch.arange(n * k, device=dev) // k
    order = torch.argsort(slot_expert, stable=True)
    sorted_e = slot_expert[order]
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.empty_like(slot_expert)
    pos[order] = torch.arange(n * k, device=dev) - seg_start

    keep = pos < cap
    pos_c = torch.where(keep, pos, cap)  # row cap is dropped below

    buf = torch.zeros((e.num_experts, cap + 1, d), dtype=xf.dtype, device=dev)
    buf.index_put_((slot_expert, pos_c), torch.where(keep[:, None], xf[slot_token], 0))
    meta = (slot_expert, pos_c, keep, slot_token, gate_vals)
    return buf[:, :cap], meta, aux


def _combine_one(y, meta, n, d, dtype):
    slot_expert, pos_c, keep, slot_token, gate_vals = meta
    cap = y.shape[1]
    gathered = y[slot_expert, torch.clamp(pos_c, 0, cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    weighted = (gathered * gate_vals.reshape(-1)[:, None].to(dtype)).reshape(n, -1, d)
    out = weighted[:, 0]  # slot_token = arange(n*k) // k: a token's k slots are adjacent
    for j in range(1, weighted.shape[1]):
        out = out + weighted[:, j]
    return out


def moe_apply(params, cfg, x):
    """x: (B, T, d) -> (out, aux_loss).  Dropped routing at static capacity."""
    e = cfg.moe
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)

    shards = shrules.data_shard_count() if DISPATCH == "local" else 1
    if n % shards:
        shards = 1
    n_loc = n // shards
    cap = moe_capacity(n_loc, cfg)

    outs = [_dispatch_one(xi, params, cfg, cap) for xi in xf.reshape(shards, n_loc, d)]
    bufs = torch.stack([o[0] for o in outs])                   # (D, E, cap, d)

    g = F.silu(bufs @ params.wg)                               # (D, E, cap, ff)
    u = bufs @ params.wu
    y = (g * u) @ params.wd                                    # (D, E, cap, d)

    out = torch.cat([
        _combine_one(y[i], o[1], n_loc, d, x.dtype) for i, o in enumerate(outs)
    ])
    if e.num_shared:
        out = out + swiglu(params.shared, xf)
    aux = torch.mean(torch.stack([o[2] for o in outs]))
    return out.reshape(b, t, d), aux
