"""Attention mixers: GQA (with optional sliding window + qk-norm) and
DeepSeek-V2 MLA (expanded for training, absorbed for decode).

Long-sequence forward passes block over queries (``Q_BLOCK``) so the
(B, H, T, T) score tensor never materializes — peak attention memory is
(B, H, q_block, T) per layer.

Where the reference asks a bf16 einsum for f32 output
(``preferred_element_type``), the port upcasts both operands to f32; a
product of two bf16 values is exact in f32.  Decode writes the new token
into the cache tensors in place and returns the same dict.
"""

from __future__ import annotations

import torch

from repro_torch.models import common

NEG_INF = -1e30
Q_BLOCK = 512  # block queries above this sequence length (fp32-score budget)


def _einsum_f32(eq, *ops):
    return torch.einsum(eq, *(o.float() for o in ops))


# --------------------------------------------------------------------- GQA


class Attention(common.Params):
    def __init__(self, cfg, generator, device):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.padded_heads, cfg.padded_kv_heads, cfg.hd
        dt = common.dtype_of(cfg)
        init = common.dense_init
        self.param("wq", init(generator, (d, h, dh), dt, in_axis_size=d, device=device),
                   ("embed", "heads", "head_dim"))
        self.param("wk", init(generator, (d, kv, dh), dt, in_axis_size=d, device=device),
                   ("embed", "kv_heads", "head_dim"))
        self.param("wv", init(generator, (d, kv, dh), dt, in_axis_size=d, device=device),
                   ("embed", "kv_heads", "head_dim"))
        self.param("wo", init(generator, (h, dh, d), dt, in_axis_size=h * dh, device=device),
                   ("heads", "head_dim", "embed"))


def init_attention(generator, cfg, device=None):
    m = Attention(cfg, generator, common.resolve_device(device))
    return m, m.param_axes()


def _mask(q_pos, k_pos, is_global, window):
    """Causal (+ optional sliding-window) mask."""
    causal = q_pos[:, None] >= k_pos[None, :]
    if window and not is_global:
        return causal & ((q_pos[:, None] - k_pos[None, :]) < window)
    return causal


def _attend(q, k, v, q_pos, k_pos, is_global, window):
    """q: (B,Tq,H,dh)  k,v: (B,Tk,KV,dh)  ->  (B,Tq,H,dh)."""
    b, tq, h, dh = q.shape
    kvh = k.shape[2]
    group = h // kvh
    scale = dh ** -0.5
    qg = q.reshape(b, tq, kvh, group, dh)
    scores = _einsum_f32("btkgd,bskd->bkgts", qg, k) * scale
    keep = _mask(q_pos, k_pos, is_global, window)
    scores = torch.where(keep[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, tq, h, dh)


def _proj(x, w):
    """(B, T, d) x (d, H, dh) -> (B, T, H, dh)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _out(o, w):
    """(B, T, H, dh) x (H, dh, d) -> (B, T, d)."""
    return o.reshape(*o.shape[:2], -1) @ w.reshape(-1, w.shape[-1])


def attention_forward(params, cfg, x, positions, is_global=True):
    """Training/prefill attention.  Returns (out, (k, v)) — kv for caching."""
    b, t, _ = x.shape
    q = _proj(x, params.wq)
    k = _proj(x, params.wk)
    v = _proj(x, params.wv)
    if cfg.qk_norm:
        q = common.qk_head_norm(q, cfg.norm_eps)
        k = common.qk_head_norm(k, cfg.norm_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)

    if t <= Q_BLOCK:
        out = _attend(q, k, v, positions, positions, is_global, cfg.sliding_window)
    else:
        qb = q.reshape(b, t // Q_BLOCK, Q_BLOCK, *q.shape[2:])
        pb = positions.reshape(t // Q_BLOCK, Q_BLOCK)
        out = torch.cat([
            _attend(qb[:, i], k, v, pb[i], positions, is_global, cfg.sliding_window)
            for i in range(pb.shape[0])
        ], dim=1)
    return _out(out, params.wo), (k, v)


def init_kv_cache(cfg, batch, cache_len, dtype, device=None):
    kv = cfg.padded_kv_heads
    dev = common.resolve_device(device)
    cache = {"slot_pos": torch.full((cache_len,), -1, dtype=torch.int32, device=dev)}
    shape = (batch, cache_len, kv, cfg.hd)
    if cfg.kv_quant:
        # int8 cache + per (token, head) scales: ~2x less memory read per
        # decode step
        cache["k"] = torch.zeros(shape, dtype=torch.int8, device=dev)
        cache["v"] = torch.zeros(shape, dtype=torch.int8, device=dev)
        cache["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=dev)
        cache["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=dev)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def _quantize_kv(x):
    """(B, T, KV, dh) -> (int8 codes, (B, T, KV) scales); rounds half to
    even, as the reference does."""
    scale = torch.amax(torch.abs(x.float()), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    codes = torch.clamp(torch.round(x.float() / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def _dequantize_kv(codes, scale, dtype):
    return (codes.float() * scale[..., None]).to(dtype)


def _decode_qkv(params, cfg, x, pos):
    """Shared decode-side projections: q/k/v with qk-norm + rope applied.

    k comes back post-rope — both the dense and the paged cache store it
    that way, so a restored block never needs re-roping.
    """
    b = x.shape[0]
    q = _proj(x, params.wq)
    k = _proj(x, params.wk)
    v = _proj(x, params.wv)
    if cfg.qk_norm:
        q = common.qk_head_norm(q, cfg.norm_eps)
        k = common.qk_head_norm(k, cfg.norm_eps)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = common.apply_rope(q, posv, cfg.rope_theta)
    k = common.apply_rope(k, posv, cfg.rope_theta)
    return q, k, v


def _decode_attend(q, ck, cv, keep, out_dtype):
    """GQA single-token attention over a gathered cache view.

    q: (B,1,H,dh); ck/cv: (B,S,KV,dh); keep broadcasts against the
    (B,KV,G,S) score tensor.  Masked slots hit NEG_INF before the softmax,
    so their probability underflows to exactly 0.0 — whatever bytes sit in
    an unmapped cache slot contribute exactly nothing to the output.
    """
    b, _, h, dh = q.shape
    kvh = ck.shape[2]
    group = h // kvh
    qg = q.reshape(b, kvh, group, dh)
    scores = _einsum_f32("bkgd,bskd->bkgs", qg, ck) * (dh ** -0.5)
    scores = torch.where(keep, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(out_dtype)
    return torch.einsum("bkgs,bskd->bkgd", probs, cv).reshape(b, 1, h, dh)


def attention_decode(params, cfg, cache, x, pos, is_global=True):
    """Single-token decode with (ring-buffered, for SWA) KV cache.

    x: (B, 1, d); pos: int (current absolute position).  Writes the token
    into ``cache`` in place and returns (y, cache).
    """
    cache_len = cache["k"].shape[1]
    q, k, v = _decode_qkv(params, cfg, x, pos)  # k stored post-rope

    slot = pos % cache_len  # ring buffer (identity when cache covers all pos)
    if cfg.kv_quant:
        for name, new in (("k", k), ("v", v)):
            codes, scale = _quantize_kv(new)
            cache[name][:, slot] = codes[:, 0]
            cache[name + "_scale"][:, slot] = scale[:, 0]
        ck =_dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        cv = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        ck, cv = cache["k"], cache["v"]
    spos = cache["slot_pos"]
    spos[slot] = pos

    valid = (spos >= 0) & (spos <= pos)
    if cfg.sliding_window and not is_global:
        valid = valid & ((pos - spos) < cfg.sliding_window)
    out = _decode_attend(q, ck, cv, valid[None, None, None], x.dtype)
    return _out(out, params.wo), cache


# --------------------------------------------------------------- paged GQA


def init_paged_kv_pool(cfg, pool_blocks, block_tokens, dtype, device=None):
    """Physical KV block pool shared by every layer and sequence.

    Slots are (block_tokens, KV, dh) tiles addressed by per-(layer, seq)
    block tables; a slot's contents are garbage until a table maps it.
    """
    if cfg.kv_quant:
        raise NotImplementedError(
            "paged KV does not support kv_quant (int8 cache); "
            "use the dense cache or disable kv_quant"
        )
    dev = common.resolve_device(device)
    shape = (pool_blocks, block_tokens, cfg.padded_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


def paged_attention_decode(params, cfg, pool, table, x, pos, is_global=True):
    """Single-token decode reading K/V through a block table.

    pool: {"k","v"} of (P, block_tokens, KV, dh); table: (B, n_logical)
    int32 physical slot ids, -1 = unmapped.  The block holding ``pos`` must
    be mapped (the host allocator guarantees it).  Writes the new token into
    its slot (in place), then attends over the gathered logical view;
    unmapped or future slots mask to exactly zero probability, so stale pool
    contents never reach the output.
    """
    b = x.shape[0]
    bt = pool["k"].shape[1]
    n_logical = table.shape[1]
    kvh, dh = pool["k"].shape[2], pool["k"].shape[3]
    q, k, v = _decode_qkv(params, cfg, x, pos)  # k stored post-rope

    phys = table[:, pos // bt].long()
    at = torch.full_like(phys, pos % bt)
    pool["k"].index_put_((phys, at), k[:, 0])
    pool["v"].index_put_((phys, at), v[:, 0])

    safe = torch.clamp(table, min=0).long()  # gather through slot 0 for unmapped rows
    ck = pool["k"][safe].reshape(b, n_logical * bt, kvh, dh)
    cv = pool["v"][safe].reshape(b, n_logical * bt, kvh, dh)
    t_idx = torch.arange(n_logical * bt, device=x.device)  # logical slot == position
    valid = torch.repeat_interleave(table >= 0, bt, dim=1) & (t_idx <= pos)[None]
    if cfg.sliding_window and not is_global:
        valid = valid & ((pos - t_idx) < cfg.sliding_window)[None]
    out = _decode_attend(q, ck, cv, valid[:, None, None, :], x.dtype)
    return _out(out, params.wo), pool


# --------------------------------------------------------------------- MLA


class MLA(common.Params):
    def __init__(self, cfg, generator, device):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.padded_heads
        dt = common.dtype_of(cfg)
        init = common.dense_init
        qk_dim = m.qk_nope_dim + m.qk_rope_dim
        self.param("wdq", init(generator, (d, m.q_lora_rank), dt, device=device),
                   ("embed", "lora"))
        self.param("wuq", init(generator, (m.q_lora_rank, h, qk_dim), dt,
                               in_axis_size=m.q_lora_rank, device=device),
                   ("lora", "heads", "head_dim"))
        self.param("wdkv", init(generator, (d, m.kv_lora_rank), dt, device=device),
                   ("embed", "lora"))
        self.param("wkr", init(generator, (d, m.qk_rope_dim), dt, device=device),
                   ("embed", "head_dim"))
        self.param("wukv", init(generator, (m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim), dt,
                                in_axis_size=m.kv_lora_rank, device=device),
                   ("lora", "heads", "head_dim"))
        self.param("wo", init(generator, (h, m.v_head_dim, d), dt,
                              in_axis_size=h * m.v_head_dim, device=device),
                   ("heads", "head_dim", "embed"))


def init_mla(generator, cfg, device=None):
    m = MLA(cfg, generator, common.resolve_device(device))
    return m, m.param_axes()


def mla_forward(params, cfg, x, positions, is_global=True):
    """Training/prefill MLA (expanded form). Returns (out, (c_kv, k_rope))."""
    m = cfg.mla
    b, t, _ = x.shape
    cq = x @ params.wdq
    q = _proj(cq, params.wuq)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = common.apply_rope(q_rope, positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)

    c_kv = x @ params.wdkv
    k_rope = (x @ params.wkr)[:, :, None, :]
    k_rope = common.apply_rope(k_rope, positions, cfg.rope_theta)
    kv = _proj(c_kv, params.wukv)
    k_nope, v = torch.split(kv, [m.qk_nope_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], m.qk_rope_dim)], dim=-1)

    if t <= Q_BLOCK:
        out = _attend_mha(q, k, v, positions, positions)
    else:
        qb = q.reshape(b, t // Q_BLOCK, Q_BLOCK, *q.shape[2:])
        pb = positions.reshape(t // Q_BLOCK, Q_BLOCK)
        out = torch.cat([
            _attend_mha(qb[:, i], k, v, pb[i], positions) for i in range(pb.shape[0])
        ], dim=1)
    return _out(out, params.wo), (c_kv, k_rope[:, :, 0, :])


def _attend_mha(q, k, v, q_pos, k_pos):
    dh = q.shape[-1]
    scores = _einsum_f32("bthd,bshd->bhts", q, k) * (dh ** -0.5)
    keep = q_pos[:, None] >= k_pos[None, :]
    scores = torch.where(keep[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def init_mla_cache(cfg, batch, cache_len, dtype, device=None):
    m = cfg.mla
    dev = common.resolve_device(device)
    return {
        "c_kv": torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype, device=dev),
        "k_rope": torch.zeros((batch, cache_len, m.qk_rope_dim), dtype=dtype, device=dev),
    }


def mla_decode(params, cfg, cache, x, pos, is_global=True):
    """Absorbed single-token MLA decode: attention in the latent space.

    The up-projections fold into the query/output (DeepSeek-V2 §2.1.2), so the
    cache stays (kv_lora + rope_dim) per token.  Writes in place.
    """
    m = cfg.mla
    b = x.shape[0]
    cq = x @ params.wdq
    q = _proj(cq, params.wuq)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_rope = common.apply_rope(q_rope, posv, cfg.rope_theta)

    c_kv_new = x @ params.wdkv
    k_rope_new = (x @ params.wkr)[:, :, None, :]
    k_rope_new = common.apply_rope(k_rope_new, posv, cfg.rope_theta)[:, :, 0, :]

    cache["c_kv"][:, pos] = c_kv_new[:, 0]
    cache["k_rope"][:, pos] = k_rope_new[:, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    wuk = params.wukv[..., : m.qk_nope_dim]      # (r, h, nope)
    wuv = params.wukv[..., m.qk_nope_dim:]       # (r, h, v)
    q_abs = torch.einsum("bthk,rhk->bthr", q_nope, wuk)  # latent-space query
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    scores = (
        _einsum_f32("bthr,bsr->bhts", q_abs, c_kv)
        + _einsum_f32("bthk,bsk->bhts", q_rope, k_rope)
    ) * scale
    t_idx = torch.arange(c_kv.shape[1], device=x.device)
    scores = torch.where((t_idx <= pos)[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhts,bsr->bthr", probs, c_kv)
    out = torch.einsum("bthr,rhk->bthk", ctx, wuv)
    return _out(out, params.wo), cache
