"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060).

Training uses the chunked SSD algorithm: within a chunk the recurrence is
expanded into an attention-like (Q x Q) masked matrix; across chunks a
Python loop carries the (H, N, P) state (the reference's ``lax.scan``).
Decode is the O(1) recurrent update.  Depthwise causal conv (width 4) on
(x, B, C) is kept, with its own ring state for decode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common


def _dims(cfg):
    s = cfg.ssm
    heads = cfg.padded_ssm_heads
    return s, heads, heads * s.head_dim


class SSM(common.Params):
    def __init__(self, cfg, generator, device):
        super().__init__()
        s, h, di = _dims(cfg)
        d, n, w = cfg.d_model, s.d_state, s.conv_width
        dt = common.dtype_of(cfg)
        f32 = torch.float32
        init = common.dense_init
        self.param("wx", init(generator, (d, di), dt, device=device), ("embed", "ssm_inner"))
        self.param("wz", init(generator, (d, di), dt, device=device), ("embed", "ssm_inner"))
        self.param("wB", init(generator, (d, n), dt, device=device), ("embed", "state"))
        self.param("wC", init(generator, (d, n), dt, device=device), ("embed", "state"))
        self.param("wdt", init(generator, (d, h), dt, device=device), ("embed", "ssm_heads"))
        self.param("dt_bias", torch.zeros((h,), dtype=f32, device=device), ("ssm_heads",))
        self.param("A_log", torch.zeros((h,), dtype=f32, device=device), ("ssm_heads",))
        self.param("D", torch.ones((h,), dtype=f32, device=device), ("ssm_heads",))
        self.param("conv_w", init(generator, (w, di + 2 * n), dt, in_axis_size=w, device=device),
                   ("conv", "ssm_inner_conv"))
        self.param("conv_b", torch.zeros((di + 2 * n,), dtype=dt, device=device),
                   ("ssm_inner_conv",))
        self.param("norm_scale", torch.ones((h, s.head_dim), dtype=dt, device=device),
                   ("ssm_heads", "head_dim"))
        self.param("wout", init(generator, (di, d), dt, in_axis_size=di, device=device),
                   ("ssm_inner", "embed"))


def init_ssm(generator, cfg, device=None):
    m = SSM(cfg, generator, common.resolve_device(device))
    return m, m.param_axes()


def _causal_conv(v, kernel, bias):
    """Depthwise causal conv: v (B,T,F), kernel (w,F) -> (B,T,F)."""
    w = kernel.shape[0]
    pad = F.pad(v, (0, 0, w - 1, 0))
    out = torch.zeros_like(v)
    t = v.shape[1]
    for i in range(w):
        out = out + kernel[i] * pad[:, i : i + t]
    return out + bias


def _gated_norm(y, z, scale, eps):
    """y,z: (..., H, P).  y * silu(z) -> per-head RMS norm with scale."""
    g = y * F.silu(z.float())
    var = torch.mean(torch.square(g), dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps)) * scale.float()


def ssm_forward(params, cfg, x, positions=None, is_global=True):
    """Chunked SSD training/prefill pass.  Returns (out, final_state)."""
    s, h, di = _dims(cfg)
    n, p, q = s.d_state, s.head_dim, s.chunk
    b, t_in, _ = x.shape
    pad = (-t_in) % q
    if pad:  # zero-pad to a whole chunk; padded outputs sliced off below
        x = F.pad(x, (0, 0, 0, pad))
    t = t_in + pad
    nk = t // q
    f32 = torch.float32

    u = x @ params.wx
    z = x @ params.wz
    bm = x @ params.wB
    cm = x @ params.wC
    conv_in = torch.cat([u, bm, cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params.conv_w, params.conv_b).float()).to(x.dtype)
    u, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)

    dt = F.softplus((x @ params.wdt).float() + params.dt_bias)  # (B,T,H) fp32
    a = torch.exp(params.A_log)  # (H,)
    log_a = -dt * a               # (B,T,H), <= 0

    xc = u.reshape(b, nk, q, h, p)
    bc = bm.reshape(b, nk, q, n)
    cc = cm.reshape(b, nk, q, n)
    dtc = dt.reshape(b, nk, q, h)
    la = torch.cumsum(log_a.reshape(b, nk, q, h), dim=2)  # inclusive

    # ---- intra-chunk (attention-like masked matmul) ----
    srel = torch.einsum("bkin,bkjn->bkij", cc.to(f32), bc.to(f32))
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]     # (b,nk,i,j,h)
    iq = torch.arange(q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    m = torch.where(causal, torch.exp(seg), 0.0) * dtc[:, :, None, :, :]
    m = m * srel[:, :, :, :, None]
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", m.to(x.dtype), xc)

    # ---- chunk states + inter-chunk recurrence ----
    wj = torch.exp(la[:, :, -1:, :] - la) * dtc             # (b,nk,q,h)
    g = torch.einsum("bkjn,bkjh,bkjhp->bkhnp", bc.to(f32), wj.to(x.dtype).to(f32),
                     xc.to(f32))
    total_decay = torch.exp(la[:, :, -1, :])                # (b,nk,h)

    st = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    prev = []
    for kk in range(nk):
        prev.append(st)
        st = st * total_decay[:, kk, :, None, None] + g[:, kk]
    final_state = st
    prev = torch.stack(prev, dim=1)                          # (b,nk,h,n,p)

    y_inter = torch.einsum("bkin,bkhnp->bkihp", cc, prev.to(x.dtype))
    y_inter = y_inter * torch.exp(la)[..., None].to(x.dtype)

    y = (y_intra + y_inter).reshape(b, t, h, p)
    y = y + params.D.to(x.dtype)[None, None, :, None] * u.reshape(b, t, h, p)
    zi = z.reshape(b, t, h, p)
    out = _gated_norm(y.float(), zi, params.norm_scale, cfg.norm_eps).to(x.dtype)
    out = out.reshape(b, t, di) @ params.wout
    return out[:, :t_in], final_state


def init_ssm_cache(cfg, batch, dtype, device=None):
    s, h, di = _dims(cfg)
    dev = common.resolve_device(device)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, di + 2 * s.d_state), dtype=dtype,
                            device=dev),
        "state": torch.zeros((batch, h, s.d_state, s.head_dim), dtype=torch.float32, device=dev),
    }


def ssm_decode(params, cfg, cache, x, pos=None, is_global=True):
    """O(1) recurrent decode step.  x: (B,1,d).  Updates ``cache`` in place
    and returns (y, cache)."""
    s, h, di = _dims(cfg)
    n, p = s.d_state, s.head_dim
    b = x.shape[0]
    f32 = torch.float32

    u = x @ params.wx
    bm = x @ params.wB
    cm = x @ params.wC
    v = torch.cat([u, bm, cm], dim=-1)                     # (B,1,F)
    full = torch.cat([cache["conv"], v], dim=1)            # (B,w,F)
    conv = torch.einsum("bwf,wf->bf", full, params.conv_w) + params.conv_b
    conv = F.silu(conv.float()).to(x.dtype)
    u1, b1, c1 = torch.split(conv, [di, n, n], dim=-1)

    dt = F.softplus((x @ params.wdt)[:, 0].float() + params.dt_bias)  # (B,H)
    a = torch.exp(-dt * torch.exp(params.A_log))           # (B,H)
    xh = u1.reshape(b, h, p).float()
    state = cache["state"] * a[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", b1.float(), dt, xh
    )
    y = torch.einsum("bn,bhnp->bhp", c1.float(), state)
    y = y + params.D[None, :, None] * xh
    z = (x @ params.wz)[:, 0].reshape(b, h, p)
    out = _gated_norm(y, z, params.norm_scale, cfg.norm_eps).to(x.dtype)
    out = out.reshape(b, di) @ params.wout
    cache["conv"].copy_(full[:, 1:])
    cache["state"].copy_(state)
    return out[:, None, :], cache
