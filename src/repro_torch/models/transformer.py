"""Unified decoder stack covering all 10 architectures.

One layer implementation, parameterized by ``cfg.mixer``:
  attention        dense llama-family, musicgen, chameleon, llama4-scout
  mla              deepseek-v2 (latent attention)
  ssm              mamba2 (no MLP when d_ff == 0)
  hybrid           hymba (parallel attention + SSM heads, mean-combined)
plus SwiGLU or capacity-MoE feed-forward.

``Transformer`` holds an ``nn.ModuleList`` of ``Layer``s plus ``embed``,
``embed_in`` and ``ln_f``; the functions below take it where the reference
takes its params tree (layers stacked ``(L, ...)`` there, one module a layer
here).  ``forward`` loops over the layers (the reference's ``lax.scan``),
with ``torch.utils.checkpoint`` for ``remat`` when grad is enabled;
prefill/decode loop too, so per-layer caches may have non-uniform shapes
(hymba: window-sized SWA layers vs full-length global layers).  Decode
updates the caches in place, under ``torch.no_grad``.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention, common, mlp, ssm
from repro_torch.sharding import rules as shrules


# ------------------------------------------------------------------ init


class Layer(common.Params):
    def __init__(self, cfg, generator, device):
        super().__init__()
        d = cfg.d_model
        dt = common.dtype_of(cfg)

        def norm(name):
            self.param(name, torch.ones((d,), dtype=dt, device=device), ("embed_unsharded",))

        norm("ln1")
        if cfg.mixer in ("attention", "hybrid"):
            self.attn = attention.Attention(cfg, generator, device)
        if cfg.mixer == "mla":
            self.mla = attention.MLA(cfg, generator, device)
        if cfg.mixer in ("ssm", "hybrid"):
            self.ssm = ssm.SSM(cfg, generator, device)
        if cfg.mixer == "hybrid":
            norm("ln_ab")
            norm("ln_sb")
        if cfg.moe is not None:
            norm("ln2")
            self.moe = mlp.MoE(cfg, generator, device)
        elif cfg.d_ff > 0:
            norm("ln2")
            self.mlp = mlp.SwiGLU(cfg, generator, device)


class Transformer(common.Params):
    def __init__(self, cfg, generator, device):
        super().__init__()
        self.cfg = cfg
        dt = common.dtype_of(cfg)
        v, d = cfg.padded_vocab, cfg.d_model
        self.layers = nn.ModuleList(Layer(cfg, generator, device) for _ in range(cfg.num_layers))
        self.param("ln_f", torch.ones((d,), dtype=dt, device=device), ("embed_unsharded",))
        self.param("embed", common.dense_init(generator, (v, d), dt, in_axis_size=d,
                                              device=device), ("vocab", "embed_out"))
        if not cfg.tie_embeddings:
            self.param("embed_in", common.dense_init(generator, (v, d), dt, in_axis_size=d,
                                                     device=device), ("vocab_in", "embed_sharded"))


def init_layer(generator, cfg, device=None):
    layer = Layer(cfg, generator, common.resolve_device(device))
    return layer, layer.param_axes()


def init_params(cfg, generator, device=None):
    """Returns (model, axes): a ``Transformer`` drawn from ``generator`` and
    ``{state_dict key: logical axes}``."""
    model = Transformer(cfg, generator, common.resolve_device(device))
    return model, model.param_axes()


# ------------------------------------------------------------------ layer


def _mixer_forward(lp, cfg, x, positions, is_global):
    """Pre-norm mixer residual.  Returns (x', cacheables)."""
    h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
    caches = {}
    if cfg.mixer == "attention":
        out, caches["attn"] = attention.attention_forward(lp.attn, cfg, h, positions, is_global)
    elif cfg.mixer == "mla":
        out, caches["mla"] = attention.mla_forward(lp.mla, cfg, h, positions)
    elif cfg.mixer == "ssm":
        out, caches["ssm"] = ssm.ssm_forward(lp.ssm, cfg, h)
    elif cfg.mixer == "hybrid":
        a_out, caches["attn"] = attention.attention_forward(lp.attn, cfg, h, positions,
                                                            is_global)
        s_out, caches["ssm"] = ssm.ssm_forward(lp.ssm, cfg, h)
        out = 0.5 * (
            common.rms_norm(a_out, lp.ln_ab, cfg.norm_eps)
            + common.rms_norm(s_out, lp.ln_sb, cfg.norm_eps)
        )
    else:
        raise ValueError(cfg.mixer)
    return x + out, caches


def _mlp_forward(lp, cfg, x):
    """Pre-norm FFN residual.  Returns (x', aux_loss)."""
    if cfg.moe is not None:
        h = common.rms_norm(x, lp.ln2, cfg.norm_eps)
        out, aux = mlp.moe_apply(lp.moe, cfg, h)
        return x + out, aux
    if cfg.d_ff > 0:
        h = common.rms_norm(x, lp.ln2, cfg.norm_eps)
        return x + mlp.swiglu(lp.mlp, h), 0.0
    return x, 0.0


def layer_forward(lp, cfg, x, positions, is_global):
    x, caches = _mixer_forward(lp, cfg, x, positions, is_global)
    x, aux = _mlp_forward(lp, cfg, x)
    return x, aux, caches


# ---------------------------------------------------------------- forward


def _global_flags(cfg):
    """Per-layer global-attention flags of ``forward`` (the reference's: all
    global unless both a window and global layers are set)."""
    if cfg.sliding_window and cfg.global_attn_layers:
        return [i in cfg.global_attn_layers for i in range(cfg.num_layers)]
    return [True] * cfg.num_layers


def embed_tokens(params, cfg, tokens):
    table = params.embed if cfg.tie_embeddings else params.embed_in
    return table[tokens.long()]


def unembed(params, cfg, h):
    """(B, T, d) -> (B, T, V) f32 logits, from f32 upcasts of both sides."""
    return h.float() @ params.embed.float().T


# Matmul outputs that remat="dots" saves (the reference's
# dots_with_no_batch_dims_saveable); everything else is recomputed.
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _body(lp, cfg, x, positions, is_global):
    x = shrules.constrain_batch(x)
    x, aux, _ = layer_forward(lp, cfg, x, positions, is_global)
    return shrules.constrain_batch(x), torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def forward(params, cfg, *, tokens=None, embeds=None, remat="full"):
    """Full-sequence forward.  Returns (hidden, aux_loss).

    remat: "full" recomputes each layer in the backward pass
    (``torch.utils.checkpoint``), "dots" saves the layer's matmul outputs
    and recomputes the rest, "none" saves everything; without grad all
    three are plain calls.
    """
    if remat not in ("full", "dots", "none"):
        raise ValueError(f"remat must be full, dots or none, not {remat!r}")
    x = embed_tokens(params, cfg, tokens) if embeds is None else embeds
    x = x.to(common.dtype_of(cfg))
    x = shrules.constrain_batch(x)  # pin (B->batch axes, T, d) sharding
    t = x.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=x.device)

    kw = dict(use_reentrant=False)
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, is_global in zip(params.layers, _global_flags(cfg)):
        if remat != "none" and torch.is_grad_enabled():
            x, a = ckpt.checkpoint(_body, lp, cfg, x, positions, is_global, **kw)
        else:
            x, a = _body(lp, cfg, x, positions, is_global)
        aux = aux + a
    return common.rms_norm(x, params.ln_f, cfg.norm_eps), aux


# ------------------------------------------------------- prefill / decode


def _cache_len(cfg, layer_idx, seq_len):
    if cfg.sliding_window and layer_idx not in cfg.global_attn_layers:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg, batch, seq_len, device=None):
    """Per-layer decode caches (list; shapes may differ per layer)."""
    dt = common.dtype_of(cfg)
    dev = common.resolve_device(device)
    caches = []
    for i in range(cfg.num_layers):
        c = {}
        if cfg.mixer in ("attention", "hybrid"):
            c["attn"] = attention.init_kv_cache(cfg, batch, _cache_len(cfg, i, seq_len), dt, dev)
        if cfg.mixer == "mla":
            c["mla"] = attention.init_mla_cache(cfg, batch, seq_len, dt, dev)
        if cfg.mixer in ("ssm", "hybrid"):
            c["ssm"] = ssm.init_ssm_cache(cfg, batch, dt, dev)
        caches.append(c)
    return caches


def layer_is_global(cfg, i) -> bool:
    return (not cfg.sliding_window) or (i in cfg.global_attn_layers)


@torch.no_grad()
def decode_embed(params, cfg, tokens):
    """Decode-step embedding.  tokens: (B,) int -> (B, 1, d)."""
    return embed_tokens(params, cfg, tokens[:, None]).to(common.dtype_of(cfg))


def _decode_tail(lp, cfg, x):
    """Shared FFN residual of one decode layer."""
    if cfg.moe is not None:
        hh = common.rms_norm(x, lp.ln2, cfg.norm_eps)
        out, _ = mlp.moe_apply(lp.moe, cfg, hh)
        return x + out
    if cfg.d_ff > 0:
        hh = common.rms_norm(x, lp.ln2, cfg.norm_eps)
        return x + mlp.swiglu(lp.mlp, hh)
    return x


@torch.no_grad()
def decode_layer(lp, cfg, c, x, pos, is_global):
    """One layer of decode_step.  Returns (x', the layer cache, updated in
    place)."""
    h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
    if cfg.mixer == "attention":
        out, _ = attention.attention_decode(lp.attn, cfg, c["attn"], h, pos, is_global)
    elif cfg.mixer == "mla":
        out, _ = attention.mla_decode(lp.mla, cfg, c["mla"], h, pos)
    elif cfg.mixer == "ssm":
        out, _ = ssm.ssm_decode(lp.ssm, cfg, c["ssm"], h)
    elif cfg.mixer == "hybrid":
        a_out, _ = attention.attention_decode(lp.attn, cfg, c["attn"], h, pos, is_global)
        s_out, _ = ssm.ssm_decode(lp.ssm, cfg, c["ssm"], h)
        out = 0.5 * (
            common.rms_norm(a_out, lp.ln_ab, cfg.norm_eps)
            + common.rms_norm(s_out, lp.ln_sb, cfg.norm_eps)
        )
    else:
        raise ValueError(cfg.mixer)
    return _decode_tail(lp, cfg, x + out), c


@torch.no_grad()
def decode_finish(params, cfg, x):
    """Final norm + unembed of a decode step -> (B, V) logits."""
    h = common.rms_norm(x, params.ln_f, cfg.norm_eps)
    return unembed(params, cfg, h)[:, 0]


@torch.no_grad()
def decode_step(params, cfg, caches, tokens, pos):
    """One decode step.  tokens: (B,) int; pos: int position.

    Returns (logits (B, V), caches), the caches updated in place.
    """
    x = decode_embed(params, cfg, tokens)
    for i, lp in enumerate(params.layers):
        x, _ = decode_layer(lp, cfg, caches[i], x, pos, layer_is_global(cfg, i))
    return decode_finish(params, cfg, x), caches


# ------------------------------------------------------------- paged decode


def init_paged_cache(cfg, batch, seq_len, *, block_tokens, pool_blocks=None, map_all=True,
                     device=None):
    """Paged decode state: one shared physical KV pool + per-layer tables.

    Returns {"pool": {"k","v"} (P, block_tokens, KV, dh),
             "tables": (L, B, n_logical) int32 (-1 = unmapped),
             "extra": per-layer list of non-paged state (ssm)}.

    map_all=True builds identity tables (every logical block resident) —
    the drop-in dense-cache replacement.  map_all=False starts fully
    unmapped; a host-side allocator assigns slots.
    """
    if cfg.mixer not in ("attention", "hybrid"):
        raise NotImplementedError(
            f"paged KV supports attention/hybrid mixers, not {cfg.mixer!r} "
            "(MLA latent-cache paging is not built)"
        )
    if seq_len % block_tokens:
        raise ValueError(f"seq_len={seq_len} not a multiple of block_tokens={block_tokens}")
    dev = common.resolve_device(device)
    n_logical = seq_len // block_tokens
    total = cfg.num_layers * batch * n_logical
    if pool_blocks is None:
        pool_blocks = total
    dt = common.dtype_of(cfg)
    pool = attention.init_paged_kv_pool(cfg, pool_blocks, block_tokens, dt, dev)
    shape = (cfg.num_layers, batch, n_logical)
    if map_all:
        if pool_blocks < total:
            raise ValueError(f"map_all needs pool_blocks >= {total}, got {pool_blocks}")
        tables = torch.arange(total, dtype=torch.int32, device=dev).reshape(shape)
    else:
        tables = torch.full(shape, -1, dtype=torch.int32, device=dev)
    extra = [
        {"ssm": ssm.init_ssm_cache(cfg, batch, dt, dev)} if cfg.mixer == "hybrid" else {}
        for _ in range(cfg.num_layers)
    ]
    return {"pool": pool, "tables": tables, "extra": extra}


@torch.no_grad()
def decode_layer_paged(lp, cfg, pool, table, extra, x, pos, is_global):
    """Paged twin of decode_layer.  Returns (x', pool, extra), both updated
    in place."""
    h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
    if cfg.mixer == "attention":
        out, _ = attention.paged_attention_decode(lp.attn, cfg, pool, table, h, pos, is_global)
    elif cfg.mixer == "hybrid":
        a_out, _ = attention.paged_attention_decode(lp.attn, cfg, pool, table, h, pos,
                                                    is_global)
        s_out, _ = ssm.ssm_decode(lp.ssm, cfg, extra["ssm"], h)
        out = 0.5 * (
            common.rms_norm(a_out, lp.ln_ab, cfg.norm_eps)
            + common.rms_norm(s_out, lp.ln_sb, cfg.norm_eps)
        )
    else:
        raise NotImplementedError(cfg.mixer)
    return _decode_tail(lp, cfg, x + out), pool, extra


@torch.no_grad()
def decode_step_paged(params, cfg, paged, tokens, pos):
    """One decode step over the paged cache.

    paged: init_paged_cache state, updated in place.  Tables pass through
    unchanged — slot assignment is host-side; the step scatters the new
    token and gathers the attention reads against the shared pool.
    """
    x = decode_embed(params, cfg, tokens)
    for i, lp in enumerate(params.layers):
        x, _, _ = decode_layer_paged(lp, cfg, paged["pool"], paged["tables"][i],
                                     paged["extra"][i], x, pos, layer_is_global(cfg, i))
    return decode_finish(params, cfg, x), paged


@torch.no_grad()
def prefill(params, cfg, tokens=None, embeds=None):
    """Prefill: forward pass + last-position logits (serving path)."""
    h, _ = forward(params, cfg, tokens=tokens, embeds=embeds, remat="none")
    return unembed(params, cfg, h[:, -1:, :])[:, 0]


# ------------------------------------------------------------------ loss


def loss_fn(params, cfg, batch, remat="full"):
    """Next-token CE (+ MoE aux + z-loss).  batch: tokens or embeds+labels."""
    tokens = batch.get("tokens")
    embeds = batch.get("embeds")
    labels = batch.get("labels", tokens)
    h, aux = forward(params, cfg, tokens=tokens, embeds=embeds, remat=remat)
    logits = unembed(params, cfg, h)[:, :-1]  # fp32
    targets = labels[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.clamp(min=0)[..., None])[..., 0]
    mask = (targets >= 0).float()
    denom = torch.clamp(torch.sum(mask), min=1.0)
    ce = torch.sum((logz - ll) * mask) / denom
    z_loss = 1e-4 * torch.sum(torch.square(logz) * mask) / denom
    total = ce + z_loss + aux
    return total, {"loss": total, "ce": ce, "aux": aux, "z": z_loss}
