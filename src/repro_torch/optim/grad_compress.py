"""Cross-pod gradient exchange with GPULZ compression (the paper's
inter-node-communication use case), on the device.

Topology assumption: the pod axis is the slow link.  Across pods, each
gradient leaf is:

  1. quantized to uint16 codes with a per-leaf symmetric scale,
  2. GPULZ-compressed on the pod's device through the pipeline's batched
     entry point (``pipeline.compress_many_chunks``: all slabs of a leaf in
     one dispatch, one launch of the one-launch compressor on a card;
     symbols ARE the codes, S=2) into a buffer **capped at the raw-int16
     size**, so the exchange is never worse than 2 bytes/element,
  3. gathered from every pod (the only inter-pod traffic),
  4. decoded on the device (tables parsed from the received bytes by
     ``format.parse_tables_torch``) and averaged.

When the compressed stream does not fit the cap (incompressible gradients)
the raw uint16 codes are sent instead, signalled by a per-slab flag: the
exchange stays fixed-shape either way.  The wire (payload bytes, the flag,
the scale) equals the reference package's bit for bit.

The reference decodes every slab in its graph and selects by the flag.
Here only the slabs whose flag is set reach the decoder: a fallback slab's
bytes are u16 codes, and tables parsed out of them could send the
one-launch decoder, which reads sections in place, anywhere.  Reading the
flags costs one small device-to-host copy a leaf.

A pod mesh is the port's mesh, a sequence of torch devices
(``sharding/batch.py``), one device a pod: ``pod_exchange_compressed``
compresses each pod's slice on its device through ``shard_vmap`` over the
mesh's one axis, so a mesh of two ``cuda:0`` runs the exchange of two pods
on one card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import format as fmt, pipeline
from repro_torch.core.pipeline import LZSSConfig

# backend/decoder "auto": the one-launch pair on a card, the plain entries
# on the CPU (core/pipeline.py registry), resolved at dispatch.
GRAD_LZ = LZSSConfig(symbol_size=2, window=32, chunk_symbols=2048, backend="auto")
MIN_COMPRESS_SIZE = 65_536  # leaves below this exchange raw
SLAB_SYMBOLS = 1 << 24  # 16M symbols (32 MB) per slab: int32-offset safe


def quantize_u16(x):
    """Symmetric uint16 quantization.  Returns (codes int32 in [0, 65535], scale)."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().max(), min=1e-30) / 32767.0
    codes = torch.clamp(torch.round(x32 / scale), -32767, 32767).to(torch.int32)
    return codes + 32768, scale


def dequantize_u16(codes, scale):
    return (codes.to(torch.float32) - 32768.0) * scale


def _slab_geometry(n: int, cfg: LZSSConfig):
    c = cfg.chunk_symbols
    slab = min(SLAB_SYMBOLS, -(-n // c) * c)
    slab = -(-slab // c) * c
    n_slabs = -(-n // slab)
    return slab, n_slabs


def _cap_bytes(slab: int, ratio_cap: float) -> int:
    """Wire budget per slab: raw-int16 bytes / ratio_cap (>= 1 B/elem)."""
    return max(slab, int(slab * 2 / max(ratio_cap, 1.0)))


def _fallback(codes, cap: int):
    """(n_slabs, slab) int32 codes -> (n_slabs, cap) uint8 fallback wire:
    the codes' u16 bytes when the budget holds them, else their high bytes
    (int8 precision)."""
    n_slabs, slab = codes.shape
    if cap >= slab * 2:
        fb = torch.stack([codes & 0xFF, codes >> 8], dim=2).reshape(n_slabs, -1)[:, :cap]
    else:
        fb = torch.nn.functional.pad(codes >> 8, (0, max(0, cap - slab)))[:, :cap]
    return fb.to(torch.uint8)


def _fallback_codes(payload, slab: int):
    """Inverse of ``_fallback`` -> (n_slabs, slab) int32 codes (the int8
    fallback at the centre of the low byte)."""
    n_slabs, cap = payload.shape
    p32 = payload.to(torch.int32)
    if cap >= slab * 2:
        pairs = p32[:, : slab * 2].reshape(n_slabs, -1, 2)
        return pairs[..., 0] | (pairs[..., 1] << 8)
    hi = torch.nn.functional.pad(p32, (0, max(0, slab - cap)))[:, :slab]
    return (hi << 8) | 128


def _wire(symbols, cfg, orig_bytes, codes, cap):
    """One dispatch compresses every slab's (slab / C, C) symbols; a slab
    whose container fits ``cap`` sends it, else its fallback bytes."""
    n_slabs, slab = codes.shape
    c = cfg.chunk_symbols
    blobs, totals = pipeline.compress_many_chunks(
        symbols.reshape(n_slabs, slab // c, c), cfg, [orig_bytes] * n_slabs)
    used_lz = torch.tensor([t <= cap for t in totals], device=codes.device)
    payload = torch.where(used_lz[:, None], blobs[:, :cap], _fallback(codes, cap))
    return payload, used_lz


def lossy_grad_config(eb: float, cfg: LZSSConfig = GRAD_LZ) -> LZSSConfig:
    """The error-bounded gradient exchange config (``lossy-fz``, S=4).

    Gradients are f32 element streams to the lossy frontend; the configured
    ``cfg.backend`` becomes the *inner* lossless stage.  Optimizer state and
    checkpoints never use this: they stay lossless.
    """
    inner = "auto" if cfg.backend in ("lossy-fz", "sharded") else cfg.backend
    return dataclasses.replace(
        cfg, symbol_size=4, backend="lossy-fz", decoder="auto",
        lossy_eb=float(eb), lossy_inner=inner,
    )


def _lossy_method_params(lcfg: LZSSConfig) -> tuple:
    """The (mode, inner_method) pin, known from the config alone."""
    mode = fmt.LOSSY_MODE_QUANT if float(lcfg.lossy_eb) > 0.0 else fmt.LOSSY_MODE_LOSSLESS
    return (mode, pipeline.container_method(lcfg.lossy_inner))


def _used_rows(used_lz):
    """Indices of the slabs that carry a container (one device-to-host copy)."""
    return torch.nonzero(used_lz).reshape(-1)


def _decompress_slabs(payload, used_lz, slab, cfg):
    """(n_slabs, cap) wire -> (n_slabs, slab) int32 codes."""
    c = cfg.chunk_symbols
    nc = slab // c
    codes = _fallback_codes(payload, slab)
    rows = _used_rows(used_lz)
    if rows.numel():
        blobs = payload[rows]
        n_tokens, payload_sizes = fmt.parse_tables_torch(blobs, nc)
        syms = pipeline.decompress_many_chunks(
            blobs, n_tokens, payload_sizes, symbol_size=2, chunk_symbols=c, n_chunks=nc,
            decoder=cfg.decoder,
        )
        codes[rows] = syms.reshape(rows.numel(), slab)
    return codes


def _decompress_slabs_lossy(payload, used_lz, slab, lcfg, scale):
    """(n_slabs, cap) lossy wire -> (n_slabs, slab) f32 gradients: a slab
    with a container within eb of the input, a fallback slab its u16 codes
    dequantized (error scale/2, not eb-bounded)."""
    g = dequantize_u16(_fallback_codes(payload, slab), scale)
    rows = _used_rows(used_lz)
    if rows.numel():
        c = lcfg.chunk_symbols
        blobs = payload[rows]
        zeros = torch.zeros(rows.numel(), slab // c, dtype=torch.int32, device=payload.device)
        syms = pipeline.decompress_many_chunks(
            blobs, zeros, zeros, symbol_size=4, chunk_symbols=c, n_chunks=slab // c,
            decoder="lossy-fz", method_params=_lossy_method_params(lcfg),
        )
        g[rows] = syms.reshape(rows.numel(), slab).view(torch.float32)
    return g


def compress_leaf(g, cfg: LZSSConfig = GRAD_LZ, ratio_cap: float = 2.0, lossy_eb=None):
    """Gradient leaf -> fixed-size wire format, on ``g``'s device.

    Returns dict: payload (uint8, 2/ratio_cap bytes/elem), used_lz (bool per
    slab), scale (f32).  Large leaves are slab-split; slabs whose LZSS
    container exceeds the budget degrade to the codes (int8 precision when
    the budget is under 2 bytes an element; used_lz=False).

    ``lossy_eb`` switches fitting slabs to the error-bounded ``lossy-fz``
    path at the SAME wire budget: max |g' - g| <= eb per element instead of
    the u16 quantization's scale/2.  Fallback slabs still carry the u16
    codes either way.
    """
    flat = g.reshape(-1)
    n = flat.numel()
    codes, scale = quantize_u16(flat)
    slab, n_slabs = _slab_geometry(n, cfg)
    pad = n_slabs * slab - n
    padded = torch.nn.functional.pad(codes, (0, pad)).reshape(n_slabs, slab)
    cap = _cap_bytes(slab, ratio_cap)
    if lossy_eb is None:
        payload, used_lz = _wire(padded, cfg, slab * 2, padded, cap)
    else:
        bits = torch.nn.functional.pad(flat.to(torch.float32), (0, pad)).view(torch.int32)
        payload, used_lz = _wire(bits, lossy_grad_config(lossy_eb, cfg), slab * 4, padded, cap)
    return {"payload": payload.reshape(-1), "used_lz": used_lz, "scale": scale}


def decompress_leaf(wire, shape, cfg: LZSSConfig = GRAD_LZ, ratio_cap: float = 2.0,
                    lossy_eb=None):
    """Inverse of compress_leaf -> fp32 gradient leaf, on the wire's device."""
    n = 1
    for s in shape:
        n *= s
    slab, n_slabs = _slab_geometry(n, cfg)
    payload = wire["payload"].reshape(n_slabs, _cap_bytes(slab, ratio_cap))
    if lossy_eb is not None:
        g = _decompress_slabs_lossy(payload, wire["used_lz"], slab,
                                    lossy_grad_config(lossy_eb, cfg), wire["scale"])
        return g.reshape(-1)[:n].reshape(shape)
    codes = _decompress_slabs(payload, wire["used_lz"], slab, cfg).reshape(-1)[:n]
    return dequantize_u16(codes, wire["scale"]).reshape(shape)


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pod_exchange_compressed(grad_stack, mesh, compress: bool = True, cfg: LZSSConfig = GRAD_LZ,
                            ratio_cap: float = 2.0, lossy_eb=None):
    """Average pod-stacked gradients; the pods exchange only compressed bytes.

    ``grad_stack`` is a tree (dicts, lists, tuples) of tensors whose leading
    dim is the pod, one row a device of ``mesh`` (a sequence of torch
    devices or their names; the same device may stand for several pods).
    Each pod's slice is compressed on its device through
    ``sharding.batch.shard_vmap``, so no raw gradient leaves its pod; the
    fixed-size wires gather on the device of the stacked leaf, where every
    slice is decoded and the mean taken.  Leaves under
    ``MIN_COMPRESS_SIZE`` elements (or all, with ``compress=False``) are
    averaged as they are.
    """
    from repro_torch.sharding import batch as shbatch
    from repro_torch.sharding import rules

    devs = shbatch.mesh_devices(mesh)
    n_pods = len(devs)
    # per-pod view: compression stays pod-local, so a sharded batch config
    # resolves to its single-device dispatch here
    local_cfg = shbatch.unsharded(cfg)

    def pod_wire(x):
        w = compress_leaf(x, local_cfg, ratio_cap, lossy_eb)
        return w["payload"], w["used_lz"], w["scale"]

    def exchange_leaf(g):
        if g.shape[0] != n_pods:
            raise ValueError(
                f"a stacked gradient leaf has {g.shape[0]} pod rows, the mesh {n_pods} devices")
        shape = tuple(g.shape[1:])
        size = 1
        for s in shape:
            size *= s
        if not compress or size < MIN_COMPRESS_SIZE:
            return g.to(torch.float32).mean(0).to(g.dtype)
        payload, used_lz, scale = shbatch.shard_vmap(pod_wire, devs, rules.MESH_AXES[0])(g)
        acc = 0.0
        for k in range(n_pods):
            wk = {"payload": payload[k], "used_lz": used_lz[k], "scale": scale[k]}
            acc = acc + decompress_leaf(wk, shape, local_cfg, ratio_cap, lossy_eb)
        return (acc / n_pods).to(g.dtype)

    return _tree_map(exchange_leaf, grad_stack)
