"""Error-bounded lossy frontend: the ``lossy-fz`` container (method 2).

FZ-GPU's recipe for scientific f32 data:

    dual-quant (core/quant.py's ndim=1 Lorenzo delta over the flattened
    element stream) -> bitshuffle (core/bitshuffle.py) -> a lossless inner
    container (the device's LZSS backend, or ``deflate-full``)

plus an outlier section (saturated and non-finite elements stored as
exact (u32 index, f32 bits) pairs) and a 32-byte metadata block carrying
the error bound, so ``decompress`` needs the container bytes alone.

  * quant mode (``lossy_eb > 0``): max |x' - x| <= eb for every finite
    element; NaN / ±inf round-trip bit-exactly as outliers.  The stored
    eb is the f32 rounding of the configured bound, and both sides derive
    2*eb and its reciprocal in f32, so the encoder's and the decoder's
    integer chains agree bit for bit.
  * lossless mode (``lossy_eb == 0``): bit-exact, NaN payloads included;
    the f32 halves pass through bitshuffle untouched.

The containers are byte-identical to the reference package's.  That rests
on doing its float operations in its order, eagerly (no fusion into an
FMA): pre-quant is ``round(x * fl32(1 / (2 * eb)))``, never a division by
2*eb, and the encoder's simulation of the decoder keeps its 2-ulp guard.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitshuffle
from repro_torch.core import format as fmt
from repro_torch.core import quant
from repro_torch.runtime import trace

assert bitshuffle.BLOCK_UNITS == fmt.LOSSY_BLOCK_UNITS

INT30 = 2.0**30


def eb_to_f32(error_bound: float) -> float:
    """The f32-rounded bound both sides of the format actually honour."""
    return float(np.float32(error_bound))


def _rcp(eb2: np.float32) -> np.float32:
    """The format's pre-quant scale: the f32 reciprocal of 2*eb.

    An IEEE f32 division, correctly rounded, on both the encode side (eb
    from the config) and the decode side (eb from container bytes); a
    plain multiply by it then has nothing to strength-reduce.
    """
    return np.float32(1.0) / np.float32(eb2)


def _scalar(v: np.float32, device) -> torch.Tensor:
    """An f32 scalar on ``device``: one pageable host-to-device copy."""
    trace.count("bytes_h2d", 4)
    trace.count("host_syncs", 1)
    return torch.tensor(v, dtype=torch.float32, device=device)


def _prequant(x: torch.Tensor, rcp: np.float32):
    """round / clip pre-quantization, NaN pinned to 0 (core/quant.py rules).

    Returns ``(qf, nan, q)``: the rounded float, its NaN mask and the int32
    code clipped to +-2**30.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does.
    """
    r = _scalar(rcp, x.device)
    qf = torch.round(x * r)
    nan = torch.isnan(qf)
    q = torch.clamp(torch.where(nan, 0.0, qf), -INT30, INT30).to(torch.int32)
    return qf, nan, q


def _inner_compress(inner_syms, cfg, inner_name, nbytes, impl):
    """The inner lossless container of the bitshuffled unit stream."""
    from repro_torch.core import entropy, pipeline  # pipeline registers this hook

    inner_cfg = pipeline.LZSSConfig(
        symbol_size=2, window=cfg.window, chunk_symbols=fmt.LOSSY_INNER_CHUNK_SYMBOLS,
        backend=inner_name,
    )
    if pipeline.container_method(inner_name) == fmt.METHOD_HUFFMAN:
        return entropy.compress_entropy(inner_syms, inner_cfg, nbytes, impl=impl)
    lz = pipeline.get_backend("torch" if impl == "plain" else inner_name, inner_syms.device)
    blobs, totals = pipeline.lzss_many(lz, inner_syms[None], inner_cfg, [nbytes])
    return blobs[0], totals[0]


def compress_lossy(symbols, cfg, orig_bytes=None, *, impl=None):
    """The ``lossy-fz`` backend's compress hook.

    ``symbols`` is the (nc, C) int32 S=4 symbol tensor: each symbol is one
    little-endian f32 bit pattern.  Returns ``(buffer (cap,) uint8, total
    bytes)`` holding a complete method-2 container, zeros beyond the
    total.  ``impl="plain"`` runs the plain versions of every kernel.
    """
    from repro_torch.core import pipeline  # pipeline registers this hook

    nc, c = symbols.shape
    dev = symbols.device
    eb32 = eb_to_f32(cfg.lossy_eb)
    mode = fmt.LOSSY_MODE_QUANT if eb32 > 0.0 else fmt.LOSSY_MODE_LOSSLESS
    n_elems, units_pad, inner_nc = fmt.lossy_stream_geometry(nc, c, mode)
    flat = symbols.reshape(-1).to(torch.int32).contiguous()

    with trace.span("lossy.quantize", dev):
        if mode == fmt.LOSSY_MODE_QUANT:
            x = flat.view(torch.float32)
            eb2 = np.float32(2.0 * eb32)
            qf, nan, q = _prequant(x, _rcp(eb2))
            delta = torch.diff(q, prepend=torch.zeros_like(q[:1])) + quant.CENTER
            sat = (delta < quant.CODE_MIN) | (delta > quant.CODE_MAX) | (qf.abs() >= INT30) | nan
            # The decoder rebuilds exactly q.float() * eb2: simulate it, and make
            # an exact outlier of any element the f32 round trip takes past the
            # bound.  ~(err <= eb) also catches non-finite x.  The 2-ulp guard
            # keeps the check conservative against a fused multiply-subtract.
            recon = q.to(torch.float32) * _scalar(eb2, dev)
            guard = recon.abs() * np.float32(2.0**-22)
            sat = sat | ~((recon - x).abs() + guard <= np.float32(eb32))
            units_live = torch.where(sat, quant.CENTER, delta)
            units_live = torch.where(units_live >= 1 << 15, units_live - (1 << 16), units_live)
            units_live = units_live.to(torch.int16)
        else:
            units_live = flat.view(torch.int16)  # (lo, hi) halves of each element
            sat = None

    with trace.span("lossy.bitshuffle", dev):
        units = torch.zeros(units_pad, dtype=torch.int16, device=dev)
        units[: units_live.shape[0]] = units_live
        inner_c = fmt.LOSSY_INNER_CHUNK_SYMBOLS
        inner_bytes = torch.zeros(inner_nc * inner_c * 2, dtype=torch.uint8, device=dev)
        bitshuffle.shuffle(units, impl=impl, out=inner_bytes)  # the prefix; the tail stays 0
        inner_syms = pipeline.pack_symbols(inner_bytes, 2).reshape(inner_nc, inner_c)

    with trace.span("lossy.inner", dev):
        inner_name = pipeline.resolve_backend(cfg.lossy_inner, dev)
        inner_method = pipeline.container_method(inner_name)
        inner_buf, inner_total = _inner_compress(inner_syms, cfg, inner_name, 2 * units_pad,
                                                 impl)
    inner_cap = fmt.lossy_inner_capacity(inner_nc, inner_method)
    assert inner_buf.shape[0] == inner_cap, (
        f"inner backend {inner_name!r} emitted a {inner_buf.shape[0]}-byte "
        f"capacity buffer, format expects {inner_cap}"
    )

    sec_meta = fmt.HEADER_BYTES + 8 * nc
    sec_inner = sec_meta + fmt.LOSSY_META_FIXED
    with trace.span("lossy.outliers", dev):
        if mode == fmt.LOSSY_MODE_QUANT:
            trace.count("host_syncs", 1)  # the host waits for nonzero's count
            idx = torch.nonzero(sat).reshape(-1)  # ascending: the rank order
            n_out = idx.shape[0]
            pairs = torch.stack([idx.to(torch.int32), flat[idx]], dim=1)
            total = sec_inner + inner_total + 8 * n_out
            eb_bits = int(np.float32(eb32).view(np.uint32))
        else:
            n_out = 0
            total = sec_inner + inner_total
            eb_bits = 0

    with trace.span("lossy.assemble", dev):
        out_cap = sec_inner + inner_cap + (8 * n_elems if mode == fmt.LOSSY_MODE_QUANT else 0)
        out = torch.zeros(out_cap, dtype=torch.uint8, device=dev)
        zeros_nc = torch.zeros(nc, dtype=torch.int32, device=dev)
        fmt.write_header_and_tables(
            out, symbol_size=4, window=cfg.window, chunk_symbols=c, n_chunks=nc,
            orig_bytes=nc * c * 4 if orig_bytes is None else orig_bytes,
            payload_total=0, flag_total=0, n_tokens=zeros_nc, payload_sizes=zeros_nc,
            method=fmt.METHOD_LOSSY, sub_log2=0,
        )
        out[sec_inner : sec_inner + inner_cap] = inner_buf
        if n_out:
            obase = sec_inner + inner_total
            out[obase : obase + 8 * n_out] = pairs.contiguous().view(torch.uint8).reshape(-1)

        meta = (
            eb_bits.to_bytes(4, "little")
            + bytes([mode, 1, inner_method, 0])  # mode, quantization ndim, inner method
            + n_out.to_bytes(4, "little")
            + int(inner_total).to_bytes(4, "little")
            + n_elems.to_bytes(8, "little")
            + bytes(8)
        )
        out[sec_meta : sec_meta + fmt.LOSSY_META_FIXED] = torch.frombuffer(
            bytearray(meta), dtype=torch.uint8
        )
        trace.count("bytes_h2d", len(meta))  # a pageable copy
        trace.count("host_syncs", 1)
    return out, total


def _inner_decode(inner_blob, impl):
    """(nc, 2048) int32 symbols of the inner container held in ``inner_blob``."""
    from repro_torch.core import entropy, pipeline

    nc = int.from_bytes(inner_blob[12:16].cpu().numpy().tobytes(), "little")
    # the header, the tables and (method 1) the fixed entropy metadata
    head = inner_blob[: fmt.HEADER_BYTES + 8 * nc + fmt.ENTROPY_META_FIXED]
    trace.count("bytes_d2h", 4 + head.numel())  # two blocking reads
    trace.count("host_syncs", 2)
    ih = fmt.parse_header(head.cpu().numpy())
    if ih.method == fmt.METHOD_HUFFMAN:
        return entropy.decode_blob_entropy(inner_blob, ih, impl=impl)
    tables = inner_blob[ih.sec_a : ih.sec_flags].clone().view(torch.int32).reshape(2, -1)
    return pipeline.decompress_chunks(
        inner_blob, tables[0], tables[1], symbol_size=2,
        chunk_symbols=fmt.LOSSY_INNER_CHUNK_SYMBOLS, n_chunks=ih.n_chunks,
        decoder="torch-parallel" if impl == "plain" else "auto",
    )


def decode_blob_lossy(blob, header: fmt.Header, *, impl=None):
    """The ``lossy-fz`` decoder's whole-container hook.

    ``blob`` is a flat uint8 tensor holding at least the container's live
    bytes and ``header`` its host-parsed header (with the method-2
    metadata).  Decodes the inner container through the device's LZSS
    chain (``deflate-full`` for a method-1 inner), inverts the bitshuffle,
    and in quant mode integrates the delta chain with the outlier-anchored
    repair before overlaying the exact outliers.  Returns (nc, C) int32
    f32-bit-pattern symbols.
    """
    h = header
    _, units_pad, _ = fmt.lossy_stream_geometry(h.n_chunks, h.chunk_symbols, h.lossy_mode)
    blob = blob.reshape(-1)
    dev = blob.device
    with trace.span("lossy.inner", dev):
        inner = _inner_decode(blob[h.sec_lossy_inner : h.sec_lossy_inner + h.inner_total], impl)
    from repro_torch.core import pipeline

    with trace.span("lossy.unshuffle", dev):
        shuffled = pipeline.unpack_symbols(inner.reshape(-1), 2)[: 2 * units_pad]
        units = bitshuffle.unshuffle(shuffled.contiguous(), impl=impl)
    with trace.span("lossy.dequantize", dev):
        return _reconstruct(units, blob, h)


def decode_many_lossy(blobs, *, chunk_symbols, n_chunks, mode, inner_method, impl=None):
    """A batch of method-2 containers whose ``(mode, inner_method)`` the
    caller knows -> (B, nc, C) int32 f32-bit-pattern symbols.

    ``blobs`` is (B, L) uint8, each row one container's live bytes (zeros
    or anything beyond).  One device-to-host copy reads every row's header
    and metadata, each checked against the geometry and the pin.  The inner
    containers sit at one static offset: raw ones decode in one dispatch of
    the device's LZSS decoder (tables parsed on the device), ``deflate-full``
    ones container by container; the bitshuffle inverse runs once over all
    rows.  Each row's symbols equal ``decode_blob_lossy``'s.
    """
    from repro_torch.core import pipeline

    nc, c = n_chunks, chunk_symbols
    _, units_pad, inner_nc = fmt.lossy_stream_geometry(nc, c, mode)
    b = blobs.shape[0]
    sec_inner = fmt.HEADER_BYTES + 8 * nc + fmt.LOSSY_META_FIXED
    dev = blobs.device
    trace.count("bytes_d2h", b * sec_inner)
    trace.count("host_syncs", 1)
    heads = blobs[:, :sec_inner].cpu().numpy()
    hs = []
    for i in range(b):
        h = fmt.parse_header(heads[i])
        got = (h.method, h.symbol_size, h.chunk_symbols, h.n_chunks, h.lossy_mode,
               h.inner_method)
        if got != (fmt.METHOD_LOSSY, 4, c, nc, mode, inner_method):
            raise ValueError(
                f"buffer {i}: (method, symbol_size, chunk_symbols, n_chunks, mode, "
                f"inner_method) = {got}, the batch was pinned to "
                f"{(fmt.METHOD_LOSSY, 4, c, nc, mode, inner_method)}"
            )
        hs.append(h)
    with trace.span("lossy.inner", dev):
        if inner_method == fmt.METHOD_RAW:
            inner = blobs[:, sec_inner:]
            n_tokens, payload_sizes = fmt.parse_tables_torch(inner, inner_nc)
            syms = pipeline.decompress_many_chunks(
                inner, n_tokens, payload_sizes, symbol_size=2,
                chunk_symbols=fmt.LOSSY_INNER_CHUNK_SYMBOLS, n_chunks=inner_nc,
                decoder="torch-parallel" if impl == "plain" else "auto",
            )
        else:
            syms = torch.stack([
                _inner_decode(blobs[i, sec_inner : sec_inner + h.inner_total], impl)
                for i, h in enumerate(hs)
            ])
    with trace.span("lossy.unshuffle", dev):
        shuffled = pipeline.unpack_symbols(syms.reshape(b, -1), 2).reshape(b, -1)
        units = bitshuffle.unshuffle(shuffled[:, : 2 * units_pad].reshape(-1), impl=impl)
        units = units.reshape(b, units_pad)
    with trace.span("lossy.dequantize", dev):
        return torch.stack([_reconstruct(units[i], blobs[i], h) for i, h in enumerate(hs)])


def _reconstruct(units, blob, h: fmt.Header):
    """(units_pad,) int16 units of one container -> (nc, C) int32 symbols:
    the halves as they are in lossless mode; in quant mode the integrated
    delta chain, repaired at the outliers, dequantized, outliers overlaid."""
    nc, c, mode = h.n_chunks, h.chunk_symbols, h.lossy_mode
    n_elems, _, _ = fmt.lossy_stream_geometry(nc, c, mode)
    dev = blob.device
    if mode == fmt.LOSSY_MODE_LOSSLESS:
        return units[: 2 * n_elems].contiguous().view(torch.int32).reshape(nc, c)

    eb2 = np.float32(2.0) * np.uint32(h.lossy_eb_bits).view(np.float32)
    codes = units[:n_elems].to(torch.int32) & 0xFFFF
    q = torch.cumsum(codes - quant.CENTER, 0, dtype=torch.int32)

    # sparse outlier pairs -> dense mask / values
    n_out = h.n_outliers
    pairs = blob[h.sec_outliers : h.sec_outliers + 8 * n_out].clone().view(torch.int32)
    oidx = pairs[0::2].to(torch.int64).clamp(0, n_elems - 1)
    mask = torch.zeros(n_elems, dtype=torch.bool, device=dev)
    trace.count("bytes_h2d", 1)  # index_put_ copies the scalar True from the host
    trace.count("host_syncs", 1)
    mask[oidx] = True
    vbits = torch.zeros(n_elems, dtype=torch.int32, device=dev)
    vbits[oidx] = pairs[1::2]
    ovals = vbits.view(torch.float32)

    # chain repair, mirroring quant.dequantize's ndim=1 path: every element
    # takes the correction of the last outlier at or before it (the
    # reference's cummax over the outlier mask).  The outlier indices are
    # few and sorted, so a binary search finds it; torch.cummax over a 1-D
    # CUDA tensor scans in one thread block.
    _, _, q_ref = _prequant(ovals, _rcp(eb2))
    k = torch.arange(n_elems, device=dev, dtype=torch.int64)
    marks = torch.sort(oidx).values
    pos = torch.searchsorted(marks, k, right=True) - 1
    last = torch.where(pos >= 0, marks[pos.clamp(min=0)], -1) if n_out else torch.full_like(k, -1)
    adj = torch.where(mask, q_ref - q, 0)
    carry = adj[last.clamp(min=0)]
    q = q + torch.where(last >= 0, carry, 0)
    x = (q.to(torch.float32) * _scalar(eb2, dev)).view(torch.int32)
    return torch.where(mask, vbits, x).reshape(nc, c)
