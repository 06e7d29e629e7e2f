"""Canonical-Huffman entropy stage: the ``deflate-full`` container (method 1).

A byte-level canonical Huffman code over each of the two compact sections
of an LZSS container (flags, payload) replaces them with

    codebooks (nibble-packed code lengths) + bit counts + gap arrays +
    MSB-first bitstreams

The gap arrays store the bit offset of every ``SUB = 512``-th decoded
byte's codeword, so decoding is parallel across sub-blocks and sequential
only inside one.

Layering, as in the reference package's ``core/entropy.py``:

  * host code lengths (``huffman_code_lengths``, ``limit_code_lengths``,
    ``container_code_lengths``): numpy, from the 256-count histogram (one
    1 KiB device-to-host copy per section).  Length-limited to
    ``MAX_CODE_LEN`` with a deterministic Kraft repair, plus the *stored
    escape*: if the limited code would spend more than 8 bits per byte,
    every symbol gets the 8-bit identity code.
  * ``canonical_tables``: the encode map (``codes`` / ``lengths``) and the
    decode tables (``first`` / ``count`` / ``base`` / ``order``).
  * ``byte_histogram`` and ``decode_section``'s gap decode go through
    ``kernels/ops.py`` (the CUDA kernels on a CUDA tensor, the plain
    versions on a CPU tensor; ``impl="plain"`` asks for the plain versions
    on any device).  ``encode_section`` is plain PyTorch: a cumsum of code
    lengths and three byte-wise ``index_add_``.
  * ``compress_entropy`` / ``decode_blob_entropy``: the ``deflate-full``
    backend's and decoder's hooks in ``core/pipeline.py``.

Bit offsets are int64 here and written as the format's u32 entries, so a
section may hold up to 2**29 bytes.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.runtime import trace

MAX_CODE_LEN = 15  # nibble-packed codebook: one hex digit per symbol
STORED_LEN = 8  # escape code length: identity byte code, no expansion
N_SYMBOLS = 256


def _check_impl(impl):
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain': {impl!r}")


# ----------------------------------------------------- host tree building


def huffman_code_lengths(counts: np.ndarray, max_len: int | None = None):
    """Code length per symbol (0 for absent symbols), host heapq build.

    Ties break by (count, id), internal nodes numbered above the leaves;
    ``max_len`` applies ``limit_code_lengths`` on top.
    """
    counts = np.asarray(counts)
    heap = [(int(c), i) for i, c in enumerate(counts) if c > 0]
    if len(heap) == 1:
        lengths = np.zeros(counts.size, np.int64)
        lengths[heap[0][1]] = 1
        return lengths
    heapq.heapify(heap)
    parent = {}
    next_id = counts.size
    while len(heap) > 1:
        c1, n1 = heapq.heappop(heap)
        c2, n2 = heapq.heappop(heap)
        parent[n1] = next_id
        parent[n2] = next_id
        heapq.heappush(heap, (c1 + c2, next_id))
        next_id += 1
    lengths = np.zeros(counts.size, np.int64)
    for sym in range(counts.size):
        if counts[sym] == 0:
            continue
        d, node = 0, sym
        while node in parent:
            node = parent[node]
            d += 1
        lengths[sym] = d
    if max_len is not None:
        lengths = limit_code_lengths(lengths, max_len)
    return lengths


def limit_code_lengths(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """Clamp code lengths to ``max_len`` and repair the Kraft sum.

    The repair deepens the symbol with the largest length below
    ``max_len`` (smallest symbol id on ties) until Kraft holds again.
    """
    l = np.where(lengths > 0, np.minimum(lengths, max_len), 0).astype(np.int64)
    excess = int(np.where(l > 0, 1 << (max_len - l), 0).sum()) - (1 << max_len)
    while excess > 0:
        cand = np.nonzero((l > 0) & (l < max_len))[0]
        deepest = cand[l[cand] == l[cand].max()][0]
        excess -= 1 << (max_len - int(l[deepest]) - 1)
        l[deepest] += 1
    return l


def container_code_lengths(counts: np.ndarray) -> np.ndarray:
    """The code the container writer uses: limited Huffman + stored escape.

    If the limited code would spend more than 8 bits per byte, every symbol
    gets the 8-bit identity code, which bounds the bitstream by the raw
    section size (``format.entropy_max_compressed_bytes``).
    """
    counts = np.asarray(counts, np.int64)
    l = huffman_code_lengths(counts, max_len=MAX_CODE_LEN)
    if int((counts * (l - STORED_LEN)).sum()) > 0:
        l = np.full(counts.size, STORED_LEN, np.int64)
    return l


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Host encode map: canonical (MSB-first) codeword per symbol."""
    l = np.asarray(lengths, np.int64)
    order = sorted(range(l.size), key=lambda s: (l[s] if l[s] > 0 else 99, s))
    codes = np.zeros(l.size, np.int64)
    code, prev = 0, 0
    for s in order:
        if l[s] == 0:
            break
        code <<= int(l[s]) - prev
        codes[s] = code
        code += 1
        prev = int(l[s])
    return codes


def canonical_tables(lengths, device="cpu") -> dict:
    """Canonical code tables from a length assignment, as int32 tensors.

      ``lengths`` (256,)  the input
      ``codes``   (256,)  codeword per symbol (0 for absent symbols)
      ``first``   (16,)   first codeword of each length (index 0 unused)
      ``count``   (16,)   symbols per length
      ``base``    (16,)   symbols with a shorter positive length
      ``order``   (256,)  symbols sorted by (length, symbol), absent
                          symbols last: the decode map

    A window ``cand = win >> (15 - l)`` decodes at length ``l`` when
    ``first[l] <= cand < first[l] + count[l]``; the canonical construction
    lets at most one length match.
    """
    if isinstance(lengths, torch.Tensor):
        if lengths.device.type != "cpu":
            trace.count("bytes_d2h", lengths.numel() * lengths.element_size())
            trace.count("host_syncs", 1)
        lengths = lengths.cpu().numpy()
    l = np.asarray(lengths, np.int64).reshape(-1)
    live = l > 0
    count = np.bincount(l[live], minlength=MAX_CODE_LEN + 1)[: MAX_CODE_LEN + 1]
    base = np.cumsum(count) - count
    # stable (length, symbol) order, absent symbols after every live one
    order = np.lexsort((np.arange(l.size), np.where(live, l, MAX_CODE_LEN + 1)))
    rank = np.empty(l.size, np.int64)
    rank[order] = np.arange(l.size)
    first = np.zeros(MAX_CODE_LEN + 1, np.int64)
    f = 0
    for ll in range(1, MAX_CODE_LEN + 1):
        if ll > 1:
            f = (f + int(count[ll - 1])) << 1
        first[ll] = f
    lc = np.clip(l, 0, MAX_CODE_LEN)
    codes = np.where(live, first[lc] + rank - base[lc], 0)
    tabs = dict(lengths=l, codes=codes, first=first, count=count, base=base, order=order)
    trace.count("bytes_h2d", 4 * sum(v.size for v in tabs.values()))  # six pageable copies
    trace.count("host_syncs", len(tabs))
    return {k: torch.from_numpy(v.astype(np.int32)).to(device) for k, v in tabs.items()}


# --------------------------------------------------------------- histogram


def byte_histogram(buf, start: int, length: int, *, impl=None):
    """(256,) int32 counts of the byte values of ``buf[start : start + length]``."""
    _check_impl(impl)
    if impl == "plain":
        from repro_torch.kernels import lz_entropy

        return lz_entropy.byte_histogram_plain(buf, start, length)
    from repro_torch.kernels import ops

    return ops.byte_histogram(buf, start, length)


# ------------------------------------------------------- section transcode


def encode_section(buf, start: int, length: int, lengths, *, cap: int, sub: int | None = None):
    """Bit-pack ``buf[start : start + length]`` with a canonical code.

    Returns ``(stream, nbits, gaps)``: a ``(cap + 8,)`` uint8 stream whose
    first ``ceil(nbits / 8)`` bytes are live (zeros beyond), the bit count
    as a host int, and the ``(ceil(cap / sub),)`` int64 gap array — the bit
    offset of every ``sub``-th byte's codeword, ``nbits`` past the section.

    Each codeword (<= 15 bits at a bit phase <= 7) lands inside a 24-bit
    window, i.e. three consecutive stream bytes; adjacent codewords touch
    disjoint bits, so byte-wise addition never carries.
    """
    sub = (1 << fmt.DEFAULT_SUB_LOG2) if sub is None else sub
    dev = buf.device
    tabs = canonical_tables(lengths, dev)
    byte = buf.reshape(-1)[start : start + length].to(torch.int64) & 0xFF
    l = tabs["lengths"][byte]
    code = tabs["codes"][byte]
    csum = torch.cumsum(l, 0, dtype=torch.int64)
    off = csum - l
    nbits = 0
    if length:
        trace.count("bytes_d2h", csum.element_size())
        trace.count("host_syncs", 1)
        nbits = int(csum[-1])
    w = code << (24 - l - (off & 7).to(torch.int32))  # < 2**24: int32 is enough
    base = off >> 3
    stream = torch.zeros(cap + 8, dtype=torch.int32, device=dev)
    for k in range(3):
        stream.index_add_(0, base + k, (w >> (8 * (2 - k))) & 0xFF)
    gaps = torch.full((-(-cap // sub),), nbits, dtype=torch.int64, device=dev)
    live = off[::sub]
    gaps[: live.shape[0]] = live
    return stream.to(torch.uint8), nbits, gaps


def decode_section(blob, base_byte: int, gaps, lengths, *, count: int, cap: int,
                   sub: int | None = None, impl=None):
    """Inverse of ``encode_section``: gap-array parallel bitstream decode.

    ``blob`` is a flat uint8 tensor whose bitstream starts at byte
    ``base_byte``; ``gaps`` holds the bit-offset entry points (at least
    ``ceil(count / sub)``).  Each live sub-block decodes ``sub`` codewords
    from its entry point.  Returns ``(cap,)`` uint8 bytes, zero beyond
    ``count``.
    """
    _check_impl(impl)
    sub = (1 << fmt.DEFAULT_SUB_LOG2) if sub is None else sub
    dev = blob.device
    tabs = canonical_tables(lengths, dev)
    nsub = -(-count // sub)
    g = gaps[:nsub].to(torch.int64)
    args = (blob, base_byte + (g >> 3), (g & 7).to(torch.int32),
            tabs["first"], tabs["count"], tabs["base"], tabs["order"])
    if impl == "plain":
        from repro_torch.kernels import lz_entropy

        syms = lz_entropy.huffman_gap_decode_plain(*args, sub=sub)
    else:
        from repro_torch.kernels import ops

        syms = ops.huffman_gap_decode(*args, sub=sub)
    out = torch.zeros(cap, dtype=torch.uint8, device=dev)
    out[:count] = syms.reshape(-1)[:count]
    return out


# ------------------------------------------- container-level hooks (v2)


def _u64(v: int) -> torch.Tensor:
    return torch.frombuffer(bytearray(int(v).to_bytes(8, "little")), dtype=torch.uint8)


def _u32_le(values: torch.Tensor) -> torch.Tensor:
    """(n,) integers below 2**32 -> (4n,) uint8, little-endian u32 each."""
    return values.to(torch.int64).contiguous().view(torch.uint8).reshape(-1, 8)[:, :4].reshape(-1)


def _read_u32(blob: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """(n,) little-endian u32 words at byte ``off`` of ``blob`` -> int64."""
    w = blob[off : off + 4 * n].to(torch.int64).reshape(n, 4)
    return w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)


def _codebook(lengths: np.ndarray) -> torch.Tensor:
    l = np.asarray(lengths, np.int64)
    return torch.from_numpy((l[0::2] | (l[1::2] << 4)).astype(np.uint8))


def compress_entropy(symbols, cfg, orig_bytes=None, *, impl=None):
    """The ``deflate-full`` backend's compress hook.

    Runs the device's LZSS backend for the sections (``torch`` with
    ``impl="plain"``), histograms and entropy-codes both, and assembles a
    method-1 container.  Returns ``(buffer (cap,) uint8, total bytes)``
    with ``cap = format.entropy_max_compressed_bytes`` and zeros beyond
    the total.
    """
    from repro_torch.core import pipeline  # pipeline registers this hook

    _check_impl(impl)
    nc, c = symbols.shape
    s = cfg.symbol_size
    dev = symbols.device
    sub = 1 << fmt.DEFAULT_SUB_LOG2
    orig = nc * c * s if orig_bytes is None else int(orig_bytes)
    lz = pipeline.get_backend("torch" if impl == "plain" else "auto", dev)
    sec = fmt.HEADER_BYTES + 8 * nc
    with trace.span("entropy.lz", dev):
        raw_blobs, _ = pipeline.lzss_many(lz, symbols[None], cfg, [orig])
        raw = raw_blobs[0]
        trace.count("bytes_d2h", fmt.HEADER_BYTES)
        trace.count("host_syncs", 1)
        head = fmt.parse_header(raw[: fmt.HEADER_BYTES].cpu().numpy())
    f_tot, p_tot = head.flag_bytes, head.payload_bytes
    flag_cap, pay_cap = nc * ((c + 7) // 8), nc * c * s

    with trace.span("entropy.histogram", dev):
        hists = torch.stack([
            byte_histogram(raw, sec, f_tot, impl=impl),
            byte_histogram(raw, sec + f_tot, p_tot, impl=impl),
        ])
        trace.count("bytes_d2h", hists.numel() * hists.element_size())
        trace.count("host_syncs", 1)
        hists = hists.cpu().numpy()  # the one 2 KiB device-to-host copy for both sections
    with trace.span("entropy.code_lengths", dev):
        lf = container_code_lengths(hists[0])
        lp = container_code_lengths(hists[1])
    with trace.span("entropy.encode", dev):
        stream_f, fbits, gaps_f = encode_section(raw, sec, f_tot, lf, cap=flag_cap)
        stream_p, pbits, gaps_p = encode_section(raw, sec + f_tot, p_tot, lp, cap=pay_cap)

    with trace.span("entropy.assemble", dev):
        cap2 = fmt.entropy_max_compressed_bytes(nc * c * s, s, c)
        out = torch.zeros(cap2, dtype=torch.uint8, device=dev)
        out[: fmt.HEADER_BYTES] = torch.frombuffer(bytearray(fmt._header_bytes(
            symbol_size=s, window=cfg.window, chunk_symbols=c, n_chunks=nc, orig_bytes=orig,
            payload_total=p_tot, flag_total=f_tot, method=fmt.METHOD_HUFFMAN,
            sub_log2=fmt.DEFAULT_SUB_LOG2,
        )), dtype=torch.uint8)
        out[fmt.HEADER_BYTES : sec] = raw[fmt.HEADER_BYTES : sec]  # the A/B tables
        meta = torch.cat([_codebook(lf), _codebook(lp), _u64(fbits), _u64(pbits)])
        out[sec : sec + fmt.ENTROPY_META_FIXED] = meta.to(dev)
        # the header and the metadata: two pageable copies
        trace.count("bytes_h2d", fmt.HEADER_BYTES + meta.numel())
        trace.count("host_syncs", 2)

        nsub_f, nsub_p = -(-f_tot // sub), -(-p_tot // sub)
        gbase_f = sec + fmt.ENTROPY_META_FIXED
        gbase_p = gbase_f + 4 * nsub_f
        out[gbase_f:gbase_p] = _u32_le(gaps_f[:nsub_f])
        sbase_f = gbase_p + 4 * nsub_p
        out[gbase_p:sbase_f] = _u32_le(gaps_p[:nsub_p])
        fbytes, pbytes = (fbits + 7) // 8, (pbits + 7) // 8
        sbase_p = sbase_f + fbytes
        out[sbase_f:sbase_p] = stream_f[:fbytes]
        out[sbase_p : sbase_p + pbytes] = stream_p[:pbytes]
    return out, sbase_p + pbytes


def decode_blob_entropy(blob, header: fmt.Header, *, impl=None):
    """The ``deflate-full`` decoder's whole-container hook.

    ``blob`` is a flat uint8 tensor holding at least the container's live
    bytes; ``header`` its host-parsed header.  Reads the codebooks (one
    256-byte device-to-host copy), gap-decodes both bitstreams back to the
    compact sections, rebuilds the per-chunk aligned flag / payload arrays
    and hands them to the device's LZSS decoder (``torch-parallel`` with
    ``impl="plain"``).  Returns (nc, C) int32 symbols.
    """
    from repro_torch.core import deflate, pipeline  # pipeline registers this hook

    _check_impl(impl)
    h = header
    c, s, nc = h.chunk_symbols, h.symbol_size, h.n_chunks
    cb = (c + 7) // 8
    sub = 1 << fmt.DEFAULT_SUB_LOG2
    dev = blob.device
    blob = blob.reshape(-1)
    with trace.span("entropy.gap_decode", dev):
        trace.count("bytes_d2h", 256)
        trace.count("host_syncs", 1)
        books = blob[h.sec_meta : h.sec_meta + 256].cpu().numpy().astype(np.int64)
        lf = np.stack([books[:128] & 0xF, books[:128] >> 4], axis=1).reshape(-1)
        lp = np.stack([books[128:] & 0xF, books[128:] >> 4], axis=1).reshape(-1)
        gaps_f = _read_u32(blob, h.sec_gap_flags, h.n_sub_flags)
        gaps_p = _read_u32(blob, h.sec_gap_payload, h.n_sub_payload)
        flag_flat = decode_section(blob, h.sec_stream_flags, gaps_f, lf, count=h.flag_bytes,
                                   cap=nc * cb, sub=sub, impl=impl)
        pay_flat = decode_section(blob, h.sec_stream_payload, gaps_p, lp,
                                  count=h.payload_bytes, cap=nc * c * s, sub=sub, impl=impl)

    with trace.span("entropy.gather", dev):
        n_tokens = _read_u32(blob, h.sec_a, nc)
        fsz = (n_tokens + 7) // 8
        psz = _read_u32(blob, h.sec_b, nc)
        flags = deflate.gather_section(flag_flat, 0, fsz, torch.cumsum(fsz, 0) - fsz, cb)
        payload = deflate.gather_section(pay_flat, 0, psz, torch.cumsum(psz, 0) - psz, c * s)
    dec = pipeline.get_decoder("torch-parallel" if impl == "plain" else "auto", dev)
    with trace.span("entropy.lz", dev):
        return dec.decode(flags, payload, n_tokens.to(torch.int32), symbol_size=s)
