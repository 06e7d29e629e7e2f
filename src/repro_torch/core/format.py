"""GPULZ container format.

Layout (little-endian):

  offset  size        field
  ------  ----        -----
  0       4           magic  b"GPLZ"
  4       1           version (2; version-1 blobs remain readable)
  5       1           symbol_size S (1, 2 or 4)
  6       2           window W (u16, <= 255)
  8       4           chunk_symbols C (u32)
  12      4           n_chunks (u32)
  16      8           orig_bytes (u64)
  24      8           payload_bytes total (u64, RAW/decoded size)
  32      8           flag_bytes total (u64, RAW/decoded size)
  40      1           method: 0 raw LZSS sections, 1 canonical Huffman,
                      2 error-bounded lossy (quantize+bitshuffle+LZSS)
  41      1           sub_log2: gap sub-block size log2 (method 1; else 0)
  42      6           reserved
  48      4*nc        section A: per-chunk token counts (u32)
  +       4*nc        section B: per-chunk payload sizes (u32)

method 0 (raw, the version-1 layout after the tables):

  +       flag_bytes  section C: per-chunk flag arrays, concatenated
  +       payload     section D: per-chunk payloads, concatenated

method 1 (``deflate-full``: sections C/D replaced by canonical-Huffman
bitstreams with gap-array parallel entry points, core/entropy.py):

  +       128         flag codebook: nibble-packed code lengths (sym 2i in
                      the low nibble of byte i, sym 2i+1 in the high)
  +       128         payload codebook, same packing
  +       8           flag_bits (u64): flag bitstream length in bits
  +       8           payload_bits (u64)
  +       4*nsub_f    flag gap array: u32 bit offset of every SUB-th
                      decoded byte's codeword, SUB = 1 << sub_log2,
                      nsub_f = ceil(flag_bytes / SUB)
  +       4*nsub_p    payload gap array, nsub_p = ceil(payload_bytes / SUB)
  +       ...         flag bitstream, ceil(flag_bits / 8) bytes
  +       ...         payload bitstream, ceil(payload_bits / 8) bytes

The flag array + two per-chunk size tables mirror the paper's format (flag
array per §2.2; the two tables are what Kernel II prefix-sums).  Sections C/D
are compact (deflated); A/B let the decoder rebuild every chunk's offsets with
two exclusive prefix sums — decompression needs no sequential parse.  Method-1
containers keep A/B verbatim and store the RAW section sizes in the header, so
the same prefix sums still hold after the bitstreams are gap-decoded.

This module is the PyTorch package's own copy of the reference reader
(``repro/core/format.py``): host-side parsing and validation are numpy, and
``write_header_and_tables`` fills a uint8 tensor on any device.  The bytes
are identical to the reference's for every container below 2**31 bytes,
the bound the port's int32 section offsets impose.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAGIC = (0x47, 0x50, 0x4C, 0x5A)  # "GPLZ"
VERSION = 2
SUPPORTED_VERSIONS = (1, 2)
HEADER_BYTES = 48

METHOD_RAW = 0  # sections C/D are raw LZSS bytes (the version-1 layout)
METHOD_HUFFMAN = 1  # sections C/D are canonical-Huffman bitstreams
METHOD_LOSSY = 2  # error-bounded lossy payload (core/lossy.py)
DEFAULT_SUB_LOG2 = 9  # gap-array sub-block: one entry per 512 decoded bytes
ENTROPY_META_FIXED = 272  # 2 x 128 B codebooks + 2 x 8 B bit counts
SUPPORTED_METHODS = (METHOD_RAW, METHOD_HUFFMAN, METHOD_LOSSY)

# method-2 (lossy-fz) fixed metadata, at ``sec_meta`` where raw section C
# would start (the A/B tables are stored as zeros — the lossy payload has
# no per-chunk sections; the outer geometry describes the *reconstructed*
# f32 element stream):
#
#   +0   u32  error bound, f32 bit pattern (0 => lossless mode)
#   +4   u8   mode: 0 lossless passthrough, 1 quantized
#   +5   u8   quantization ndim (always 1: the flattened element stream)
#   +6   u8   inner container method (0 raw LZSS, 1 deflate-full)
#   +7   u8   reserved
#   +8   u32  n_outliers (quantizer saturation escapes)
#   +12  u32  inner container live bytes
#   +16  u64  n_elems: padded f32 element capacity (n_chunks*chunk_symbols)
#   +24  8B   reserved
#
# then the complete inner container (bitshuffled code stream through the
# lossless backend) at ``sec_lossy_inner``, then ``n_outliers`` 8-byte
# (u32 element index, u32 f32 bit pattern) pairs at ``sec_outliers``.
LOSSY_META_FIXED = 32
LOSSY_MODE_LOSSLESS = 0
LOSSY_MODE_QUANT = 1


@dataclasses.dataclass(frozen=True)
class Header:
    symbol_size: int
    window: int
    chunk_symbols: int
    n_chunks: int
    orig_bytes: int
    payload_bytes: int
    flag_bytes: int
    version: int = VERSION
    method: int = METHOD_RAW
    sub_log2: int = 0
    flag_bits: int = 0
    payload_bits: int = 0
    # method-2 (lossy) metadata, parsed from the fixed block at sec_meta
    lossy_eb_bits: int = 0
    lossy_mode: int = 0
    lossy_ndim: int = 0
    inner_method: int = 0
    n_outliers: int = 0
    inner_total: int = 0
    n_elems: int = 0

    @property
    def sec_a(self) -> int:
        return HEADER_BYTES

    @property
    def sec_b(self) -> int:
        return self.sec_a + 4 * self.n_chunks

    @property
    def sec_flags(self) -> int:
        return self.sec_b + 4 * self.n_chunks

    @property
    def sec_payload(self) -> int:
        return self.sec_flags + self.flag_bytes

    # ------------------------------------ method-1 (entropy) layout
    @property
    def sec_meta(self) -> int:
        """Codebooks + bit counts start where raw section C would."""
        return self.sec_b + 4 * self.n_chunks

    @property
    def n_sub_flags(self) -> int:
        return -(-self.flag_bytes // (1 << self.sub_log2))

    @property
    def n_sub_payload(self) -> int:
        return -(-self.payload_bytes // (1 << self.sub_log2))

    @property
    def sec_gap_flags(self) -> int:
        return self.sec_meta + ENTROPY_META_FIXED

    @property
    def sec_gap_payload(self) -> int:
        return self.sec_gap_flags + 4 * self.n_sub_flags

    @property
    def sec_stream_flags(self) -> int:
        return self.sec_gap_payload + 4 * self.n_sub_payload

    @property
    def sec_stream_payload(self) -> int:
        return self.sec_stream_flags + (self.flag_bits + 7) // 8

    # ------------------------------------- method-2 (lossy) layout
    @property
    def sec_lossy_inner(self) -> int:
        """The complete inner (lossless) container, at a static offset."""
        return self.sec_meta + LOSSY_META_FIXED

    @property
    def sec_outliers(self) -> int:
        """The (u32 idx, u32 f32-bits) outlier pairs, after the inner."""
        return self.sec_lossy_inner + self.inner_total

    @property
    def total_bytes(self) -> int:
        if self.method == METHOD_HUFFMAN:
            return self.sec_stream_payload + (self.payload_bits + 7) // 8
        if self.method == METHOD_LOSSY:
            return self.sec_outliers + 8 * self.n_outliers
        return self.sec_payload + self.payload_bytes


def max_compressed_bytes(n_bytes: int, symbol_size: int, chunk_symbols: int) -> int:
    """Worst-case container size (all-literal chunks)."""
    nsym = -(-n_bytes // symbol_size)
    nc = max(1, -(-nsym // chunk_symbols))
    cb = (chunk_symbols + 7) // 8
    return HEADER_BYTES + 8 * nc + nc * cb + nc * chunk_symbols * symbol_size


def entropy_meta_bytes(
    flag_cap: int, payload_cap: int, sub_log2: int = DEFAULT_SUB_LOG2
) -> int:
    """Method-1 metadata overhead over the raw layout at section capacity."""
    sub = 1 << sub_log2
    return ENTROPY_META_FIXED + 4 * -(-flag_cap // sub) + 4 * -(-payload_cap // sub)


def entropy_max_compressed_bytes(
    n_bytes: int, symbol_size: int, chunk_symbols: int,
    sub_log2: int = DEFAULT_SUB_LOG2,
) -> int:
    """Worst-case method-1 container size.

    The stored-escape in ``entropy.container_code_lengths`` caps each
    bitstream at its raw section size (8 bits/byte), so the worst case is
    the raw worst case plus the fixed metadata + gap arrays — incompressible
    input cannot expand past this bound (tested in tests/test_entropy.py).
    """
    nsym = -(-n_bytes // symbol_size)
    nc = max(1, -(-nsym // chunk_symbols))
    cb = (chunk_symbols + 7) // 8
    return max_compressed_bytes(n_bytes, symbol_size, chunk_symbols) + (
        entropy_meta_bytes(nc * cb, nc * chunk_symbols * symbol_size, sub_log2)
    )


# Inner-container geometry for method-2 payloads: fixed by the wire format
# (core/lossy.py asserts its stage constants agree).  The inner container is
# an S=2 LZSS/deflate-full container over the bitshuffled uint16 unit
# stream; units are padded to whole bitshuffle blocks, then to whole inner
# chunks.
LOSSY_INNER_CHUNK_SYMBOLS = 2048
LOSSY_BLOCK_UNITS = 512  # == core/bitshuffle.py BLOCK_UNITS


def lossy_stream_geometry(n_chunks: int, chunk_symbols: int, mode: int):
    """Static method-2 stream geometry implied by the outer header.

    Returns ``(n_elems, units_pad, inner_n_chunks)``: the padded f32
    element capacity, the bitshuffled uint16 unit count (quant mode codes
    one unit per element; lossless mode stores both halves), and the inner
    container's chunk count.
    """
    n_elems = n_chunks * chunk_symbols
    units = n_elems if mode == LOSSY_MODE_QUANT else 2 * n_elems
    units_pad = -(-units // LOSSY_BLOCK_UNITS) * LOSSY_BLOCK_UNITS
    inner_nc = max(1, -(-units_pad // LOSSY_INNER_CHUNK_SYMBOLS))
    return n_elems, units_pad, inner_nc


def lossy_inner_capacity(inner_nc: int, inner_method: int) -> int:
    """Worst-case byte capacity of a method-2 payload's inner container."""
    nbytes = inner_nc * LOSSY_INNER_CHUNK_SYMBOLS * 2
    if inner_method == METHOD_HUFFMAN:
        return entropy_max_compressed_bytes(
            nbytes, 2, LOSSY_INNER_CHUNK_SYMBOLS
        )
    return max_compressed_bytes(nbytes, 2, LOSSY_INNER_CHUNK_SYMBOLS)


def lossy_max_compressed_bytes(n_bytes: int, chunk_symbols: int) -> int:
    """Worst-case method-2 container size for ``n_bytes`` of f32 input.

    Upper-bounds both modes: the lossless-mode inner stream (two units per
    element, entropy metadata included — a superset of the quant-mode inner
    capacity) plus the quant-mode worst case of every element escaping as
    an 8-byte outlier pair.
    """
    n_elems = -(-n_bytes // 4)
    nc = max(1, -(-n_elems // chunk_symbols))
    cap_elems, _, inner_nc = lossy_stream_geometry(
        nc, chunk_symbols, LOSSY_MODE_LOSSLESS
    )
    return (
        HEADER_BYTES
        + 8 * nc
        + LOSSY_META_FIXED
        + lossy_inner_capacity(inner_nc, METHOD_HUFFMAN)
        + 8 * cap_elems
    )


def _header_bytes(*, symbol_size, window, chunk_symbols, n_chunks,
                  orig_bytes, payload_total, flag_total, method, sub_log2):
    """The 48 header bytes for host-int field values."""
    return (
        bytes(MAGIC)
        + bytes([VERSION, symbol_size])
        + window.to_bytes(2, "little")
        + chunk_symbols.to_bytes(4, "little")
        + n_chunks.to_bytes(4, "little")
        + orig_bytes.to_bytes(8, "little")
        + payload_total.to_bytes(8, "little")
        + flag_total.to_bytes(8, "little")
        + bytes([method, sub_log2])
        + bytes(6)
    )


def write_header_and_tables(out, *, symbol_size, window, chunk_symbols,
                            n_chunks, orig_bytes, payload_total, flag_total,
                            n_tokens, payload_sizes,
                            method=METHOD_RAW, sub_log2=0):
    """Fill header + sections A/B of the flat uint8 tensor ``out`` in place.

    The scalar fields are host ints; ``n_tokens`` / ``payload_sizes`` are
    (n_chunks,) integer tensors on ``out``'s device, written as u32
    little-endian.  Returns ``out``.
    """
    head = _header_bytes(
        symbol_size=symbol_size, window=window, chunk_symbols=chunk_symbols,
        n_chunks=n_chunks, orig_bytes=int(orig_bytes),
        payload_total=int(payload_total), flag_total=int(flag_total),
        method=int(method), sub_log2=int(sub_log2),
    )
    out[:HEADER_BYTES] = torch.frombuffer(bytearray(head), dtype=torch.uint8)
    sec_a = HEADER_BYTES
    sec_b = sec_a + 4 * n_chunks
    for base, table in ((sec_a, n_tokens), (sec_b, payload_sizes)):
        words = torch.empty(n_chunks, dtype=torch.int32, device=out.device)
        words.copy_(table.reshape(n_chunks))  # unit stride for the byte view
        out[base : base + 4 * n_chunks] = words.view(torch.uint8)
    return out


def parse_header(blob: np.ndarray) -> Header:
    """Host-side header parse (numpy uint8 array)."""
    blob = np.asarray(blob, np.uint8)
    if blob.size < HEADER_BYTES:
        # before any field access: a chopped prefix can keep a valid magic
        # (blob[:4]) and then index out of bounds on the fixed fields
        raise ValueError(
            f"truncated container: the header alone is {HEADER_BYTES} bytes "
            f"but only {blob.size} bytes are present"
        )
    if tuple(int(b) for b in blob[:4]) != MAGIC:
        raise ValueError("bad magic: not a GPULZ container")
    version = int(blob[4])
    if version not in SUPPORTED_VERSIONS:
        raise ValueError(
            f"unsupported version: container declares version {version} but "
            f"this reader expects one of {SUPPORTED_VERSIONS}"
        )

    def u(lo, n):
        return int.from_bytes(bytes(blob[lo : lo + n]), "little")

    # version 1 predates the method byte: bytes 40-47 were reserved zeros
    method = int(blob[40]) if version >= 2 else METHOD_RAW
    sub_log2 = int(blob[41]) if version >= 2 else 0
    if method not in SUPPORTED_METHODS:
        raise ValueError(
            f"corrupted container: method byte {method} not in "
            f"{SUPPORTED_METHODS}"
        )
    h = Header(
        symbol_size=int(blob[5]),
        window=u(6, 2),
        chunk_symbols=u(8, 4),
        n_chunks=u(12, 4),
        orig_bytes=u(16, 8),
        payload_bytes=u(24, 8),
        flag_bytes=u(32, 8),
        version=version,
        method=method,
        sub_log2=sub_log2,
    )
    if method == METHOD_HUFFMAN:
        need = h.sec_meta + ENTROPY_META_FIXED
        if blob.size < need:
            raise ValueError(
                f"truncated container: method-1 metadata ends at byte {need} "
                f"but only {blob.size} bytes are present"
            )
        h = dataclasses.replace(
            h,
            flag_bits=u(h.sec_meta + 256, 8),
            payload_bits=u(h.sec_meta + 264, 8),
        )
    if method == METHOD_LOSSY:
        need = h.sec_meta + LOSSY_META_FIXED
        if blob.size < need:
            raise ValueError(
                f"truncated container: method-2 metadata ends at byte {need} "
                f"but only {blob.size} bytes are present"
            )
        m = h.sec_meta
        h = dataclasses.replace(
            h,
            lossy_eb_bits=u(m, 4),
            lossy_mode=int(blob[m + 4]),
            lossy_ndim=int(blob[m + 5]),
            inner_method=int(blob[m + 6]),
            n_outliers=u(m + 8, 4),
            inner_total=u(m + 12, 4),
            n_elems=u(m + 16, 8),
        )
    return h


def parse_tables(blob: np.ndarray, header: Header):
    """Host-side sections A/B parse -> (n_tokens, payload_sizes) uint32."""
    blob = np.asarray(blob, np.uint8)
    nc = header.n_chunks
    a = blob[header.sec_a : header.sec_a + 4 * nc].view(np.uint32).copy()
    b = blob[header.sec_b : header.sec_b + 4 * nc].view(np.uint32).copy()
    return a.astype(np.int32), b.astype(np.int32)


def validate_container(blob: np.ndarray, header: Header | None = None):
    """Host-side sanity check before a blob is handed to the decoder.

    The decode path is bounds-checked but *silent*: a truncated or
    table-corrupted container would decode to garbage symbols instead of
    failing.  This raises a ``ValueError`` naming the expected vs actual
    byte counts (or the offending table entry) first.  Returns the parsed
    ``(header, n_tokens, payload_sizes)`` so callers don't parse twice.

    Header-geometry corruption detection is best-effort: the checks catch
    every truncation, out-of-range field and table inconsistency, but a
    flipped field whose corrupted value describes a *different valid
    container over the same tables* (e.g. symbol_size 2 -> 4 when every
    chunk is all-pointers) is indistinguishable without decoding — that is
    what the containers' checksummed transport (checkpoint files, KV
    store) is for.
    """
    blob = np.asarray(blob, np.uint8)
    h = parse_header(blob) if header is None else header
    # geometry fields first: a flipped header byte (e.g. symbol_size 1->2)
    # passes every byte-count cross-check below and would decode to silent
    # garbage; re-apply the write-side invariants
    if h.symbol_size not in (1, 2, 4):
        raise ValueError(
            f"corrupted container: symbol_size {h.symbol_size} not in (1, 2, 4)"
        )
    if not 1 <= h.window <= 255:
        raise ValueError(
            f"corrupted container: window {h.window} not in [1, 255]"
        )
    if h.chunk_symbols <= 0 or h.chunk_symbols % 8:
        raise ValueError(
            f"corrupted container: chunk_symbols {h.chunk_symbols} is not a "
            f"positive multiple of 8"
        )
    if h.n_chunks < 1:
        raise ValueError(f"corrupted container: n_chunks {h.n_chunks} < 1")
    if blob.size < h.total_bytes:
        raise ValueError(
            f"truncated container: header declares {h.total_bytes} bytes "
            f"({HEADER_BYTES} header + {8 * h.n_chunks} tables + "
            f"{h.flag_bytes} flags + {h.payload_bytes} payload) but only "
            f"{blob.size} bytes are present"
        )
    n_tokens, payload_sizes = parse_tables(blob, h)
    c, s = h.chunk_symbols, h.symbol_size
    for name, table, cap in (
        ("n_tokens", n_tokens, c),
        ("payload_sizes", payload_sizes, c * s),
    ):
        bad = np.nonzero((table < 0) | (table > cap))[0]
        if bad.size:
            i = int(bad[0])
            raise ValueError(
                f"corrupted container: table {name}[{i}] = {int(table[i])} "
                f"exceeds the per-chunk bound {cap} "
                f"(C={c}, S={s})"
            )
    # per-chunk token/byte consistency: a chunk's payload is 2 bytes per
    # pointer + S per literal, so min(2, S)*n_tokens <= payload_sizes <=
    # max(2, S)*n_tokens must hold chunk-wise.  This is what actually trips
    # on a flipped symbol_size byte (e.g. 1 -> 2 forces equality at
    # 2*n_tokens, which real mixed chunks don't satisfy) — the membership
    # checks above can't, because {1, 2, 4} are all legal values.
    lo_b = min(2, s) * n_tokens
    hi_b = max(2, s) * n_tokens
    bad = np.nonzero((payload_sizes < lo_b) | (payload_sizes > hi_b))[0]
    if bad.size:
        i = int(bad[0])
        raise ValueError(
            f"corrupted container: chunk {i} has payload_sizes={int(payload_sizes[i])} "
            f"outside [{int(lo_b[i])}, {int(hi_b[i])}] implied by "
            f"n_tokens={int(n_tokens[i])} and symbol_size={s}"
        )
    flag_total = int(((n_tokens + 7) // 8).sum())
    pay_total = int(payload_sizes.sum())
    if flag_total != h.flag_bytes or pay_total != h.payload_bytes:
        raise ValueError(
            f"corrupted container: header declares {h.flag_bytes} flag + "
            f"{h.payload_bytes} payload bytes but the per-chunk tables sum "
            f"to {flag_total} + {pay_total}"
        )
    if h.orig_bytes > h.n_chunks * c * s:
        raise ValueError(
            f"corrupted container: orig_bytes {h.orig_bytes} exceeds the "
            f"chunk capacity {h.n_chunks * c * s} "
            f"(n_chunks={h.n_chunks}, C={c}, S={s})"
        )
    if h.method == METHOD_HUFFMAN:
        _validate_entropy_sections(blob, h)
    if h.method == METHOD_LOSSY:
        _validate_lossy_sections(blob, h)
    return h, n_tokens, payload_sizes


def _validate_entropy_sections(blob: np.ndarray, h: Header) -> None:
    """Method-1 cross-checks: codebooks, bit counts, gap arrays.

    The gap decoder clips every bitstream access, so a corrupted
    gap entry or oversubscribed codebook decodes to silent garbage; this
    raises first.  ``parse_header`` already guaranteed the fixed metadata
    is present and the caller checked ``total_bytes`` truncation.
    """
    if h.sub_log2 != DEFAULT_SUB_LOG2:
        raise ValueError(
            f"unsupported container: gap sub-block log2 {h.sub_log2}; this "
            f"reader supports only {DEFAULT_SUB_LOG2} "
            f"(sub-block {1 << DEFAULT_SUB_LOG2} bytes)"
        )
    for name, bits, raw in (
        ("flag", h.flag_bits, h.flag_bytes),
        ("payload", h.payload_bits, h.payload_bytes),
    ):
        if bits > 8 * raw:
            raise ValueError(
                f"corrupted container: {name} bitstream declares {bits} bits "
                f"for {raw} decoded bytes — the stored escape caps it at "
                f"{8 * raw}"
            )
    for name, base, raw in (
        ("flag", h.sec_meta, h.flag_bytes),
        ("payload", h.sec_meta + 128, h.payload_bytes),
    ):
        packed = blob[base : base + 128].astype(np.int64)
        lens = np.stack([packed & 0xF, packed >> 4], axis=1).reshape(-1)
        kraft = int(np.where(lens > 0, 1 << (15 - lens), 0).sum())
        if kraft > 1 << 15:
            raise ValueError(
                f"corrupted container: {name} codebook oversubscribes the "
                f"code space (Kraft sum {kraft} > {1 << 15})"
            )
        if raw > 0 and kraft == 0:
            raise ValueError(
                f"corrupted container: {name} codebook is empty but the "
                f"section decodes {raw} bytes"
            )
    for name, base, nsub, bits in (
        ("flag", h.sec_gap_flags, h.n_sub_flags, h.flag_bits),
        ("payload", h.sec_gap_payload, h.n_sub_payload, h.payload_bits),
    ):
        gaps = blob[base : base + 4 * nsub].view(np.uint32).astype(np.int64)
        if nsub and gaps[0] != 0:
            raise ValueError(
                f"corrupted container: {name} gap array starts at bit "
                f"{int(gaps[0])}, expected 0"
            )
        if (np.diff(gaps) < 0).any() or (gaps >= max(bits, 1)).any():
            raise ValueError(
                f"corrupted container: {name} gap array is not a monotone "
                f"sequence of entry points below the {bits}-bit stream"
            )


def _validate_lossy_sections(blob: np.ndarray, h: Header) -> None:
    """Method-2 cross-checks: metadata fields, inner container, outliers.

    The lossy decoder clips every access, so corrupted metadata
    decodes to silent garbage; this raises first.  The inner container is
    validated recursively — it is a complete container with its own header,
    tables and (for a deflate-full inner) entropy metadata.
    """
    if h.symbol_size != 4:
        raise ValueError(
            f"corrupted container: method-2 payloads reconstruct f32 "
            f"elements (symbol_size 4), header declares {h.symbol_size}"
        )
    if h.lossy_mode not in (LOSSY_MODE_LOSSLESS, LOSSY_MODE_QUANT):
        raise ValueError(
            f"corrupted container: lossy mode byte {h.lossy_mode} not in "
            f"({LOSSY_MODE_LOSSLESS}, {LOSSY_MODE_QUANT})"
        )
    if h.lossy_ndim != 1:
        raise ValueError(
            f"unsupported container: lossy quantization ndim "
            f"{h.lossy_ndim}; this reader supports only 1"
        )
    if h.inner_method not in (METHOD_RAW, METHOD_HUFFMAN):
        raise ValueError(
            f"corrupted container: lossy inner method byte "
            f"{h.inner_method} not in ({METHOD_RAW}, {METHOD_HUFFMAN})"
        )
    n_elems, _, inner_nc = lossy_stream_geometry(
        h.n_chunks, h.chunk_symbols, h.lossy_mode
    )
    if h.n_elems != n_elems:
        raise ValueError(
            f"corrupted container: lossy n_elems {h.n_elems} does not "
            f"match the geometry-implied capacity {n_elems} "
            f"(n_chunks={h.n_chunks}, C={h.chunk_symbols})"
        )
    if h.lossy_mode == LOSSY_MODE_QUANT:
        eb = np.uint32(h.lossy_eb_bits).view(np.float32)
        if not np.isfinite(eb) or eb <= 0:
            raise ValueError(
                f"corrupted container: quant-mode error bound {eb} "
                f"(bits 0x{h.lossy_eb_bits:08x}) is not a positive finite "
                f"f32"
            )
        if h.n_outliers > n_elems:
            raise ValueError(
                f"corrupted container: {h.n_outliers} outlier pairs exceed "
                f"the element capacity {n_elems}"
            )
    elif h.n_outliers:
        raise ValueError(
            f"corrupted container: lossless-mode payload declares "
            f"{h.n_outliers} outlier pairs, expected 0"
        )
    if h.inner_total > lossy_inner_capacity(inner_nc, h.inner_method):
        raise ValueError(
            f"corrupted container: inner container declares "
            f"{h.inner_total} bytes, above the worst-case capacity "
            f"{lossy_inner_capacity(inner_nc, h.inner_method)}"
        )
    inner = blob[h.sec_lossy_inner : h.sec_lossy_inner + h.inner_total]
    ih, _, _ = validate_container(inner)
    if (
        ih.method != h.inner_method
        or ih.symbol_size != 2
        or ih.chunk_symbols != LOSSY_INNER_CHUNK_SYMBOLS
        or ih.n_chunks != inner_nc
    ):
        raise ValueError(
            f"corrupted container: inner container geometry (method="
            f"{ih.method}, S={ih.symbol_size}, C={ih.chunk_symbols}, "
            f"nc={ih.n_chunks}) does not match the outer header "
            f"(method={h.inner_method}, S=2, "
            f"C={LOSSY_INNER_CHUNK_SYMBOLS}, nc={inner_nc})"
        )
    pairs = blob[h.sec_outliers : h.sec_outliers + 8 * h.n_outliers]
    idx = pairs.reshape(-1, 8)[:, :4].copy().view(np.uint32).reshape(-1)
    if idx.size and int(idx.max()) >= n_elems:
        raise ValueError(
            f"corrupted container: outlier index {int(idx.max())} exceeds "
            f"the element capacity {n_elems}"
        )
