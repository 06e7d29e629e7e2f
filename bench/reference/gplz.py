"""A plain decoder of GPULZ containers (format v2: methods 0, 1 and 2).

Written from the format's description alone, in NumPy (the header) and
plain PyTorch (the sections), so that it runs on the card after a run's
window and checks what the program stored.  It shares no code with the
program.  Every inconsistency it can see raises ``ContainerError``.

Layout (little-endian): a 48-byte header (magic ``GPLZ``, version, S, W,
C, n_chunks, orig_bytes, payload_bytes, flag_bytes, method, sub_log2),
then per-chunk token counts (u32) and payload sizes (u32).

* method 0: the flag section (a chunk's flags ``ceil(n_tokens / 8)``
  bytes, bit ``t % 8`` of byte ``t // 8`` is token ``t``: 1 a pointer),
  then the payload section (a literal is S bytes, a pointer is
  ``[length, offset]``: the next ``length`` symbols copy those ``offset``
  symbols back, inside the chunk).  Every chunk decodes to C symbols; the
  output is the first ``orig_bytes`` bytes.
* method 1: the two sections as canonical-Huffman bitstreams (MSB first)
  over bytes: two nibble-packed 256-entry code-length books, the two bit
  counts (u64), the two gap arrays (u32 bit offset of every ``2**sub_log2``-th
  codeword), then the streams.
* method 2 (lossy-fz): 32 bytes of metadata after the tables (eb bits,
  mode, ndim, inner method, outlier count, inner bytes, element count),
  the inner S=2 container (method 0 or 1, C=2048) of a bitshuffled u16
  unit stream (blocks of 512 units, 16 planes of 64 bytes, bit ``b`` of
  unit ``8 j + k`` in bit ``k`` of byte ``j`` of plane ``b``), then the
  outliers as (u32 index, u32 f32 bits) pairs.  In quant mode a unit is a
  Lorenzo delta centred at 32768; the decoder integrates it, repairs the
  chain after each outlier from the outlier's own pre-quantization, and
  multiplies by ``2 eb`` in float32; in lossless mode two units are an
  element's halves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAGIC = b"GPLZ"
HEADER_BYTES = 48
ENTROPY_META = 272
LOSSY_META = 32
BLOCK_UNITS = 512
INNER_C = 2048
CENTER = 1 << 15
MAX_CODE_LEN = 15
_INT30 = 2.0**30


class ContainerError(ValueError):
    """The bytes are not a consistent container."""


def _need(cond, what):
    if not cond:
        raise ContainerError(what)


def _u(blob: np.ndarray, off: int, n: int) -> int:
    _need(off + n <= blob.size, f"container ends inside a field at byte {off}")
    return int.from_bytes(blob[off : off + n].tobytes(), "little")


def parse_header(blob: np.ndarray) -> dict:
    """The header's fields and section offsets; checks what it can."""
    _need(blob.size >= HEADER_BYTES, "shorter than the header")
    _need(blob[:4].tobytes() == MAGIC, "bad magic")
    h = dict(
        version=int(blob[4]), S=int(blob[5]), W=_u(blob, 6, 2), C=_u(blob, 8, 4),
        nc=_u(blob, 12, 4), orig=_u(blob, 16, 8), payload=_u(blob, 24, 8),
        flags=_u(blob, 32, 8), method=int(blob[40]), sub_log2=int(blob[41]),
    )
    _need(h["version"] in (1, 2), f"version {h['version']}")
    _need(h["S"] in (1, 2, 4), f"symbol size {h['S']}")
    _need(h["C"] > 0 and h["C"] % 8 == 0 and h["nc"] > 0, "chunk geometry")
    _need(h["orig"] <= h["nc"] * h["C"] * h["S"], "orig_bytes past the chunks")
    _need(h["method"] in (0, 1, 2), f"method {h['method']}")
    h["sec_tables"] = HEADER_BYTES
    h["sec_meta"] = HEADER_BYTES + 8 * h["nc"]
    _need(blob.size >= h["sec_meta"], "container ends inside the tables")
    return h


def _tables(blob: np.ndarray, h: dict, device):
    nc = h["nc"]
    t = blob[HEADER_BYTES : HEADER_BYTES + 8 * nc].view("<u4").astype(np.int64)
    return torch.from_numpy(t[:nc]).to(device), torch.from_numpy(t[nc:]).to(device)


def _excl(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def decode_sections(flags: torch.Tensor, payload: torch.Tensor, n_tokens: torch.Tensor,
                    pay_sizes: torch.Tensor, *, S: int, C: int, W: int) -> torch.Tensor:
    """Compact flag and payload sections -> (nc * C,) int64 symbols."""
    dev = flags.device
    nc = n_tokens.shape[0]
    fsz = (n_tokens + 7) // 8
    _need(int(fsz.sum()) == flags.numel(), "flag section size")
    _need(int(pay_sizes.sum()) == payload.numel(), "payload section size")
    _need(bool((n_tokens >= 1).all()) and bool((n_tokens <= C).all()), "token counts")
    T = int(n_tokens.sum())
    chunk = torch.repeat_interleave(torch.arange(nc, device=dev), n_tokens)
    tok0 = _excl(n_tokens)
    rank = torch.arange(T, device=dev) - tok0[chunk]
    fb = flags.to(torch.int64)
    bit = (fb[_excl(fsz)[chunk] + rank // 8] >> (rank % 8)) & 1
    size = torch.where(bit == 1, 2, S)

    def local(v):  # exclusive prefix sum of v inside each token's chunk
        ex = _excl(v)
        return ex - ex[tok0[chunk]]

    used = torch.zeros(nc, dtype=torch.int64, device=dev).index_add_(0, chunk, size)
    _need(bool(torch.equal(used, pay_sizes)), "payload sizes disagree with the tokens")
    addr = _excl(pay_sizes)[chunk] + local(size)
    pay = torch.cat([payload.to(torch.int64), torch.zeros(4, dtype=torch.int64, device=dev)])
    ln = torch.where(bit == 1, pay[addr], 1)
    off = torch.where(bit == 1, pay[addr + 1], 0)
    lit = torch.zeros(T, dtype=torch.int64, device=dev)
    for b in range(S):
        lit |= pay[addr + b] << (8 * b)
    lit = torch.where(bit == 1, 0, lit)
    _need(bool((ln >= 1).all()), "a pointer of length 0")
    out_len = torch.zeros(nc, dtype=torch.int64, device=dev).index_add_(0, chunk, ln)
    _need(bool((out_len == C).all()), "a chunk does not decode to C symbols")
    wstart = local(ln)
    ptr = bit == 1
    _need(bool(((off >= 1) & (off <= W) & (wstart - off >= 0))[ptr].all()),
          "a pointer outside its window or chunk")
    n = nc * C
    mark = torch.zeros(n, dtype=torch.int64, device=dev)
    mark[chunk * C + wstart] = 1
    tok = torch.cumsum(mark, 0) - 1
    p = torch.arange(n, device=dev)
    src = torch.where(ptr[tok], p - off[tok], p)
    for _ in range(math.ceil(math.log2(C)) + 1):
        src = src[src]
    _need(not bool(ptr[tok[src]].any()), "a copy chain that does not end at a literal")
    return lit[tok[src]]


def _symbols_to_bytes(sym: torch.Tensor, S: int) -> torch.Tensor:
    parts = [((sym >> (8 * b)) & 0xFF) for b in range(S)]
    return torch.stack(parts, 1).reshape(-1).to(torch.uint8)


def _code_lengths(book: np.ndarray) -> np.ndarray:
    b = book.astype(np.int64)
    return np.stack([b & 0xF, b >> 4], 1).reshape(-1)


def _decode_table(lengths: np.ndarray):
    """(2**15,) symbol and code length of every 15-bit window (length 0:
    no codeword starts so)."""
    live = np.nonzero(lengths)[0]
    sym_t = np.zeros(1 << MAX_CODE_LEN, np.int64)
    len_t = np.zeros(1 << MAX_CODE_LEN, np.int64)
    if live.size == 0:
        return sym_t, len_t
    order = sorted(live.tolist(), key=lambda s: (lengths[s], s))
    code, prev = 0, int(lengths[order[0]])
    for i, s in enumerate(order):
        ln = int(lengths[s])
        if i:
            code = (code + 1) << (ln - prev)
        prev = ln
        _need(code < (1 << ln), "over-full code lengths")
        lo = code << (MAX_CODE_LEN - ln)
        hi = (code + 1) << (MAX_CODE_LEN - ln)
        sym_t[lo:hi] = s
        len_t[lo:hi] = ln
    return sym_t, len_t


def huffman_section(stream: torch.Tensor, nbits: int, gaps: torch.Tensor, lengths: np.ndarray,
                    count: int, sub: int) -> torch.Tensor:
    """Decode ``count`` bytes from an MSB-first canonical-Huffman stream,
    each sub-block of ``sub`` codewords from its gap-array entry point."""
    dev = stream.device
    if count == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    sym_t, len_t = (torch.from_numpy(t).to(dev) for t in _decode_table(lengths))
    nsub = -(-count // sub)
    _need(gaps.numel() == nsub, "gap array size")
    s = torch.cat([stream.to(torch.int64), torch.zeros(4, dtype=torch.int64, device=dev)])
    pos = gaps.clone()
    _need(bool((pos >= 0).all()) and bool((pos <= nbits).all()), "gap entry past the stream")
    live = count - torch.arange(nsub, device=dev) * sub  # codewords left in each sub-block
    out = torch.zeros((nsub, sub), dtype=torch.int64, device=dev)
    bad = torch.zeros(nsub, dtype=torch.bool, device=dev)
    for j in range(sub):
        byte = pos >> 3
        w = (s[byte] << 16) | (s[byte + 1] << 8) | s[byte + 2]
        win = (w >> (24 - MAX_CODE_LEN - (pos & 7))) & ((1 << MAX_CODE_LEN) - 1)
        ln = len_t[win]
        on = live > j
        bad |= on & (ln == 0)
        out[:, j] = sym_t[win]
        pos = torch.where(on, pos + ln, pos)
    _need(not bool(bad.any()), "a window that starts no codeword")
    ends = torch.cat([gaps[1:], torch.tensor([nbits], device=dev)])
    _need(bool(torch.equal(pos, ends)), "sub-blocks do not meet their neighbours' entry points")
    return out.reshape(-1)[:count].to(torch.uint8)


def _sections(blob: np.ndarray, h: dict, device):
    """(flags, payload) compact sections of a method-0 or method-1 container,
    and the container's length as its header describes it."""
    base = h["sec_meta"]
    if h["method"] == 0:
        end = base + h["flags"] + h["payload"]
        _need(blob.size >= end, "container shorter than its sections")
        t = torch.from_numpy(blob[base:end].copy()).to(device)
        return t[: h["flags"]], t[h["flags"] :], end
    sub = 1 << h["sub_log2"]
    _need(h["sub_log2"] > 0, "entropy container without a sub-block size")
    books = blob[base : base + 256]
    fbits, pbits = _u(blob, base + 256, 8), _u(blob, base + 264, 8)
    nsf, nsp = -(-h["flags"] // sub), -(-h["payload"] // sub)
    g0 = base + ENTROPY_META
    s0 = g0 + 4 * (nsf + nsp)
    s1 = s0 + (fbits + 7) // 8
    end = s1 + (pbits + 7) // 8
    _need(blob.size >= end, "container shorter than its streams")
    gaps = blob[g0:s0].view("<u4").astype(np.int64)
    g = torch.from_numpy(gaps).to(device)
    st = torch.from_numpy(blob[s0:end].copy()).to(device)
    flags = huffman_section(st[: s1 - s0], fbits, g[:nsf], _code_lengths(books[:128]),
                            h["flags"], sub)
    payload = huffman_section(st[s1 - s0 :], pbits, g[nsf:], _code_lengths(books[128:]),
                              h["payload"], sub)
    return flags, payload, end


def _lossless_symbols(blob: np.ndarray, h: dict, device):
    """(nc * C,) int64 symbols of a method-0/1 container and its length."""
    flags, payload, end = _sections(blob, h, device)
    n_tokens, pay_sizes = _tables(blob, h, device)
    sym = decode_sections(flags, payload, n_tokens, pay_sizes, S=h["S"], C=h["C"], W=h["W"])
    return sym, end


def bitunshuffle(shuffled: torch.Tensor) -> torch.Tensor:
    """(2N,) uint8 bit planes -> (N,) int64 u16 units."""
    planes = shuffled.to(torch.int64).reshape(-1, 16, 64)  # block, plane, byte
    k = torch.arange(8, device=shuffled.device)
    bits = (planes[..., None] >> k) & 1  # block, plane, byte, bit-in-byte
    bits = bits.permute(0, 2, 3, 1).reshape(-1, 16)  # unit 8 j + k, plane
    return (bits << torch.arange(16, device=shuffled.device)).sum(1)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    return torch.remainder(v + (1 << 31), 1 << 32) - (1 << 31)


def prequant(x: torch.Tensor, rcp: np.float32) -> torch.Tensor:
    """int64 pre-quantization ``round(x * rcp)`` in float32, NaN as 0,
    clipped to +-2**30."""
    qf = torch.round(x * torch.tensor(rcp, dtype=torch.float32, device=x.device))
    qf = torch.where(torch.isnan(qf), 0.0, qf)
    return torch.clamp(qf, -_INT30, _INT30).to(torch.int64)


def _lossy_bytes(blob: np.ndarray, h: dict, device):
    m = h["sec_meta"]
    eb_bits, mode, ndim, inner_method = _u(blob, m, 4), int(blob[m + 4]), int(blob[m + 5]), int(blob[m + 6])
    n_out, inner_total, n_elems = _u(blob, m + 8, 4), _u(blob, m + 12, 4), _u(blob, m + 16, 8)
    _need(h["S"] == 4 and mode in (0, 1) and ndim == 1, "lossy metadata")
    _need(n_elems == h["nc"] * h["C"], "element count")
    units = n_elems if mode == 1 else 2 * n_elems
    units_pad = -(-units // BLOCK_UNITS) * BLOCK_UNITS
    i0 = m + LOSSY_META
    _need(blob.size >= i0 + inner_total, "container shorter than its inner container")
    inner = blob[i0 : i0 + inner_total]
    ih = parse_header(inner)
    _need((ih["S"], ih["C"], ih["method"]) == (2, INNER_C, inner_method), "inner geometry")
    _need(ih["nc"] * INNER_C >= units_pad, "inner container too small")
    sym, inner_end = _lossless_symbols(inner, ih, device)
    _need(inner_end == inner_total, "inner container length")
    ub = _symbols_to_bytes(sym, 2)[: 2 * units_pad]
    u = bitunshuffle(ub)
    end = i0 + inner_total + 8 * n_out
    _need(blob.size >= end, "container shorter than its outliers")
    if mode == 0:
        halves = u[: 2 * n_elems].reshape(-1, 2)
        bits = halves[:, 0] | (halves[:, 1] << 16)
        return _symbols_to_bytes(bits, 4), end
    eb = np.uint32(eb_bits).view(np.float32)
    eb2 = np.float32(2.0) * eb
    rcp = np.float32(1.0) / eb2
    q = _wrap32(torch.cumsum(u[:n_elems] - CENTER, 0))
    pairs = blob[i0 + inner_total : end].view("<u4").astype(np.int64).reshape(-1, 2)
    oidx = torch.from_numpy(pairs[:, 0]).to(device)
    obits = torch.from_numpy(pairs[:, 1]).to(device)
    _need(bool((oidx < n_elems).all()) and bool((oidx[1:] > oidx[:-1]).all()),
          "outlier indices not ascending inside the stream")
    if n_out:
        oval = _wrap32(obits).to(torch.int32).view(torch.float32)
        adj = torch.zeros(n_elems, dtype=torch.int64, device=device)
        adj[oidx] = _wrap32(prequant(oval, rcp) - q[oidx])
        mark = torch.full((n_elems,), -1, dtype=torch.int64, device=device)
        mark[oidx] = oidx
        last = torch.cummax(mark, 0).values
        q = _wrap32(q + torch.where(last >= 0, adj[last.clamp(min=0)], 0))
    x = q.to(torch.int32).to(torch.float32) * torch.tensor(eb2, dtype=torch.float32, device=device)
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if n_out:
        bits[oidx] = obits
    return _symbols_to_bytes(bits, 4), end


def decode(blob, device="cpu") -> torch.Tensor:
    """The original bytes of one container: a (orig_bytes,) uint8 tensor on
    ``device``.  Raises ``ContainerError`` when the container is not
    consistent or its length is not the one its header describes."""
    blob = np.ascontiguousarray(np.asarray(blob, np.uint8).reshape(-1))
    h = parse_header(blob)
    if h["method"] == 2:
        out, end = _lossy_bytes(blob, h, device)
    else:
        sym, end = _lossless_symbols(blob, h, device)
        out = _symbols_to_bytes(sym, h["S"])
    _need(end == blob.size, f"container is {blob.size} bytes, its header describes {end}")
    return out[: h["orig"]]


def decode_many(blobs, device="cpu") -> list:
    """``decode`` of each container of ``blobs``: a list with, for each, its
    bytes or the ``ContainerError`` that refuses it.  The method-0
    containers of one geometry decode together, their chunks in one pass of
    ``decode_sections``, after each container's own sizes are checked; where
    that pass refuses, each container of the group decodes alone."""
    out = [None] * len(blobs)
    groups = {}
    for i, b in enumerate(blobs):
        b = np.ascontiguousarray(np.asarray(b, np.uint8).reshape(-1))
        try:
            h = parse_header(b)
            if h["method"] != 0:
                out[i] = decode(b, device)
                continue
            t = b[HEADER_BYTES : HEADER_BYTES + 8 * h["nc"]].view("<u4").astype(np.int64)
            _need(int(((t[: h["nc"]] + 7) // 8).sum()) == h["flags"], "flag section size")
            _need(int(t[h["nc"] :].sum()) == h["payload"], "payload section size")
            end = h["sec_meta"] + h["flags"] + h["payload"]
            _need(end == b.size, f"container is {b.size} bytes, its header describes {end}")
        except ContainerError as e:
            out[i] = e
            continue
        groups.setdefault((h["S"], h["C"], h["W"]), []).append((i, b, h, t))
    for (S, C, W), members in groups.items():
        cat = np.concatenate
        flags = cat([b[h["sec_meta"] : h["sec_meta"] + h["flags"]] for _, b, h, _ in members])
        payload = cat([b[h["sec_meta"] + h["flags"] :] for _, b, h, _ in members])
        n_tokens = cat([t[: h["nc"]] for _, _, h, t in members])
        pay_sizes = cat([t[h["nc"] :] for _, _, h, t in members])
        to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        try:
            sym = decode_sections(to(flags), to(payload), to(n_tokens), to(pay_sizes),
                                  S=S, C=C, W=W)
        except ContainerError:
            for i, b, _, _ in members:
                try:
                    out[i] = decode(b, device)
                except ContainerError as e:
                    out[i] = e
            continue
        at = 0
        for i, _, h, _ in members:
            n = h["nc"] * C
            out[i] = _symbols_to_bytes(sym[at : at + n], S)[: h["orig"]]
            at += n
    return out
