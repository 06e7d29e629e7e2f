"""Flag-array packing, per-chunk payload construction, and deflating.

The plain PyTorch versions of the paper's encode tail and Kernels II/III:
  * ``pack_flags`` / ``build_chunk_payloads`` — the encode tail of Kernel I
    (compressed symbols at their local-prefix-sum offsets, the per-chunk
    flag array);
  * ``global_offsets`` — Kernel II (two exclusive prefix sums, over the
    per-chunk payload sizes and flag-array sizes);
  * ``scatter_section`` — Kernel III (deflate: each chunk's compact bytes
    go to their global offset, the empty bytes are dropped);
  * ``gather_section`` — its inverse, used by every decoder.

Variable-size results live in fixed worst-case buffers.  Writes past a
chunk's live size go to one extra dropped column, and gathers are clipped
and masked: the bounds checks of the reference's 'drop'-mode scatters.
"""

from __future__ import annotations

import torch


def _rows(nc, device):
    return torch.arange(nc, device=device)[:, None]


def pack_flags(emitted, use_match, n_tokens=None):
    """Pack one flag bit per emitted token (1 = pointer, 0 = literal).

    Returns:
      flag_bytes: (nc, C//8) int32 in [0,255] — bit t of the chunk's flag
        stream is the t-th token's kind; trailing bits are zero.
      flag_sizes: (nc,) int32 — ceil(n_tokens/8) bytes actually used.
    """
    nc, c = emitted.shape
    cb = (c + 7) // 8
    e = emitted.to(torch.int32)
    rank = torch.cumsum(e, dim=1, dtype=torch.int32) - 1
    byte_idx = torch.where(emitted, rank // 8, cb).to(torch.int64)  # cb => dropped
    bitval = (use_match.to(torch.int32) << (rank % 8)) * e
    flag_bytes = torch.zeros(nc, cb + 1, dtype=torch.int32, device=emitted.device)
    flag_bytes.scatter_add_(1, byte_idx, bitval)
    if n_tokens is None:
        n_tokens = e.sum(dim=1, dtype=torch.int32)
    return flag_bytes[:, :cb], (n_tokens + 7) // 8


def build_chunk_payloads(symbols, lengths, offsets, fields, *, symbol_size):
    """Write each chunk's compressed bytes at their local offsets.

    Returns (nc, C*S) int32 byte values; bytes beyond fields['payload_sizes']
    are zero.  Pointers are [length, offset]; literals are the S symbol bytes
    little-endian.
    """
    nc, c = symbols.shape
    s = symbol_size
    bufsz = c * s
    use_match = fields["use_match"]
    emitted = use_match | (fields["sizes"] > 0)
    local = fields["local_off"]
    buf = torch.zeros(nc, bufsz + 1, dtype=torch.int32, device=symbols.device)
    width = torch.where(use_match, 2, s)
    for b in range(max(2, s)):
        match_byte = lengths if b == 0 else offsets
        lit_byte = (symbols >> (8 * b)) & 0xFF
        val = torch.where(use_match, match_byte, lit_byte)
        valid = emitted & (b < width)
        idx = torch.where(valid, local + b, bufsz).to(torch.int64)  # dropped
        buf.scatter_add_(1, idx, torch.where(valid, val, 0).to(torch.int32))
    return buf[:, :bufsz]


def global_offsets(payload_sizes, flag_sizes):
    """Kernel II: exclusive prefix sums over chunk payload and flag sizes.

    Returns ``(pay_off, pay_total, flag_off, flag_total)``; the totals are
    0-dim int32 tensors.
    """
    pay_csum = torch.cumsum(payload_sizes, 0, dtype=torch.int32)
    flag_csum = torch.cumsum(flag_sizes, 0, dtype=torch.int32)
    return (
        pay_csum - payload_sizes, pay_csum[-1], flag_csum - flag_sizes, flag_csum[-1]
    )


def scatter_section(out, base, chunk_bytes, chunk_sizes, chunk_offsets):
    """Kernel III: add per-chunk compact bytes at base + global offsets.

    out:         (cap,) int32 flat output buffer, updated in place
    base:        int or 0-dim tensor — section start within ``out``
    chunk_bytes: (nc, B) int32 — per-chunk buffers (valid prefix only)
    """
    nc, b = chunk_bytes.shape
    j = torch.arange(b, device=out.device, dtype=torch.int64)[None, :]
    valid = j < chunk_sizes[:, None]
    dest = base + chunk_offsets[:, None].to(torch.int64) + j
    valid = valid & (dest >= 0) & (dest < out.shape[0])
    out.index_put_((dest[valid],), chunk_bytes[valid].to(out.dtype), accumulate=True)
    return out


def gather_section(flat, base, chunk_sizes, chunk_offsets, width):
    """Inverse of scatter_section: re-chunk a compact section into (nc, width).

    Bytes beyond chunk_sizes[c] are zeroed; reads are clipped to ``flat``.
    The result keeps ``flat``'s dtype.
    """
    j = torch.arange(width, device=flat.device, dtype=torch.int64)[None, :]
    valid = j < chunk_sizes[:, None]
    src = torch.clamp(base + chunk_offsets[:, None].to(torch.int64) + j, 0, flat.shape[0] - 1)
    return torch.where(valid, flat[src], 0).to(flat.dtype)
