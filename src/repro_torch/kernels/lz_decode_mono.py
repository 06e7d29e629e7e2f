"""The one-launch decoder: container blobs -> symbols for a whole batch.

The CUDA kernel is ``csrc/lz_decode_mono.cu`` (one thread block per chunk,
its sections read in place from the blob); it replaces the TPU kernel
``repro/kernels/lz_decode_mono.py:_mono_decode_kernel``.  The per-chunk
section offsets are cumsums of the A/B tables, taken here (one cumsum of
each row's flag sizes and then its payload sizes) as the TPU wrapper takes
them outside its kernel.  ``lz_decode_mono_plain`` is its
plain PyTorch version; ``kernels/ops.py`` chooses by the tensor's device.

A chunk's flag window is ``C // 8`` bytes and its payload window ``C * S``
bytes, masked to the chunk's true section sizes; a byte past the blob's end
reads as zero on every lane, as the TPU wrapper's zero pad gives (the
split path's ``deflate.gather_section`` clips to the last byte instead).
"""

from __future__ import annotations

import torch

from repro_torch.core import autotune, format as fmt
from repro_torch.kernels import _build, lz_decode


def section_starts(n_tokens, payload_sizes):
    """(B, nc) A/B tables -> (fofs, pofs): (B, nc) int64 byte offsets of each
    chunk's flag and payload section within its container."""
    nt = n_tokens.to(torch.int64)
    psz = payload_sizes.to(torch.int64)
    fsz = (nt + 7) // 8
    fcs = torch.cumsum(fsz, 1)
    pcs = torch.cumsum(psz, 1)
    sec_flags = fmt.HEADER_BYTES + 8 * nt.shape[1]
    return sec_flags + fcs - fsz, sec_flags + fcs[:, -1:] + pcs - psz


def _windows(blobs, starts, sizes, width):
    """(B, L) bytes -> (B, nc, width): byte ``starts + j`` of each row where
    ``j < sizes`` and the byte lies inside the row, else 0."""
    b, length = blobs.shape
    j = torch.arange(width, device=blobs.device, dtype=torch.int64)
    idx = starts[..., None] + j
    valid = (j < sizes[..., None]) & (idx >= 0) & (idx < length)
    rows = torch.arange(b, device=blobs.device)[:, None, None]
    return torch.where(valid, blobs[rows, idx.clamp(0, length - 1)], 0)


def lz_decode_mono_plain(blobs, n_tokens, payload_sizes, *, symbol_size, chunk_symbols):
    """(B, L) uint8 container blobs + (B, nc) A/B tables -> (B, nc, C) int32
    symbols."""
    b, nc = n_tokens.shape
    c, s = chunk_symbols, symbol_size
    fofs, pofs = section_starts(n_tokens, payload_sizes)
    nt = n_tokens.to(torch.int64)
    blob = blobs.to(torch.uint8)
    flags = _windows(blob, fofs, (nt + 7) // 8, c // 8)
    payload = _windows(blob, pofs, payload_sizes.to(torch.int64), c * s)
    out = lz_decode.lz_decode_plain(
        flags.reshape(b * nc, c // 8), payload.reshape(b * nc, c * s),
        n_tokens.reshape(-1).to(torch.int32), symbol_size=s,
    )
    return out.reshape(b, nc, c)


def lz_decode_mono_cuda(blobs, n_tokens, payload_sizes, *, symbol_size, chunk_symbols):
    """The same function by one launch of the CUDA kernel."""
    _build.require_cuda("the one-launch decoder", blobs, n_tokens, payload_sizes)
    c, s = chunk_symbols, symbol_size
    if blobs.dim() != 2 or n_tokens.dim() != 2 or n_tokens.shape != payload_sizes.shape \
            or n_tokens.shape[0] != blobs.shape[0]:
        raise ValueError(
            f"the one-launch decoder takes (B, L) blobs and two (B, nc) tables, got "
            f"{tuple(blobs.shape)}, {tuple(n_tokens.shape)}, {tuple(payload_sizes.shape)}"
        )
    if c % 8 or c < 8 or s not in (1, 2, 4):
        raise ValueError(f"bad geometry: chunk_symbols={c}, symbol_size={s}")
    autotune.validate_block_geometry(c, 1, s)
    b, nc = n_tokens.shape
    blob = blobs.to(torch.uint8).contiguous()
    nt = n_tokens.to(torch.int32).contiguous()
    psz = payload_sizes.to(torch.int32).contiguous()
    # section_starts' sums in one cumsum (the kernel takes the starts from
    # it): each row's flag sizes, then its payload sizes
    cums = torch.cumsum(torch.cat([(nt + 7) >> 3, psz], 1), 1, dtype=torch.int64)
    out = torch.empty(b, nc, c, dtype=torch.int32, device=blob.device)
    lib = _build.library("lz_decode_mono")
    code = lib.lz_decode_mono_launch(
        blob.data_ptr(), blob.shape[1], b, nc, nt.data_ptr(), psz.data_ptr(), cums.data_ptr(),
        fmt.HEADER_BYTES + 8 * nc, c, s, out.data_ptr(), _build.stream(blob),
    )
    _build.check(lib, code, "one-launch decoder (lz_decode_mono_launch)")
    return out
