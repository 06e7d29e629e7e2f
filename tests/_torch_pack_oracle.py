"""The batched write as the host API made it a buffer at a time: each buffer
to bytes, padded and packed alone, the rows stacked, one launch of the
one-launch compressor for the batch, then each row's header and tables
written alone, the header by a pageable copy.  ``compress_many`` must give
these bytes.  Not a test module; imports no JAX, so the card tests read it
too."""

import numpy as np
import torch

from repro_torch.core import format as fmt, lzss, pipeline
from repro_torch.kernels import ops


def as_bytes(data) -> torch.Tensor:
    """A buffer's flat uint8 bytes, on its own device (host data on the CPU)."""
    if isinstance(data, torch.Tensor):
        return data.detach().contiguous().reshape(-1).view(torch.uint8)
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, np.uint8)
    return torch.from_numpy(np.ascontiguousarray(data).view(np.uint8).reshape(-1).copy())


def pack_padded(raw: torch.Tensor, nc: int, cfg) -> torch.Tensor:
    """(n,) uint8 bytes -> (nc, C) int32 symbols, zero-padded."""
    s, c = cfg.symbol_size, cfg.chunk_symbols
    padded = torch.zeros(nc * c * s, dtype=torch.uint8, device=raw.device)
    padded[: raw.numel()] = raw
    return pipeline.pack_symbols(padded, s).reshape(nc, c)


def header_bytes(*, symbol_size, window, chunk_symbols, n_chunks, orig_bytes, payload_total,
                 flag_total):
    """The 48 header bytes of a method-0 container, field by field."""
    return (
        bytes(fmt.MAGIC)
        + bytes([fmt.VERSION, symbol_size])
        + window.to_bytes(2, "little")
        + chunk_symbols.to_bytes(4, "little")
        + n_chunks.to_bytes(4, "little")
        + orig_bytes.to_bytes(8, "little")
        + payload_total.to_bytes(8, "little")
        + flag_total.to_bytes(8, "little")
        + bytes([fmt.METHOD_RAW, 0])
        + bytes(6)
    )


def write_header_and_tables(out, *, n_tokens, payload_sizes, **fields):
    """One row's header by a pageable copy, then its two tables."""
    nc = fields["n_chunks"]
    out[: fmt.HEADER_BYTES] = torch.frombuffer(bytearray(header_bytes(**fields)),
                                               dtype=torch.uint8)
    for base, table in ((fmt.HEADER_BYTES, n_tokens), (fmt.HEADER_BYTES + 4 * nc, payload_sizes)):
        words = torch.empty(nc, dtype=torch.int32, device=out.device)
        words.copy_(table.reshape(nc))
        out[base : base + 4 * nc] = words.view(torch.uint8)


def compress_many(arrays, cfg, device) -> tuple:
    """((B, cap) uint8 buffer, list of B totals, list of B sizes) of the
    batch, every step a buffer at a time; ``device`` runs the compressor."""
    if isinstance(arrays, (np.ndarray, torch.Tensor)) and arrays.ndim == 2:
        arrays = [arrays[i] for i in range(arrays.shape[0])]
    raws = [as_bytes(a).to(device) for a in arrays]
    sizes = [r.numel() for r in raws]
    s, c = cfg.symbol_size, cfg.chunk_symbols
    nc = lzss._n_chunks(max(sizes), cfg)
    symbols = torch.stack([pack_padded(r, nc, cfg) for r in raws])
    blobs, n_tokens, payload_sizes, totals = ops.lz_fused_mono(
        symbols, window=cfg.window, min_match=cfg.min_match, symbol_size=s,
        cap=fmt.max_compressed_bytes(nc * c * s, s, c), sec_flags=fmt.HEADER_BYTES + 8 * nc,
    )
    out = []
    for r, (flag_total, pay_total) in enumerate(totals.cpu().tolist()):
        write_header_and_tables(
            blobs[r], n_tokens=n_tokens[r], payload_sizes=payload_sizes[r],
            symbol_size=s, window=cfg.window, chunk_symbols=c, n_chunks=nc,
            orig_bytes=sizes[r], payload_total=pay_total, flag_total=flag_total,
        )
        out.append(fmt.HEADER_BYTES + 8 * nc + flag_total + pay_total)
    return blobs.cpu().numpy(), out, sizes
