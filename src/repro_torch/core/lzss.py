"""GPULZ host API in PyTorch: compress / decompress, single and batched.

    matching -> local prefix sum -> encoding -> global prefix sum -> deflating
    `------------- Kernel I -------------'    `-- Kernel II --'   `Kernel III'

The entry points run on the card: ``device=None`` means ``"cuda"``, and
without a card they raise rather than carry on on the CPU.  The CPU runs
only when the caller asks for it with ``device="cpu"``.  Containers are
format v2, method 0, byte-identical to the reference package's, and the
two packages read each other's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.core.pipeline import (  # noqa: F401
    DEFAULT_CONFIG,
    WINDOW_LEVELS,
    CompressorBackend,
    DecoderBackend,
    LZSSConfig,
    available_backends,
    available_decoders,
    compress_chunks,
    compress_many_chunks,
    config_from_jax,
    decompress_chunks,
    decompress_many_chunks,
    default_backend,
    default_decoder,
    get_backend,
    get_decoder,
    pack_symbols,
    register_backend,
    register_decoder,
    resolve_backend,
    resolve_decoder,
    unpack_symbols,
)

_NOT_PORTED = {
    fmt.METHOD_HUFFMAN: "method-1 (deflate-full) containers are not ported yet: "
    "see ROADMAP.md queue 1 item 7",
    fmt.METHOD_LOSSY: "method-2 (lossy-fz) containers are not ported yet: "
    "see ROADMAP.md queue 1 item 8",
}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class CompressResult:
    data: np.ndarray        # uint8, exactly total_bytes long
    orig_bytes: int
    total_bytes: int

    @property
    def ratio(self) -> float:
        return self.orig_bytes / max(1, self.total_bytes)


@dataclasses.dataclass(frozen=True)
class BatchedCompressResult:
    """B containers compressed in one dispatch.

    ``data`` is the stacked (B, cap) uint8 buffer; row ``b`` holds a complete
    container in its first ``total_bytes[b]`` bytes (zeros beyond).
    """

    data: np.ndarray          # (B, cap) uint8
    orig_bytes: np.ndarray    # (B,) int64
    total_bytes: np.ndarray   # (B,) int64
    config: LZSSConfig

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, b: int) -> CompressResult:
        return CompressResult(
            data=self.data[b, : self.total_bytes[b]],
            orig_bytes=int(self.orig_bytes[b]),
            total_bytes=int(self.total_bytes[b]),
        )

    @property
    def ratio(self) -> float:
        return int(self.orig_bytes.sum()) / max(1, int(self.total_bytes.sum()))


def _as_bytes(data, device: torch.device) -> torch.Tensor:
    """Any array, tensor or bytes -> flat uint8 tensor on ``device``."""
    if isinstance(data, torch.Tensor):
        t = data.detach().contiguous().reshape(-1).view(torch.uint8)
    else:
        if isinstance(data, (bytes, bytearray, memoryview)):
            data = np.frombuffer(data, np.uint8)
        arr = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return t.to(device)


def _pack_padded(raw: torch.Tensor, nc: int, cfg: LZSSConfig) -> torch.Tensor:
    """(n,) uint8 bytes -> (nc, C) int32 symbols, zero-padded."""
    s, c = cfg.symbol_size, cfg.chunk_symbols
    padded = torch.zeros(nc * c * s, dtype=torch.uint8, device=raw.device)
    padded[: raw.numel()] = raw
    return pack_symbols(padded, s).reshape(nc, c)


def _n_chunks(n_bytes: int, cfg: LZSSConfig) -> int:
    nsym = -(-max(n_bytes, 1) // cfg.symbol_size)
    return -(-nsym // cfg.chunk_symbols)


def compress(data, config: LZSSConfig = DEFAULT_CONFIG, device=None) -> CompressResult:
    """Compress any array/bytes. Pads to whole chunks; header records truth."""
    dev = resolve_device(device)
    raw = _as_bytes(data, dev)
    n = raw.numel()
    symbols = _pack_padded(raw, _n_chunks(n, config), config)
    buf, total = compress_chunks(symbols, config, n)
    return CompressResult(data=buf[:total].cpu().numpy(), orig_bytes=n, total_bytes=total)


def _validated(blob):
    """Host-side validation of one container -> (uint8 array, header, tables)."""
    if isinstance(blob, torch.Tensor):
        blob = blob.detach().cpu().numpy()
    elif isinstance(blob, (bytes, bytearray, memoryview)):
        blob = np.frombuffer(blob, np.uint8)
    blob = np.array(blob, np.uint8)  # a writable copy for torch.from_numpy
    h, n_tokens, payload_sizes = fmt.validate_container(blob)
    if h.method in _NOT_PORTED:
        raise ValueError(_NOT_PORTED[h.method])
    return blob, h, n_tokens, payload_sizes


def decompress(blob, decoder: str = "auto", device=None) -> np.ndarray:
    """Decompress a container -> uint8 array of the original bytes.

    Raises ``ValueError`` on a truncated or corrupt container (the checks of
    ``format.validate_container``) before anything is decoded.
    """
    dev = resolve_device(device)
    blob, h, n_tokens, payload_sizes = _validated(blob)
    symbols = decompress_chunks(
        torch.from_numpy(blob).to(dev),
        torch.from_numpy(n_tokens).to(dev),
        torch.from_numpy(payload_sizes).to(dev),
        symbol_size=h.symbol_size,
        chunk_symbols=h.chunk_symbols,
        n_chunks=h.n_chunks,
        decoder=resolve_decoder(decoder, dev),
    )
    out = unpack_symbols(symbols.reshape(-1), h.symbol_size)[: h.orig_bytes]
    return out.cpu().numpy()


def compression_ratio(data, config: LZSSConfig = DEFAULT_CONFIG, device=None) -> float:
    return compress(data, config, device).ratio


def compress_many(arrays, config: LZSSConfig = DEFAULT_CONFIG, device=None) -> BatchedCompressResult:
    """Compress a batch of buffers in one dispatch.

    ``arrays`` is a list of array-likes or tensors (ragged sizes allowed —
    every buffer is padded to the batch's common chunk count, headers record
    true sizes) or a (B, n) array treated as B equal-size buffers.
    """
    dev = resolve_device(device)
    if isinstance(arrays, (np.ndarray, torch.Tensor)) and arrays.ndim == 2:
        arrays = [arrays[i] for i in range(arrays.shape[0])]
    raws = [_as_bytes(a, dev) for a in arrays]
    if not raws:
        raise ValueError("compress_many needs at least one buffer")
    sizes = [r.numel() for r in raws]
    nc = _n_chunks(max(sizes), config)
    symbols = torch.stack([_pack_padded(r, nc, config) for r in raws])
    data, totals = compress_many_chunks(symbols, config, sizes)
    return BatchedCompressResult(
        data=data.cpu().numpy(),
        orig_bytes=np.asarray(sizes, np.int64),
        total_bytes=np.asarray(totals, np.int64),
        config=config,
    )


def decompress_many(batch, decoder: str = "auto", device=None) -> list:
    """Decompress a batch of containers in one dispatch.

    ``batch`` is a ``BatchedCompressResult`` or a list of container blobs,
    all of one geometry (S, C, n_chunks) — true for anything produced by
    ``compress_many``.  Returns a list of uint8 arrays.
    """
    dev = resolve_device(device)
    if isinstance(batch, BatchedCompressResult):
        blobs = [batch.data[b, : int(batch.total_bytes[b])] for b in range(len(batch))]
    else:
        blobs = list(batch)
    if not blobs:
        raise ValueError("decompress_many needs at least one container")
    checked = []
    for i, b in enumerate(blobs):
        try:
            checked.append(_validated(b))
        except ValueError as e:
            raise ValueError(f"buffer {i}: {e}") from None
    h0 = checked[0][1]
    for i, (_, h, _, _) in enumerate(checked[1:], start=1):
        if (h.symbol_size, h.chunk_symbols, h.n_chunks) != (
            h0.symbol_size, h0.chunk_symbols, h0.n_chunks
        ):
            raise ValueError(
                f"decompress_many requires a homogeneous batch geometry; "
                f"buffer 0 has (symbol_size={h0.symbol_size}, "
                f"chunk_symbols={h0.chunk_symbols}, n_chunks={h0.n_chunks}) "
                f"but buffer {i} has (symbol_size={h.symbol_size}, "
                f"chunk_symbols={h.chunk_symbols}, n_chunks={h.n_chunks}); "
                f"decompress mismatched containers individually"
            )
    width = max(c[0].size for c in checked)
    stacked = np.zeros((len(checked), width), np.uint8)
    for i, c in enumerate(checked):
        stacked[i, : c[0].size] = c[0]
    symbols = decompress_many_chunks(
        torch.from_numpy(stacked).to(dev),
        torch.from_numpy(np.stack([c[2] for c in checked])).to(dev),
        torch.from_numpy(np.stack([c[3] for c in checked])).to(dev),
        symbol_size=h0.symbol_size,
        chunk_symbols=h0.chunk_symbols,
        n_chunks=h0.n_chunks,
        decoder=resolve_decoder(decoder, dev),
    )
    s = h0.symbol_size
    out = []
    for i, (_, h, _, _) in enumerate(checked):
        out.append(unpack_symbols(symbols[i].reshape(-1), s)[: h.orig_bytes].cpu().numpy())
    return out
