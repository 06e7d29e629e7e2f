"""Pluggable compression pipeline backends (the PyTorch port).

The paper's pipeline is

    matching -> local prefix sum -> encoding -> global prefix sum -> deflating
    `------------- Kernel I -------------'    `-- Kernel II --'   `Kernel III'

A compressor backend provides ``kernel1(symbols, cfg)`` — (N, C) int32
symbols to the per-position / per-chunk dict the emit tail needs — and may
own the Kernel II/III tail through an optional ``emit`` method; the default
tail is ``emit_torch``.  A decoder backend maps per-chunk aligned sections
to symbols through ``decode``.  Registered entries:

  compressors  ``torch``          plain PyTorch: matching, the
                                  pointer-doubling selector, prefix sums
               ``torch-scan``     the same with the paper's sequential
                                  selection walk (the oracle)
               ``fused-deflate``  the CUDA Kernel I -> Kernel II -> Kernel III
  decoders     ``torch-parallel`` plain PyTorch parallel decoder
               ``torch-scan``     sequential token walk (the oracle)
               ``fused``          plain ``gather_section`` + the CUDA decoder

``"auto"`` resolves by device: the CUDA kernels on ``cuda`` and the plain
``torch`` / ``torch-parallel`` entries on ``cpu``.  On CPU tensors the
kernel wrappers run their plain versions, so the ``fused*`` entries also
work there.  Every entry produces the same container bytes and symbols,
and the bytes equal the reference package's method-0 containers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Protocol

import torch

from repro_torch.core import autotune, decode as decode_mod
from repro_torch.core import deflate, encode, format as fmt, match

# --------------------------------------------------------------- config


@dataclasses.dataclass(frozen=True)
class LZSSConfig:
    """Paper parameters: S (symbol bytes), W (window), C (chunk symbols).

    ``backend`` selects the compressor and ``decoder`` the decompression
    strategy; both are registry keys or ``"auto"`` (resolved by device at
    dispatch).  ``chunks_per_block`` is kept so that configs cross from the
    reference package, where it sets the TPU kernels' block geometry; it
    has no effect on the Hopper kernels, which run one chunk per thread
    block.  (C, S) is checked against the kernels' shared-memory need.
    """

    symbol_size: int = 2  # S in {1, 2, 4}
    window: int = 128  # W in [1, 255]
    chunk_symbols: int = autotune.DEFAULT_CHUNK_SYMBOLS  # C
    chunks_per_block: object = None
    backend: str = "auto"
    decoder: str = "auto"

    def __post_init__(self):
        if self.symbol_size not in (1, 2, 4):
            raise ValueError(f"symbol_size must be 1, 2 or 4: {self.symbol_size}")
        if not 1 <= self.window <= 255:
            raise ValueError(f"window must be in [1, 255]: {self.window}")
        if self.chunk_symbols % 8:
            raise ValueError("chunk_symbols must be a multiple of 8")
        autotune.validate_block_geometry(
            self.chunk_symbols,
            self.chunks_per_block
            if self.chunks_per_block is not None
            else autotune.DEFAULT_CHUNKS_PER_BLOCK,
            self.symbol_size,
        )
        if self.backend != "auto" and self.backend not in _BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; "
                f"registered: {available_backends()} (also accepted: 'auto')"
            )
        object.__setattr__(
            self, "decoder", _DECODER_ALIASES.get(self.decoder, self.decoder)
        )
        if self.decoder != "auto" and self.decoder not in _DECODERS:
            raise ValueError(
                f"unknown decoder {self.decoder!r}; "
                f"registered: {available_decoders()} "
                f"(also accepted: 'auto', {sorted(_DECODER_ALIASES)})"
            )

    @property
    def min_match(self) -> int:
        return encode.min_match_length(self.symbol_size)


# Reference-package registry keys -> the port's.  The raw, byte-identical
# family differs only in how it executes, so it maps to "auto"; the
# sequential oracles map to theirs.
_JAX_BACKENDS = {
    "xla": "auto", "pallas-match": "auto", "fused": "auto",
    "fused-deflate": "auto", "fused-mono": "auto", "auto": "auto",
    "xla-scan": "torch-scan",
}
_JAX_DECODERS = {
    "xla-parallel": "auto", "fused": "auto", "fused-mono": "auto",
    "auto": "auto", "xla-scan": "torch-scan",
}
_QUEUED = {
    "sharded": "ROADMAP.md queue 1 item 9 (sharding/batch.py)",
    "deflate-full": "ROADMAP.md queue 1 item 7 (core/entropy.py)",
    "lossy-fz": "ROADMAP.md queue 1 item 8 (core/bitshuffle.py + core/lossy.py)",
}
_JAX_FIELDS = {
    "symbol_size", "window", "chunk_symbols", "chunks_per_block", "backend",
    "decoder", "mesh", "batch_axis", "lossy_eb", "lossy_inner",
}


def config_from_jax(fields: dict) -> LZSSConfig:
    """An ``LZSSConfig`` from ``dataclasses.asdict`` of a reference config.

    Raises ``ValueError`` for an entry whose container or dispatch is not
    ported yet, naming the ROADMAP item, and for unknown fields.
    """
    unknown = set(fields) - _JAX_FIELDS
    if unknown:
        raise ValueError(f"unknown reference LZSSConfig fields: {sorted(unknown)}")
    mapped = {}
    for key, table in (("backend", _JAX_BACKENDS), ("decoder", _JAX_DECODERS)):
        name = fields.get(key, "auto")
        if name in _QUEUED:
            raise ValueError(
                f"{key}={name!r} is not ported yet: see {_QUEUED[name]}"
            )
        if name not in table:
            raise ValueError(f"unknown reference {key} {name!r}")
        mapped[key] = table[name]
    if fields.get("mesh") is not None or fields.get("batch_axis") is not None:
        raise ValueError(f"mesh=... is not ported yet: see {_QUEUED['sharded']}")
    if fields.get("lossy_eb") is not None:
        raise ValueError(f"lossy_eb is not ported yet: see {_QUEUED['lossy-fz']}")
    return LZSSConfig(
        symbol_size=fields.get("symbol_size", 2),
        window=fields.get("window", 128),
        chunk_symbols=fields.get("chunk_symbols", autotune.DEFAULT_CHUNK_SYMBOLS),
        chunks_per_block=fields.get("chunks_per_block"),
        **mapped,
    )


# ------------------------------------------------------------- backends


class CompressorBackend(Protocol):
    """Kernel-I contract: match + select + local prefix sum for all chunks.

    ``kernel1`` maps (N, C) int32 symbols to a dict:

      lengths, offsets   (N, C) int32  best match per position
      emitted            (N, C) bool   token emitted at this position
      use_match          (N, C) bool   emitted token is a pointer
      local_off          (N, C) int32  exclusive prefix sum of token sizes
      payload_sizes      (N,)   int32  compressed payload bytes per chunk
      n_tokens           (N,)   int32  tokens per chunk (= flag bits)

    A backend may define ``emit(symbols, k1, cfg, orig_bytes)`` for a batch
    of (B, nc, C) symbols and the dict reshaped to (B, nc, ...), returning
    ``(blobs (B, cap) uint8, totals list of B ints)``; ``emit_torch`` is
    the default.
    """

    name: str

    def kernel1(self, symbols: torch.Tensor, cfg: LZSSConfig) -> dict: ...


_BACKENDS: Dict[str, CompressorBackend] = {}


def register_backend(backend, *, overwrite: bool = False):
    """Register a backend *instance* under ``backend.name``."""
    if backend.name in _BACKENDS and not overwrite:
        raise ValueError(
            f"backend {backend.name!r} already registered; "
            f"pass overwrite=True to replace it"
        )
    _BACKENDS[backend.name] = backend
    return backend


def default_backend(device) -> str:
    """The CUDA kernels on a CUDA device, plain PyTorch on the CPU."""
    return "fused-deflate" if torch.device(device).type == "cuda" else "torch"


def resolve_backend(name: str, device) -> str:
    """Normalize a backend selector (a key or ``"auto"``) for ``device``."""
    if name == "auto":
        name = default_backend(device)
    if name not in _BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; registered: {available_backends()} "
            f"(also accepted: 'auto')"
        )
    return name


def get_backend(name: str, device) -> CompressorBackend:
    return _BACKENDS[resolve_backend(name, device)]


def available_backends() -> list:
    return sorted(_BACKENDS)


class TorchBackend:
    """Plain PyTorch: matching, selection and prefix sums as separate ops."""

    name = "torch"
    selector = staticmethod(encode.select_tokens_doubling)

    def kernel1(self, symbols, cfg):
        lengths, offsets = match.find_matches(symbols, window=cfg.window)
        emitted = self.selector(lengths, min_match=cfg.min_match)
        fields = encode.token_fields(
            lengths, emitted, min_match=cfg.min_match, symbol_size=cfg.symbol_size
        )
        return dict(lengths=lengths, offsets=offsets, emitted=emitted, **fields)


class TorchScanBackend(TorchBackend):
    """The paper's sequential selection walk (equivalence oracle)."""

    name = "torch-scan"
    selector = staticmethod(encode.select_tokens_scan)


class FusedDeflateBackend:
    """The CUDA path: Kernel I, then Kernel II and Kernel III."""

    name = "fused-deflate"

    def kernel1(self, symbols, cfg):
        from repro_torch.kernels import ops

        out = ops.lz_kernel1(
            symbols, window=cfg.window, min_match=cfg.min_match,
            symbol_size=cfg.symbol_size,
        )
        return dict(out, use_match=out["emitted"] & (out["lengths"] >= cfg.min_match))

    def emit(self, symbols, k1, cfg, orig_bytes):
        from repro_torch.kernels import ops

        b, nc, c = symbols.shape
        s = cfg.symbol_size
        cap = fmt.max_compressed_bytes(nc * c * s, s, c)
        sec_flags = fmt.HEADER_BYTES + 8 * nc
        flag_off, pay_off, totals = ops.lz_global_offsets(k1["n_tokens"], k1["payload_sizes"])
        blobs = ops.lz_scatter(
            symbols, k1["lengths"], k1["offsets"], k1["emitted"], k1["local_off"],
            flag_off, pay_off, symbol_size=s, min_match=cfg.min_match, cap=cap,
            sec_flags=sec_flags,
        )
        totals = totals.cpu().tolist()  # the one device-to-host read
        return _finalize_container(
            blobs, cfg, orig_bytes, nc=nc, c=c, n_tokens=k1["n_tokens"],
            payload_sizes=k1["payload_sizes"],
            flag_totals=[t[0] for t in totals], pay_totals=[t[1] for t in totals],
        )


register_backend(TorchBackend())
register_backend(TorchScanBackend())
register_backend(FusedDeflateBackend())


# ------------------------------------------------------------- decoders


class DecoderBackend(Protocol):
    """Decode contract: per-chunk aligned sections -> symbols.

    ``decode`` maps (N, C//8) flag bytes, (N, C*S) payload bytes and (N,)
    token counts (the tensors ``deflate.gather_section`` rebuilds from a
    container) to (N, C) int32 symbols.
    """

    name: str

    def decode(self, flag_bytes, payload, n_tokens, *, symbol_size) -> torch.Tensor: ...


_DECODERS: Dict[str, DecoderBackend] = {}
_DECODER_ALIASES = {"parallel": "torch-parallel", "scan": "torch-scan"}


def register_decoder(decoder, *, overwrite: bool = False):
    """Register a decoder *instance* under ``decoder.name``."""
    if decoder.name in _DECODERS and not overwrite:
        raise ValueError(
            f"decoder {decoder.name!r} already registered; "
            f"pass overwrite=True to replace it"
        )
    _DECODERS[decoder.name] = decoder
    return decoder


def default_decoder(device) -> str:
    """The CUDA decoder on a CUDA device, plain PyTorch on the CPU."""
    return "fused" if torch.device(device).type == "cuda" else "torch-parallel"


def resolve_decoder(name: str, device) -> str:
    """Normalize a decoder selector (key, alias or ``"auto"``) for ``device``."""
    name = _DECODER_ALIASES.get(name, name)
    if name == "auto":
        name = default_decoder(device)
    if name not in _DECODERS:
        raise ValueError(
            f"unknown decoder {name!r}; registered: {available_decoders()} "
            f"(also accepted: 'auto', {sorted(_DECODER_ALIASES)})"
        )
    return name


def get_decoder(name: str, device) -> DecoderBackend:
    return _DECODERS[resolve_decoder(name, device)]


def available_decoders() -> list:
    return sorted(_DECODERS)


class TorchParallelDecoder:
    """Plain PyTorch parallel decoder (core/decode.py:decode_parallel)."""

    name = "torch-parallel"

    def decode(self, flag_bytes, payload, n_tokens, *, symbol_size):
        return decode_mod.decode_parallel(flag_bytes, payload, n_tokens, symbol_size=symbol_size)


class TorchScanDecoder:
    """Sequential token walk (equivalence oracle)."""

    name = "torch-scan"

    def decode(self, flag_bytes, payload, n_tokens, *, symbol_size):
        return decode_mod.decode_scan(flag_bytes, payload, n_tokens, symbol_size=symbol_size)


class FusedDecoder:
    """The CUDA decoder, on sections gathered by plain PyTorch."""

    name = "fused"

    def decode(self, flag_bytes, payload, n_tokens, *, symbol_size):
        from repro_torch.kernels import ops

        return ops.lz_decode(flag_bytes, payload, n_tokens, symbol_size=symbol_size)


register_decoder(TorchParallelDecoder())
register_decoder(TorchScanDecoder())
register_decoder(FusedDecoder())


# ------------------------------------------------------- symbol packing


def pack_symbols(data: torch.Tensor, symbol_size: int) -> torch.Tensor:
    """(n_bytes,) uint8 -> (n_sym,) int32 little-endian symbols (n_bytes % S == 0).

    At S=4 a symbol whose top byte is >= 128 is negative: the bit pattern is
    what counts, as in the reference.
    """
    d = data.contiguous()
    if symbol_size == 4:
        return d.view(torch.int32).clone()
    if symbol_size == 2:
        return d.view(torch.int16).to(torch.int32) & 0xFFFF
    return d.to(torch.int32)


def unpack_symbols(symbols: torch.Tensor, symbol_size: int) -> torch.Tensor:
    """(n_sym,) int32 -> (n_sym * S,) uint8 little-endian."""
    b = symbols.to(torch.int32).contiguous().view(torch.uint8).reshape(-1, 4)
    return b[:, :symbol_size].reshape(-1)


# ------------------------------------------------------- the cores


def _finalize_container(blobs, cfg, orig_bytes, *, nc, c, n_tokens, payload_sizes,
                        flag_totals, pay_totals):
    """Write header + A/B tables into section-filled (B, cap) uint8 blobs.

    Returns ``(blobs, totals)`` with ``totals`` a list of B host ints.
    """
    totals = []
    for r in range(blobs.shape[0]):
        fmt.write_header_and_tables(
            blobs[r], symbol_size=cfg.symbol_size, window=cfg.window,
            chunk_symbols=c, n_chunks=nc, orig_bytes=orig_bytes[r],
            payload_total=pay_totals[r], flag_total=flag_totals[r],
            n_tokens=n_tokens[r], payload_sizes=payload_sizes[r],
        )
        totals.append(fmt.HEADER_BYTES + 8 * nc + flag_totals[r] + pay_totals[r])
    return blobs, totals


def emit_torch(symbols, k1, cfg, orig_bytes):
    """The plain emit tail: flag packing, payload build, Kernel II's two
    prefix sums and Kernel III's scatter as separate ops, per buffer."""
    b, nc, c = symbols.shape
    s = cfg.symbol_size
    flat = {k: v.reshape(b * nc, *v.shape[2:]) for k, v in k1.items()}
    flat["sizes"] = torch.where(flat["emitted"], torch.where(flat["use_match"], 2, s), 0)
    flag_bytes, flag_sizes = deflate.pack_flags(
        flat["emitted"], flat["use_match"], n_tokens=flat["n_tokens"]
    )
    payload = deflate.build_chunk_payloads(
        symbols.reshape(b * nc, c), flat["lengths"], flat["offsets"], flat, symbol_size=s
    )
    cap = fmt.max_compressed_bytes(nc * c * s, s, c)
    sec_flags = fmt.HEADER_BYTES + 8 * nc
    blobs = torch.zeros(b, cap, dtype=torch.uint8, device=symbols.device)
    flag_totals, pay_totals = [], []
    for r in range(b):
        rows = slice(r * nc, (r + 1) * nc)
        pay_off, pay_total, flag_off, flag_total = deflate.global_offsets(
            flat["payload_sizes"][rows], flag_sizes[rows]
        )
        out = torch.zeros(cap, dtype=torch.int32, device=symbols.device)
        deflate.scatter_section(out, sec_flags, flag_bytes[rows], flag_sizes[rows], flag_off)
        deflate.scatter_section(
            out, sec_flags + flag_total, payload[rows], flat["payload_sizes"][rows], pay_off
        )
        blobs[r] = out.to(torch.uint8)
        flag_totals.append(int(flag_total))
        pay_totals.append(int(pay_total))
    return _finalize_container(
        blobs, cfg, orig_bytes, nc=nc, c=c, n_tokens=k1["n_tokens"],
        payload_sizes=k1["payload_sizes"], flag_totals=flag_totals, pay_totals=pay_totals,
    )


def compress_many_chunks(symbols: torch.Tensor, cfg: LZSSConfig, orig_bytes=None):
    """(B, nc, C) int32 symbols -> ((B, cap) uint8 blobs, list of B totals).

    Row ``b`` holds a complete container in its first ``totals[b]`` bytes,
    zeros beyond.  ``orig_bytes`` (B host ints) are the true pre-padding
    byte counts for the headers; by default the padded size ``nc * C * S``.
    Kernel I runs over all B * nc chunks at once.
    """
    if symbols.dim() != 3 or symbols.shape[2] != cfg.chunk_symbols:
        raise ValueError(
            f"symbols must be (B, nc, {cfg.chunk_symbols}), got {tuple(symbols.shape)}"
        )
    b, nc, c = symbols.shape
    s = cfg.symbol_size
    if fmt.max_compressed_bytes(nc * c * s, s, c) >= 2**31:
        raise ValueError(
            f"{nc * c * s} bytes per buffer is over the int32 section offsets; "
            f"split the input"
        )
    if orig_bytes is None:
        orig_bytes = [nc * c * s] * b
    backend = get_backend(cfg.backend, symbols.device)
    k1 = backend.kernel1(symbols.reshape(b * nc, c), cfg)
    k1 = {k: v.reshape(b, nc, *v.shape[1:]) for k, v in k1.items()}
    emit = getattr(backend, "emit", emit_torch)
    return emit(symbols, k1, cfg, list(orig_bytes))


def compress_chunks(symbols: torch.Tensor, cfg: LZSSConfig, orig_bytes=None):
    """(nc, C) int32 symbols -> ((cap,) uint8 container buffer, total bytes)."""
    blobs, totals = compress_many_chunks(
        symbols[None], cfg, None if orig_bytes is None else [orig_bytes]
    )
    return blobs[0], totals[0]


def decompress_many_chunks(blobs, n_tokens, payload_sizes, *, symbol_size,
                           chunk_symbols, n_chunks, decoder="auto"):
    """(B, L) uint8 blobs + (B, nc) tables -> (B, nc, C) int32 symbols.

    ``blobs`` need only cover each container's live bytes: the section
    gathers are clipped and masked.  The decoder runs once over all B * nc
    chunks.
    """
    c, s, nc = chunk_symbols, symbol_size, n_chunks
    b = blobs.shape[0]
    dec = get_decoder(decoder, blobs.device)
    nt = n_tokens.to(torch.int64)
    ps = payload_sizes.to(torch.int64)
    fs = (nt + 7) // 8
    fcsum = torch.cumsum(fs, 1)
    pcsum = torch.cumsum(ps, 1)
    sec_flags = fmt.HEADER_BYTES + 8 * nc
    flags, payload = [], []
    for r in range(b):
        flags.append(deflate.gather_section(
            blobs[r], sec_flags, fs[r], fcsum[r] - fs[r], (c + 7) // 8
        ))
        payload.append(deflate.gather_section(
            blobs[r], sec_flags + fcsum[r, -1], ps[r], pcsum[r] - ps[r], c * s
        ))
    symbols = dec.decode(
        torch.cat(flags), torch.cat(payload), n_tokens.reshape(-1).to(torch.int32),
        symbol_size=s,
    )
    return symbols.reshape(b, nc, c)


def decompress_chunks(blob, n_tokens, payload_sizes, *, symbol_size, chunk_symbols,
                      n_chunks, decoder="auto"):
    """(L,) uint8 container bytes + (nc,) tables -> (nc, C) int32 symbols."""
    return decompress_many_chunks(
        blob[None], n_tokens[None], payload_sizes[None], symbol_size=symbol_size,
        chunk_symbols=chunk_symbols, n_chunks=n_chunks, decoder=decoder,
    )[0]


DEFAULT_CONFIG = LZSSConfig()  # paper default: C=2048, S=2, W=128

# window "levels" exposed to users (paper §3.2.3: level 1-4 trade ratio/speed)
WINDOW_LEVELS = {1: 32, 2: 64, 3: 128, 4: 255}
