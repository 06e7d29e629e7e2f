"""Pluggable compression pipeline backends (the PyTorch port).

The paper's pipeline is

    matching -> local prefix sum -> encoding -> global prefix sum -> deflating
    `------------- Kernel I -------------'    `-- Kernel II --'   `Kernel III'

A compressor backend provides ``kernel1(symbols, cfg)`` — (N, C) int32
symbols to the per-position / per-chunk dict the emit tail needs — and may
own the Kernel II/III tail through an optional ``emit`` method; the default
tail is ``emit_torch``.  A backend may instead own a whole batch of raw
containers through an optional ``compress_many`` method.  A decoder backend
maps per-chunk aligned sections to symbols through ``decode``, and may own
a whole batch of raw containers through an optional ``decode_many``, or
the whole batched dispatch through ``decompress_many``.
Registered entries:

  compressors  ``torch``          plain PyTorch: matching, the
                                  pointer-doubling selector, prefix sums
               ``torch-scan``     the same with the paper's sequential
                                  selection walk (the oracle)
               ``cuda-match``     the CUDA match-only kernel, then the plain
                                  selector, prefix sums and ``emit_torch``
               ``fused``          the CUDA Kernel I, then ``emit_torch``
               ``fused-deflate``  the CUDA Kernel I -> Kernel II -> Kernel III
               ``fused-mono``     Kernels I + II + III in one CUDA launch for
                                  the whole batch (``compress_many``)
               ``deflate-full``   the device's LZSS + canonical Huffman over
                                  both sections (method-1 containers,
                                  core/entropy.py)
               ``lossy-fz``       error-bounded quantization + bitshuffle +
                                  the ``lossy_inner`` lossless stage
                                  (method-2 containers, core/lossy.py)
               ``sharded``        the batch split over the devices of
                                  ``LZSSConfig(mesh=...)``, each shard through
                                  the device's default (sharding/batch.py)
  decoders     ``torch-parallel`` plain PyTorch parallel decoder
               ``torch-scan``     sequential token walk (the oracle)
               ``fused``          plain ``gather_section`` + the CUDA decoder
               ``fused-mono``     the CUDA decoder reading the sections in
                                  place, one launch for the whole batch
                                  (``decode_many``)
               ``deflate-full``   gap-array Huffman decode + the device's
                                  LZSS decoder (method-1 containers only)
               ``lossy-fz``       inner decode + unshuffle + dequantization
                                  (method-2 containers only)
               ``sharded``        the batch split over the devices of the
                                  mesh passed at dispatch, each shard through
                                  the device's default decoder

``"auto"`` resolves by device: the one-launch ``fused-mono`` pair on
``cuda``, as the reference package's default on an accelerator, and the
plain ``torch`` / ``torch-parallel`` entries on ``cpu``.  On CPU tensors the
kernel wrappers run their plain versions, so the ``fused*`` entries also
work there.  Every raw entry produces the same container bytes and
symbols, and the bytes equal the reference package's method-0 containers;
``deflate-full`` and ``lossy-fz`` equal its method-1 and method-2
containers.  A backend or decoder that owns a whole container defines a
``compress`` / ``decode_blob`` hook instead of the Kernel-I / section
seams.
"""

from __future__ import annotations

import dataclasses
import math
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

    ``lossy_eb`` is the error bound of ``backend="lossy-fz"`` (0.0 selects
    its bit-exact lossless mode) and ``lossy_inner`` the lossless stage
    inside a lossy container.  The two container backends pin their own
    decoders, with the reference's validation and messages.

    ``mesh`` is a sequence of devices (``torch.device`` or their names) on
    one batch axis, ``"data"``; the ``"sharded"`` entries and the batched
    ``deflate-full`` / ``lossy-fz`` dispatches split the B dimension of the
    batched entry points over it (sharding/batch.py).  ``batch_axis`` names
    that axis (or ``None``).  Only those entries consult ``mesh``, so
    setting it with any other backend/decoder is rejected, with the
    reference's messages.
    """

    symbol_size: int = 2  # S in {1, 2, 4}
    window: int = 128  # W in [1, 255]
    chunk_symbols: int = autotune.DEFAULT_CHUNK_SYMBOLS  # C
    chunks_per_block: object = None
    backend: str = "auto"
    decoder: str = "auto"
    lossy_eb: object = None  # error bound for backend="lossy-fz" (0=lossless)
    lossy_inner: str = "auto"  # lossless stage inside a lossy-fz container
    mesh: object = None  # devices the "sharded" entries split B over
    batch_axis: object = None  # axis name (or tuple) carrying B; None=auto

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
        # the entropy pair is a container format: method-1 containers
        # decode only through their own decoder
        if self.backend == "deflate-full" and self.decoder == "auto":
            object.__setattr__(self, "decoder", "deflate-full")
        if self.decoder == "deflate-full" and self.backend != "deflate-full":
            raise ValueError(
                "decoder='deflate-full' decodes method-1 (entropy) containers "
                "only; pair it with backend='deflate-full'"
            )
        if self.backend == "lossy-fz":
            if self.symbol_size != 4:
                raise ValueError(
                    "backend='lossy-fz' quantizes f32 elements: "
                    f"symbol_size must be 4, got {self.symbol_size}"
                )
            eb = self.lossy_eb
            if eb is None or not isinstance(eb, (int, float)):
                raise ValueError(
                    "backend='lossy-fz' requires lossy_eb=<float error "
                    "bound> (0.0 selects the bit-exact lossless mode)"
                )
            if not math.isfinite(eb) or eb < 0:
                raise ValueError(f"lossy_eb must be a finite bound >= 0: {eb}")
            object.__setattr__(self, "lossy_eb", float(eb))
            if self.lossy_inner != "auto" and self.lossy_inner not in _BACKENDS:
                raise ValueError(
                    f"unknown backend {self.lossy_inner!r}; registered: "
                    f"{available_backends()} (also accepted: 'auto')"
                )
            if container_method(self.lossy_inner) == fmt.METHOD_LOSSY:
                raise ValueError(
                    f"lossy_inner={self.lossy_inner!r} is not a lossless "
                    "stage; pick a raw or deflate-full backend"
                )
            if self.decoder == "auto":
                object.__setattr__(self, "decoder", "lossy-fz")
        elif self.lossy_eb is not None:
            raise ValueError(
                f"lossy_eb is only consulted by backend='lossy-fz' "
                f"(got backend={self.backend!r})"
            )
        if self.decoder == "lossy-fz" and self.backend != "lossy-fz":
            raise ValueError(
                "decoder='lossy-fz' decodes method-2 (lossy) containers "
                "only; pair it with backend='lossy-fz'"
            )
        if isinstance(self.batch_axis, list):
            object.__setattr__(self, "batch_axis", tuple(self.batch_axis))
        if self.mesh is None:
            if self.batch_axis is not None:
                raise ValueError("batch_axis requires mesh=...")
            return
        if (
            self.backend not in ("sharded", "deflate-full", "lossy-fz")
            and self.decoder != "sharded"
        ):
            raise ValueError(
                "mesh=... is only consulted by the 'sharded' compressor/"
                "decoder and the batched 'deflate-full'/'lossy-fz' "
                "dispatches; set backend='sharded'/'deflate-full'/'lossy-fz' "
                "and/or decoder='sharded'"
            )
        from repro_torch.sharding import batch as shbatch  # lazy: avoid a cycle

        object.__setattr__(self, "mesh", shbatch.mesh_devices(self.mesh))
        if self.batch_axis is not None:
            shbatch.normalize_batch_axes(self.mesh, self.batch_axis)

    @property
    def min_match(self) -> int:
        return encode.min_match_length(self.symbol_size)


# Reference-package registry keys -> the port's.  The kernel entries map to
# their namesakes (``pallas-match`` to ``cuda-match``, named for its
# kernel); the plain XLA entries map to "auto", the sequential oracles, the
# batch layer and the two container formats to theirs.
_JAX_BACKENDS = {
    "xla": "auto", "pallas-match": "cuda-match", "fused": "fused",
    "fused-deflate": "fused-deflate", "fused-mono": "fused-mono", "auto": "auto",
    "xla-scan": "torch-scan", "deflate-full": "deflate-full", "lossy-fz": "lossy-fz",
    "sharded": "sharded",
}
_JAX_DECODERS = {
    "xla-parallel": "auto", "fused": "fused", "fused-mono": "fused-mono",
    "auto": "auto", "xla-scan": "torch-scan", "deflate-full": "deflate-full",
    "lossy-fz": "lossy-fz", "sharded": "sharded",
}
_JAX_FIELDS = {
    "symbol_size", "window", "chunk_symbols", "chunks_per_block", "backend",
    "decoder", "mesh", "batch_axis", "lossy_eb", "lossy_inner",
}


def config_from_jax(fields: dict) -> LZSSConfig:
    """An ``LZSSConfig`` from ``dataclasses.asdict`` of a reference config.

    Raises ``ValueError`` for unknown fields and entries, and for a mesh: a
    jax ``Mesh`` does not cross, so the caller passes the port's own (a
    sequence of torch devices) instead.
    """
    unknown = set(fields) - _JAX_FIELDS
    if unknown:
        raise ValueError(f"unknown reference LZSSConfig fields: {sorted(unknown)}")
    mapped = {}
    for key, table in (("backend", _JAX_BACKENDS), ("decoder", _JAX_DECODERS)):
        name = fields.get(key, "auto")
        if name not in table:
            raise ValueError(f"unknown reference {key} {name!r}")
        mapped[key] = table[name]
    if fields.get("mesh") is not None or fields.get("batch_axis") is not None:
        raise ValueError(
            "a jax Mesh does not cross into repro_torch: pass torch devices "
            "instead, LZSSConfig(mesh=(torch.device('cuda', 0), ...))"
        )
    inner = fields.get("lossy_inner", "auto")
    if inner not in _JAX_BACKENDS:
        raise ValueError(f"lossy_inner={inner!r} is not ported yet")
    return LZSSConfig(
        symbol_size=fields.get("symbol_size", 2),
        window=fields.get("window", 128),
        chunk_symbols=fields.get("chunk_symbols", autotune.DEFAULT_CHUNK_SYMBOLS),
        chunks_per_block=fields.get("chunks_per_block"),
        lossy_eb=fields.get("lossy_eb"),
        lossy_inner=_JAX_BACKENDS[inner],
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
    the default.  A backend may instead define ``compress_many(symbols,
    cfg, orig_bytes)`` for the whole (B, nc, C) batch with the same result;
    ``lzss_many`` then calls it in place of the two seams.  A backend that
    owns a whole container format instead
    defines ``compress(symbols, cfg, orig_bytes)`` for one (nc, C) buffer,
    returning ``(buffer (cap,) uint8, total bytes)``, and
    ``container_method``, the method byte its containers carry.
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
    """The one-launch compressor on a CUDA device, plain PyTorch on the CPU."""
    return "fused-mono" if torch.device(device).type == "cuda" else "torch"


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

    def matches(self, symbols, cfg):
        return match.find_matches(symbols, window=cfg.window)

    def kernel1(self, symbols, cfg):
        lengths, offsets = self.matches(symbols, cfg)
        emitted = self.selector(lengths, min_match=cfg.min_match)
        fields = encode.token_fields(
            lengths, emitted, min_match=cfg.min_match, symbol_size=cfg.symbol_size
        )
        return dict(lengths=lengths, offsets=offsets, emitted=emitted, **fields)


class TorchScanBackend(TorchBackend):
    """The paper's sequential selection walk (equivalence oracle)."""

    name = "torch-scan"
    selector = staticmethod(encode.select_tokens_scan)


class CudaMatchBackend(TorchBackend):
    """The CUDA match-only kernel, then the plain selector, prefix sums and
    ``emit_torch``."""

    name = "cuda-match"

    def matches(self, symbols, cfg):
        from repro_torch.kernels import ops

        return ops.lz_match(symbols, window=cfg.window, symbol_size=cfg.symbol_size)


class FusedBackend:
    """The CUDA Kernel I (matching, selection and the local prefix sum in
    one launch), then the plain ``emit_torch`` tail."""

    name = "fused"

    def kernel1(self, symbols, cfg):
        from repro_torch.kernels import ops

        out = ops.lz_kernel1(
            symbols, window=cfg.window, min_match=cfg.min_match,
            symbol_size=cfg.symbol_size,
        )
        return dict(out, use_match=out["emitted"] & (out["lengths"] >= cfg.min_match))


class FusedDeflateBackend(FusedBackend):
    """The split CUDA path: Kernel I, then Kernel II and Kernel III."""

    name = "fused-deflate"

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


class FusedMonoBackend(FusedBackend):
    """Kernels I + II + III in one CUDA launch for a whole batch
    (kernels/lz_fused.py), through the ``compress_many`` hook; the headers
    are finalised after the one device-to-host read of the section totals.
    ``kernel1`` is the split Kernel I, for callers that want the match
    metadata alone."""

    name = "fused-mono"

    def compress_many(self, symbols, cfg, orig_bytes):
        from repro_torch.kernels import ops

        b, nc, c = symbols.shape
        s = cfg.symbol_size
        blobs, n_tokens, payload_sizes, totals = ops.lz_fused_mono(
            symbols, window=cfg.window, min_match=cfg.min_match, symbol_size=s,
            cap=fmt.max_compressed_bytes(nc * c * s, s, c), sec_flags=fmt.HEADER_BYTES + 8 * nc,
        )
        totals = totals.cpu().tolist()  # the one device-to-host read
        return _finalize_container(
            blobs, cfg, orig_bytes, nc=nc, c=c, n_tokens=n_tokens, payload_sizes=payload_sizes,
            flag_totals=[t[0] for t in totals], pay_totals=[t[1] for t in totals],
        )


class ShardedCompressor:
    """The batch split over ``cfg.mesh`` (sharding/batch.py), through the
    ``compress_many`` hook: every shard runs the default backend of its
    device, so each row's container is byte-identical to the unsharded
    dispatch.  ``mesh=None`` is the plain batched dispatch."""

    name = "sharded"

    def compress_many(self, symbols, cfg, orig_bytes):
        return _sharded_many(symbols, cfg, orig_bytes)


def _sharded_many(symbols, cfg, orig_bytes):
    from repro_torch.sharding import batch as shbatch  # lazy: avoid a cycle

    return shbatch.ShardedBatchRunner(cfg.mesh, cfg.batch_axis).compress_many(
        symbols, cfg, orig_bytes)


def _containers_many(backend, symbols, cfg, orig_bytes):
    """A container backend's batch: split over ``cfg.mesh`` when it has
    one, else one container at a time on the symbols' device."""
    if cfg.mesh is not None:
        return _sharded_many(symbols, cfg, orig_bytes)
    # each row goes straight into the (B, cap) output (the rows share a
    # capacity), so the batch is never held twice on the device
    out, totals = None, []
    for r in range(symbols.shape[0]):
        buf, total = backend.compress(symbols[r], cfg, int(orig_bytes[r]))
        if out is None:
            out = buf.new_empty((symbols.shape[0],) + tuple(buf.shape))
        out[r] = buf
        totals.append(int(total))
    return out, totals


class EntropyBackend:
    """Method-1 containers (core/entropy.py): the device's LZSS, then
    canonical Huffman over both sections, with gap-array entry points.
    ``compress_many`` honours ``cfg.mesh`` as the ``"sharded"`` entry
    does."""

    name = "deflate-full"
    container_method = fmt.METHOD_HUFFMAN

    def compress(self, symbols, cfg, orig_bytes=None):
        from repro_torch.core import entropy

        return entropy.compress_entropy(symbols, cfg, orig_bytes)

    def compress_many(self, symbols, cfg, orig_bytes):
        return _containers_many(self, symbols, cfg, orig_bytes)


class LossyFzBackend:
    """Method-2 containers (core/lossy.py): dual-quant, bitshuffle, then
    the ``cfg.lossy_inner`` lossless stage; ``lossy_eb == 0`` is the
    bit-exact lossless mode.  ``compress_many`` honours ``cfg.mesh``
    exactly like the entropy entry."""

    name = "lossy-fz"
    container_method = fmt.METHOD_LOSSY

    def compress(self, symbols, cfg, orig_bytes=None):
        from repro_torch.core import lossy

        return lossy.compress_lossy(symbols, cfg, orig_bytes)

    def compress_many(self, symbols, cfg, orig_bytes):
        return _containers_many(self, symbols, cfg, orig_bytes)


register_backend(TorchBackend())
register_backend(TorchScanBackend())
register_backend(CudaMatchBackend())
register_backend(FusedBackend())
register_backend(FusedDeflateBackend())
register_backend(FusedMonoBackend())
register_backend(ShardedCompressor())
register_backend(EntropyBackend())
register_backend(LossyFzBackend())


def container_method(name: str) -> int:
    """The container method a registry entry produces or consumes.

    ``format.METHOD_RAW`` for the byte-identical LZSS family (and
    ``"auto"``), ``METHOD_HUFFMAN`` / ``METHOD_LOSSY`` for the two
    container pairs; looked up on the registered instance of either
    registry.
    """
    name = _DECODER_ALIASES.get(name, name)
    if name == "auto":
        return fmt.METHOD_RAW
    entry = _BACKENDS.get(name) or _DECODERS.get(name)
    if entry is None:
        raise ValueError(f"unknown backend/decoder {name!r}")
    return getattr(entry, "container_method", fmt.METHOD_RAW)


# ------------------------------------------------------------- decoders


class DecoderBackend(Protocol):
    """Decode contract: per-chunk aligned sections -> symbols.

    ``decode`` maps (N, C//8) flag bytes, (N, C*S) payload bytes and (N,)
    token counts (the tensors ``deflate.gather_section`` rebuilds from a
    container) to (N, C) int32 symbols.  A decoder may define
    ``decode_many(blobs, n_tokens, payload_sizes, *, symbol_size,
    chunk_symbols, n_chunks)`` for a batch of containers, (B, L) uint8
    blobs and (B, nc) tables -> (B, nc, C) int32, which
    ``decompress_many_chunks`` calls in place of the section gathers (with
    ``method_params=`` too when its caller pins one, as the lossy decoder
    needs); or
    own the whole batched dispatch through ``decompress_many`` (the same
    arguments plus ``chunks_per_block``, ``mesh`` and ``batch_axis``), as
    ``"sharded"`` does.  A decoder that owns a whole
    container format also defines ``decode_blob(blob, header)`` — a flat
    uint8 tensor holding the container's live bytes and its host-parsed
    ``format.Header`` -> (nc, C) int32 symbols — and ``container_method``.
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
    """The one-launch decoder on a CUDA device, plain PyTorch on the CPU."""
    return "fused-mono" if torch.device(device).type == "cuda" else "torch-parallel"


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
    uses_block_geometry = False  # plain PyTorch: no kernel geometry to tune

    def decode(self, flag_bytes, payload, n_tokens, *, symbol_size):
        return decode_mod.decode_parallel(flag_bytes, payload, n_tokens, symbol_size=symbol_size)


class TorchScanDecoder:
    """Sequential token walk (equivalence oracle)."""

    name = "torch-scan"
    uses_block_geometry = False  # plain PyTorch: no kernel geometry to tune

    def decode(self, flag_bytes, payload, n_tokens, *, symbol_size):
        return decode_mod.decode_scan(flag_bytes, payload, n_tokens, symbol_size=symbol_size)


class FusedDecoder:
    """The CUDA decoder, on sections gathered by plain PyTorch."""

    name = "fused"

    def decode(self, flag_bytes, payload, n_tokens, *, symbol_size):
        from repro_torch.kernels import ops

        return ops.lz_decode(flag_bytes, payload, n_tokens, symbol_size=symbol_size)


class FusedMonoDecoder(FusedDecoder):
    """The decoder in one CUDA launch for a whole batch of raw containers
    (kernels/lz_decode_mono.py): each chunk's sections are read in place
    from the blob, so the section gathers drop out.  It has no
    ``decode_blob`` hook: batches stay one launch.  The section-level
    ``decode`` (sections already gathered) is the split CUDA decoder."""

    name = "fused-mono"

    def decode_many(self, blobs, n_tokens, payload_sizes, *, symbol_size, chunk_symbols,
                    n_chunks):
        from repro_torch.kernels import ops

        if tuple(n_tokens.shape) != (blobs.shape[0], n_chunks):
            raise ValueError(
                f"tables of shape {tuple(n_tokens.shape)} for {blobs.shape[0]} containers "
                f"of {n_chunks} chunks"
            )
        return ops.lz_decode_mono(
            blobs, n_tokens, payload_sizes, symbol_size=symbol_size, chunk_symbols=chunk_symbols
        )


class ShardedDecoder:
    """The decode-side mirror of ``ShardedCompressor``: the batched entry
    point dispatches through the ``decompress_many`` hook, which splits the
    B dimension over the mesh passed at dispatch and runs the device's
    default decoder per shard; ``mesh=None`` is the plain batched
    dispatch.  Container batches (``decode_blob`` decoders) never reach
    it: ``lzss.decompress_many`` splits their rows over the mesh itself."""

    name = "sharded"

    def decompress_many(self, blobs, n_tokens, payload_sizes, *, symbol_size,
                        chunk_symbols, n_chunks, chunks_per_block=None, mesh=None,
                        batch_axis=None):
        from repro_torch.sharding import batch as shbatch  # lazy: avoid a cycle

        runner = shbatch.ShardedBatchRunner(mesh, batch_axis)
        return runner.decompress_many(
            blobs, n_tokens, payload_sizes, symbol_size=symbol_size,
            chunk_symbols=chunk_symbols, n_chunks=n_chunks, chunks_per_block=chunks_per_block,
        )


class EntropyDecoder:
    """Method-1 containers: gap-array Huffman decode of both sections, then
    the device's LZSS decoder.  The section-level ``decode`` (sections
    already decoded) delegates to the device's decoder."""

    name = "deflate-full"
    container_method = fmt.METHOD_HUFFMAN

    def decode(self, flag_bytes, payload, n_tokens, *, symbol_size):
        return get_decoder("auto", flag_bytes.device).decode(
            flag_bytes, payload, n_tokens, symbol_size=symbol_size
        )

    def decode_blob(self, blob, header):
        from repro_torch.core import entropy

        return entropy.decode_blob_entropy(blob, header)


class LossyFzDecoder:
    """Method-2 containers: inner lossless decode, bit-plane untranspose,
    Lorenzo reconstruction and the exact-outlier overlay."""

    name = "lossy-fz"
    container_method = fmt.METHOD_LOSSY

    def static_params(self, header):
        """The (mode, inner method) pair a batch of lossy blobs must share."""
        return (header.lossy_mode, header.inner_method)

    def decode(self, flag_bytes, payload, n_tokens, *, symbol_size):
        raise ValueError(
            "lossy-fz containers (method byte 2) have no flag/payload "
            "sections; decode them through decode_blob (lzss.decompress)"
        )

    def decode_many(self, blobs, n_tokens, payload_sizes, *, symbol_size, chunk_symbols,
                    n_chunks, method_params=()):
        """A batch of lossy containers whose ``(mode, inner_method)`` the
        caller pins (the reference's static ``method_params``): the tables
        are unused (method-2 containers hold zeros there)."""
        from repro_torch.core import lossy

        if symbol_size != 4:
            raise ValueError(
                "lossy-fz containers hold f32 element streams "
                f"(symbol_size=4); got symbol_size={symbol_size}"
            )
        if len(method_params) != 2:
            raise ValueError(
                "lossy-fz decode requires method_params=(mode, inner_method) "
                "recovered from the container header; decode through "
                "lzss.decompress, or pass method_params explicitly"
            )
        mode, inner_method = method_params
        return lossy.decode_many_lossy(blobs, chunk_symbols=chunk_symbols, n_chunks=n_chunks,
                                       mode=mode, inner_method=inner_method)

    def decode_blob(self, blob, header):
        from repro_torch.core import lossy

        if header.symbol_size != 4:
            raise ValueError(
                "lossy-fz containers hold f32 element streams "
                f"(symbol_size=4); got symbol_size={header.symbol_size}"
            )
        return lossy.decode_blob_lossy(blob, header)


register_decoder(TorchParallelDecoder())
register_decoder(TorchScanDecoder())
register_decoder(FusedDecoder())
register_decoder(FusedMonoDecoder())
register_decoder(ShardedDecoder())
register_decoder(EntropyDecoder())
register_decoder(LossyFzDecoder())


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


def lzss_many(backend, symbols: torch.Tensor, cfg: LZSSConfig, orig_bytes):
    """Raw method-0 containers of (B, nc, C) symbols through ``backend`` ->
    ((B, cap) uint8 blobs, list of B totals): its ``compress_many`` hook
    when it has one, else its Kernel-I and emit seams, Kernel I over all
    B * nc chunks at once.  The raw stages of the two container formats
    come here too."""
    b, nc, c = symbols.shape
    s = cfg.symbol_size
    if fmt.max_compressed_bytes(nc * c * s, s, c) >= 2**31:
        raise ValueError(
            f"{nc * c * s} bytes per buffer is over the int32 section offsets; "
            f"split the input"
        )
    many = getattr(backend, "compress_many", None)
    if many is not None:
        return many(symbols, cfg, list(orig_bytes))
    k1 = backend.kernel1(symbols.reshape(b * nc, c), cfg)
    k1 = {k: v.reshape(b, nc, *v.shape[1:]) for k, v in k1.items()}
    emit = getattr(backend, "emit", emit_torch)
    return emit(symbols, k1, cfg, list(orig_bytes))


def compress_many_chunks(symbols: torch.Tensor, cfg: LZSSConfig, orig_bytes=None):
    """(B, nc, C) int32 symbols -> ((B, cap) uint8 blobs, list of B totals).

    Row ``b`` holds a complete container in its first ``totals[b]`` bytes,
    zeros beyond.  ``orig_bytes`` (B host ints) are the true pre-padding
    byte counts for the headers; by default the padded size ``nc * C * S``.
    A backend with a ``compress`` hook builds its containers one buffer at
    a time (split over ``cfg.mesh`` by its ``compress_many`` hook); the raw
    backends run ``lzss_many`` (one launch for the batch through a
    ``compress_many`` hook).
    """
    if symbols.dim() != 3 or symbols.shape[2] != cfg.chunk_symbols:
        raise ValueError(
            f"symbols must be (B, nc, {cfg.chunk_symbols}), got {tuple(symbols.shape)}"
        )
    b, nc, c = symbols.shape
    if orig_bytes is None:
        orig_bytes = [nc * c * cfg.symbol_size] * b
    backend = get_backend(cfg.backend, symbols.device)
    if getattr(backend, "compress", None) is None:
        return lzss_many(backend, symbols, cfg, orig_bytes)
    many = getattr(backend, "compress_many", None)
    if many is not None:
        return many(symbols, cfg, list(orig_bytes))
    return _containers_many(backend, symbols, cfg, orig_bytes)


def compress_chunks(symbols: torch.Tensor, cfg: LZSSConfig, orig_bytes=None):
    """(nc, C) int32 symbols -> ((cap,) uint8 container buffer, total bytes)."""
    blobs, totals = compress_many_chunks(
        symbols[None], cfg, None if orig_bytes is None else [orig_bytes]
    )
    return blobs[0], totals[0]


def decompress_many_chunks(blobs, n_tokens, payload_sizes, *, symbol_size,
                           chunk_symbols, n_chunks, decoder="auto", chunks_per_block=None,
                           mesh=None, batch_axis=None, method_params=()):
    """(B, L) uint8 blobs + (B, nc) tables -> (B, nc, C) int32 symbols.

    ``blobs`` need only cover each container's live bytes: the section
    gathers are clipped and masked.  A decoder that owns the dispatch (the
    ``"sharded"`` entry, through its ``decompress_many`` hook) gets
    ``mesh`` / ``batch_axis``; other decoders never see them.  Otherwise
    the decoder runs once over all B * nc chunks: through
    its ``decode_many`` hook when it has one, else on the gathered
    sections.  ``method_params`` is the reference's static per-method pin,
    passed to a ``decode_many`` hook when given: ``decoder="lossy-fz"``
    decodes a batch of method-2 containers with ``method_params=(mode,
    inner_method)``.  ``chunks_per_block`` is accepted for the reference's
    signature and has no effect on the Hopper kernels.
    """
    c, s, nc = chunk_symbols, symbol_size, n_chunks
    b = blobs.shape[0]
    dec = get_decoder(decoder, blobs.device)
    owner = getattr(dec, "decompress_many", None)
    if owner is not None:
        return owner(blobs, n_tokens, payload_sizes, symbol_size=s, chunk_symbols=c,
                     n_chunks=nc, chunks_per_block=chunks_per_block, mesh=mesh,
                     batch_axis=batch_axis)
    many = getattr(dec, "decode_many", None)
    if many is not None:
        pin = {"method_params": method_params} if method_params else {}
        return many(blobs, n_tokens, payload_sizes, symbol_size=s, chunk_symbols=c, n_chunks=nc,
                    **pin)
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
                      n_chunks, decoder="auto", chunks_per_block=None):
    """(L,) uint8 container bytes + (nc,) tables -> (nc, C) int32 symbols."""
    return decompress_many_chunks(
        blob[None], n_tokens[None], payload_sizes[None], symbol_size=symbol_size,
        chunk_symbols=chunk_symbols, n_chunks=n_chunks, decoder=decoder,
        chunks_per_block=chunks_per_block,
    )[0]


# ------------------------------------------------------- tuned geometry


def _tunes_block_geometry() -> bool:
    """Whether a committed C leaves the tuner a g to choose: tuning on and
    more than one rung on the g ladder.  On Hopper the ladder has one rung
    (no kernel reads g), so the resolvers below pass their input through."""
    return autotune.enabled() and len(autotune.CHUNKS_PER_BLOCK_CANDIDATES) > 1


def resolve_chunk_geometry(cfg: LZSSConfig) -> LZSSConfig:
    """Pin ``chunks_per_block`` eagerly, before the kernels run.

    The host wrappers (``lzss.compress`` / ``compress_many``) call this
    first, as the reference does before its jit boundary: when the tuner
    has a g to choose and the user set no pin, the tuned g is resolved
    here and baked into the config.  Otherwise (one rung on the g ladder,
    tuning disabled, or an explicit pin) the config passes through
    unchanged.
    """
    if cfg.chunks_per_block is not None or not _tunes_block_geometry():
        return cfg
    g = autotune.block_geometry(
        symbol_size=cfg.symbol_size,
        chunk_symbols=cfg.chunk_symbols,
        direction="compress",
        window=cfg.window,
    )
    return dataclasses.replace(cfg, chunks_per_block=g)


def resolve_decode_geometry(chunks_per_block, *, symbol_size: int, chunk_symbols: int,
                            decoder="auto", device=None):
    """Decode-side mirror of ``resolve_chunk_geometry``.

    Returns the ``chunks_per_block`` to pass into ``decompress_chunks`` /
    ``decompress_many_chunks``: the caller's pin if given, the tuned g when
    the tuner has a g to choose, else ``None``.  ``decoder`` resolves on
    ``device`` (``None``: the card); decoders that run no kernel (the plain
    entries mark themselves ``uses_block_geometry = False``) skip the tuner.
    """
    if chunks_per_block is not None or not _tunes_block_geometry():
        return chunks_per_block
    dev = "cuda" if device is None else device
    if not getattr(get_decoder(decoder, dev), "uses_block_geometry", True):
        return None  # geometry never reaches a kernel: nothing to tune
    return autotune.block_geometry(
        symbol_size=symbol_size,
        chunk_symbols=chunk_symbols,
        direction="decompress",
    )


def tuned_config(symbol_size: int = 2, window: int = 128, **overrides) -> LZSSConfig:
    """An ``LZSSConfig`` with autotuned (chunk_symbols, chunks_per_block).

    Consults ``autotune.tuned_chunk_geometry`` — the joint sweep over C —
    for the current card; with tuning disabled (no card, or
    ``REPRO_AUTOTUNE=0``) this is ``LZSSConfig(...)`` with the static
    geometry (C=2048, g=8).  ``chunk_symbols`` changes container bytes, so
    use this only when *creating* containers, never to reinterpret existing
    ones (their geometry is in the header).  Explicit ``chunk_symbols`` /
    ``chunks_per_block`` overrides win over the tuner.
    """
    c, g = autotune.tuned_chunk_geometry(symbol_size=symbol_size, window=window)
    overrides.setdefault("chunk_symbols", c)
    overrides.setdefault("chunks_per_block", g)
    return LZSSConfig(symbol_size=symbol_size, window=window, **overrides)


DEFAULT_CONFIG = LZSSConfig()  # paper default: C=2048, S=2, W=128

# window "levels" exposed to users (paper §3.2.3: level 1-4 trade ratio/speed)
WINDOW_LEVELS = {1: 32, 2: 64, 3: 128, 4: 255}
