"""Kernel I (matching + token selection + local prefix sum) and the
match-only kernel, per chunk.

The CUDA kernels are in ``csrc/lz_match.cu`` (one thread block per chunk,
the chunk in shared memory; its source note says what bounds them on the
H100).  They replace the TPU kernels ``repro/kernels/lz_match.py:_fused_kernel``
and ``_match_kernel``.  ``lz_kernel1_plain`` / ``lz_match_plain`` are their
plain PyTorch versions; ``kernels/ops.py`` chooses by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import autotune
from repro_torch.kernels import _build, ref


def lz_kernel1_plain(symbols, *, window, min_match, symbol_size):
    """(N, C) int32 symbols -> dict(lengths, offsets, emitted, local_off,
    payload_sizes, n_tokens): (N, C) int32 / bool and (N,) int32."""
    return ref.lz_kernel1(
        symbols, window=window, min_match=min_match, symbol_size=symbol_size
    )


def check_chunks(what, symbols, *, window, symbol_size):
    """Raise unless ``symbols`` is an (N, C) CUDA tensor of a geometry the
    window-walking kernels take; returns it as contiguous int32."""
    if symbols.device.type != "cuda" or symbols.dim() != 2:
        raise ValueError(
            f"{what} takes an (N, C) CUDA tensor, got {tuple(symbols.shape)} "
            f"on {symbols.device}"
        )
    c = symbols.shape[1]
    if c % 8 or c < 8:
        raise ValueError(f"chunk_symbols must be a positive multiple of 8: {c}")
    if symbol_size not in (1, 2, 4) or not 1 <= window <= 255:
        raise ValueError(f"bad geometry: symbol_size={symbol_size}, window={window}")
    autotune.validate_block_geometry(c, 1, symbol_size)
    return symbols.to(torch.int32).contiguous()


def lz_kernel1_cuda(symbols, *, window, min_match, symbol_size):
    """The same function by one launch of the CUDA kernel."""
    x = check_chunks("Kernel I", symbols, window=window, symbol_size=symbol_size)
    n, c = x.shape
    i32 = dict(dtype=torch.int32, device=x.device)
    lengths = torch.empty(n, c, **i32)
    offsets = torch.empty(n, c, **i32)
    emitted = torch.empty(n, c, dtype=torch.uint8, device=x.device)
    local_off = torch.empty(n, c, **i32)
    payload_sizes = torch.empty(n, **i32)
    n_tokens = torch.empty(n, **i32)
    lib = _build.library("lz_match")
    code = lib.lz_kernel1_launch(
        x.data_ptr(), n, c, symbol_size, window, min_match,
        lengths.data_ptr(), offsets.data_ptr(), emitted.data_ptr(),
        local_off.data_ptr(), payload_sizes.data_ptr(), n_tokens.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "Kernel I (lz_kernel1_launch)")
    return dict(
        lengths=lengths,
        offsets=offsets,
        emitted=emitted.view(torch.bool),
        local_off=local_off,
        payload_sizes=payload_sizes,
        n_tokens=n_tokens,
    )


def lz_match_plain(symbols, *, window, symbol_size):
    """(N, C) int32 symbols -> (lengths, offsets), each (N, C) int32
    (``core/match.py:find_matches``; ``symbol_size`` only sizes the
    kernel's shared row)."""
    return ref.lz_match(symbols, window=window)


def lz_match_cuda(symbols, *, window, symbol_size):
    """The same function by one launch of the CUDA match-only kernel."""
    x = check_chunks("the match kernel", symbols, window=window, symbol_size=symbol_size)
    n, c = x.shape
    lengths = torch.empty(n, c, dtype=torch.int32, device=x.device)
    offsets = torch.empty(n, c, dtype=torch.int32, device=x.device)
    lib = _build.library("lz_match")
    code = lib.lz_match_launch(
        x.data_ptr(), n, c, symbol_size, window, lengths.data_ptr(), offsets.data_ptr(),
        _build.stream(x),
    )
    _build.check(lib, code, "match kernel (lz_match_launch)")
    return lengths, offsets


def walk_occupancy(*, symbol_size, chunk_symbols):
    """{kernel: (registers a thread, resident blocks per SM)} of the three
    kernels that walk the window (Kernel I, the match-only kernel, the
    one-launch compressor) at this geometry, from the CUDA occupancy API."""
    out = (ctypes.c_int * 4)()
    ptr = ctypes.cast(out, ctypes.c_void_p)
    lib = _build.library("lz_match")
    _build.check(lib, lib.lz_match_occupancy(symbol_size, chunk_symbols, ptr), "occupancy")
    res = {"lz_kernel1": (out[0], out[1]), "lz_match": (out[2], out[3])}
    lib = _build.library("lz_fused")
    _build.check(lib, lib.lz_fused_occupancy(symbol_size, chunk_symbols, ptr), "occupancy")
    res["lz_fused_mono"] = (out[0], out[1])
    return res
