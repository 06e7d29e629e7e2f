"""Kernel I: matching + token selection + local prefix sum, per chunk.

The CUDA kernel is ``csrc/lz_match.cu`` (one thread block per chunk, the
chunk in shared memory; its source note says what bounds it on the H100).
It replaces the TPU kernel ``repro/kernels/lz_match.py:_fused_kernel``.
``lz_kernel1_plain`` is its plain PyTorch version; ``kernels/ops.py``
chooses between the two by the tensor's device.
"""

from __future__ import annotations

import torch

from repro_torch.core import autotune
from repro_torch.kernels import _build, ref


def lz_kernel1_plain(symbols, *, window, min_match, symbol_size):
    """(N, C) int32 symbols -> dict(lengths, offsets, emitted, local_off,
    payload_sizes, n_tokens): (N, C) int32 / bool and (N,) int32."""
    return ref.lz_kernel1(
        symbols, window=window, min_match=min_match, symbol_size=symbol_size
    )


def lz_kernel1_cuda(symbols, *, window, min_match, symbol_size):
    """The same function by one launch of the CUDA kernel."""
    if symbols.device.type != "cuda" or symbols.dim() != 2:
        raise ValueError(
            f"Kernel I takes an (N, C) CUDA tensor, got {tuple(symbols.shape)} "
            f"on {symbols.device}"
        )
    n, c = symbols.shape
    if c % 8 or c < 8:
        raise ValueError(f"chunk_symbols must be a positive multiple of 8: {c}")
    if symbol_size not in (1, 2, 4) or not 1 <= window <= 255:
        raise ValueError(f"bad geometry: symbol_size={symbol_size}, window={window}")
    autotune.validate_block_geometry(c, 1, symbol_size)
    x = symbols.to(torch.int32).contiguous()
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
