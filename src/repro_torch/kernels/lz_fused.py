"""The one-launch compressor: Kernels I, II and III for a whole batch.

The CUDA kernel is ``csrc/lz_fused.cu`` (a persistent cooperative kernel:
Kernel I per chunk into a staging workspace, a grid barrier, the global
prefix sums over the whole grid, a grid barrier, the copies into the
containers).  It replaces the TPU kernel
``repro/kernels/lz_fused.py:_mono_kernel``.
``lz_fused_mono_plain`` is its plain PyTorch version, the plain Kernels
I -> II -> III composed; ``kernels/ops.py`` chooses by the tensor's device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, lz_match, lz_scatter


def lz_fused_mono_plain(symbols, *, window, min_match, symbol_size, cap, sec_flags):
    """(B, nc, C) int32 symbols -> (blobs, n_tokens, payload_sizes, totals).

    ``blobs`` is (B, cap) uint8: each row's flag section at ``sec_flags``,
    its payload section right after, zeros everywhere else (the header and
    table region included, for the caller to fill).  ``n_tokens`` and
    ``payload_sizes`` are (B, nc) int32; ``totals`` (B, 2) int32 holds
    (flag_total, pay_total) per row.
    """
    b, nc, c = symbols.shape
    k1 = lz_match.lz_kernel1_plain(
        symbols.reshape(b * nc, c), window=window, min_match=min_match,
        symbol_size=symbol_size,
    )
    k1 = {k: v.reshape(b, nc, *v.shape[1:]) for k, v in k1.items()}
    flag_off, pay_off, totals = lz_scatter.global_offsets_plain(
        k1["n_tokens"], k1["payload_sizes"]
    )
    blobs = lz_scatter.scatter_plain(
        symbols, k1["lengths"], k1["offsets"], k1["emitted"], k1["local_off"], flag_off,
        pay_off, symbol_size=symbol_size, min_match=min_match, cap=cap, sec_flags=sec_flags,
    )
    return blobs, k1["n_tokens"], k1["payload_sizes"], totals


def lz_fused_mono_cuda(symbols, *, window, min_match, symbol_size, cap, sec_flags):
    """The same function by one launch of the CUDA kernel."""
    if symbols.dim() != 3:
        raise ValueError(
            f"the one-launch compressor takes (B, nc, C) symbols, got {tuple(symbols.shape)}"
        )
    b, nc, c = symbols.shape
    x = lz_match.check_chunks(
        "the one-launch compressor", symbols.reshape(b * nc, c), window=window,
        symbol_size=symbol_size,
    )
    if sec_flags + nc * (c // 8 + c * symbol_size) > cap:
        raise ValueError(f"cap={cap} cannot hold the sections of {nc} chunks past {sec_flags}")
    dev = x.device
    i32 = dict(dtype=torch.int32, device=dev)
    # the chunk ticket and the per-segment (256 chunks) flag and payload sums
    work = torch.zeros(1 + 2 * b * -(-nc // 256), **i32)
    # the staged sections, and 16 bytes for the copies' word reads past them
    stage = torch.empty(b * nc * (c // 8 + c * symbol_size) + 16, dtype=torch.uint8, device=dev)
    flag_off = torch.empty(b * nc, **i32)
    pay_off = torch.empty(b * nc, **i32)
    blobs = torch.empty(b, cap, dtype=torch.uint8, device=dev)
    n_tokens = torch.empty(b, nc, **i32)
    payload_sizes = torch.empty(b, nc, **i32)
    totals = torch.empty(b, 2, **i32)
    lib = _build.library("lz_fused")
    code = lib.lz_fused_mono_launch(
        x.data_ptr(), b, nc, c, symbol_size, window, min_match, sec_flags, cap,
        work.data_ptr(), stage.data_ptr(), flag_off.data_ptr(), pay_off.data_ptr(),
        blobs.data_ptr(), n_tokens.data_ptr(), payload_sizes.data_ptr(), totals.data_ptr(),
        _build.stream(x),
    )
    _build.check(lib, code, "one-launch compressor (lz_fused_mono_launch)")
    return blobs, n_tokens, payload_sizes, totals
