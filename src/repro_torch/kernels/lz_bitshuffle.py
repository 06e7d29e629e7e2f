"""The bitshuffle kernels: bit-plane transpose of the lossy-fz unit stream.

The CUDA kernels are in ``csrc/lz_bitshuffle.cu``; they replace the TPU
kernels ``repro/kernels/lz_bitshuffle.py:_shuffle_kernel`` and
``_unshuffle_kernel``.  ``*_plain`` are their plain PyTorch versions (the
reference's ``shuffle_xla`` / ``unshuffle_xla``); ``kernels/ops.py``
chooses by the tensor's device.  Units are 16-bit patterns held in
``torch.int16`` tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BLOCK_UNITS = 512  # uint16 units per bitshuffle block
BLOCK_BYTES = BLOCK_UNITS * 2
PLANES = 16
PLANE_BYTES = BLOCK_UNITS // 8


def _units(units):
    if units.dtype != torch.int16 or units.dim() != 1 or units.numel() % BLOCK_UNITS:
        raise ValueError(
            f"bitshuffle takes a 1-D int16 tensor of whole {BLOCK_UNITS}-unit "
            f"blocks, got {units.dtype} {tuple(units.shape)}"
        )
    return units.contiguous()


def _shuffled(shuffled):
    if shuffled.dtype != torch.uint8 or shuffled.dim() != 1 or shuffled.numel() % BLOCK_BYTES:
        raise ValueError(
            f"bitunshuffle takes a 1-D uint8 tensor of whole {BLOCK_BYTES}-byte "
            f"blocks, got {shuffled.dtype} {tuple(shuffled.shape)}"
        )
    return shuffled.contiguous()


def bitshuffle_plain(units):
    """(N,) int16 units -> (2N,) uint8 bit planes; N % 512 == 0."""
    u = _units(units)
    nb = u.numel() // BLOCK_UNITS
    dev = u.device
    v = u.reshape(nb, BLOCK_UNITS).to(torch.int32) & 0xFFFF
    planes = torch.arange(PLANES, device=dev, dtype=torch.int32)
    bits = (v[:, :, None] >> planes) & 1                      # (nb, 512, 16)
    bits = bits.reshape(nb, PLANE_BYTES, 8, PLANES)
    weight = torch.arange(8, device=dev, dtype=torch.int32)[None, None, :, None]
    packed = torch.sum(bits << weight, dim=2, dtype=torch.int32)  # (nb, 64, 16)
    return packed.transpose(1, 2).reshape(nb * BLOCK_BYTES).to(torch.uint8)


def bitunshuffle_plain(shuffled):
    """(2N,) uint8 bit planes -> (N,) int16 units; 2N % 1024 == 0."""
    p = _shuffled(shuffled)
    nb = p.numel() // BLOCK_BYTES
    dev = p.device
    p = p.reshape(nb, PLANES, PLANE_BYTES).to(torch.int32)
    pos = torch.arange(8, device=dev, dtype=torch.int32)
    bits = (p[:, :, :, None] >> pos) & 1                      # (nb, 16, 64, 8)
    bits = bits.permute(0, 2, 3, 1)                           # (nb, 64, 8, 16)
    weight = torch.arange(PLANES, device=dev, dtype=torch.int32)
    vals = torch.sum(bits << weight, dim=3, dtype=torch.int32)  # (nb, 64, 8)
    vals = torch.where(vals >= 1 << 15, vals - (1 << 16), vals)  # the u16 bit pattern
    return vals.reshape(nb * BLOCK_UNITS).to(torch.int16)


def _out(out, n, dtype, device, name):
    """The (n,) prefix of ``out`` (a fresh tensor when None) that a kernel
    writes: a contiguous tensor of ``dtype`` on ``device`` holding at least
    ``n`` elements."""
    if out is None:
        return torch.empty(n, dtype=dtype, device=device)
    if out.dtype != dtype or out.device != device or not out.is_contiguous() or out.numel() < n:
        raise ValueError(
            f"{name} out= takes a contiguous {dtype} tensor on {device} of at least {n} "
            f"elements, got {out.dtype} {tuple(out.shape)} on {out.device}"
        )
    return out.reshape(-1)[:n]


def write_into(out, result, name):
    """``result`` copied into the prefix of ``out``, as the kernels write it
    (the plain versions' ``out=``); ``result`` itself when ``out`` is None."""
    if out is None:
        return result
    prefix = _out(out, result.numel(), result.dtype, result.device, name)
    prefix.copy_(result)
    return prefix


def bitshuffle_cuda(units, out=None):
    """The same function as ``bitshuffle_plain`` by one CUDA launch; with
    ``out``, written into its prefix (see ``_out``) and that prefix returned.
    Any alignment is exact: pointers that are not 16-byte aligned take the
    kernel's byte-wise loads and stores."""
    _build.require_cuda("bitshuffle", units)
    u = _units(units)
    nb = u.numel() // BLOCK_UNITS
    dst = _out(out, nb * BLOCK_BYTES, torch.uint8, u.device, "bitshuffle")
    lib = _build.library("lz_bitshuffle")
    code = lib.lz_bitshuffle_launch(u.data_ptr(), nb, dst.data_ptr(), _build.stream(u))
    _build.check(lib, code, "bitshuffle (lz_bitshuffle_launch)")
    return dst


def bitunshuffle_cuda(shuffled, out=None):
    """The same function as ``bitunshuffle_plain`` by one CUDA launch; ``out``
    and alignment as for ``bitshuffle_cuda``."""
    _build.require_cuda("bitunshuffle", shuffled)
    p = _shuffled(shuffled)
    nb = p.numel() // BLOCK_BYTES
    dst = _out(out, nb * BLOCK_UNITS, torch.int16, p.device, "bitunshuffle")
    lib = _build.library("lz_bitshuffle")
    code = lib.lz_bitunshuffle_launch(p.data_ptr(), nb, dst.data_ptr(), _build.stream(p))
    _build.check(lib, code, "bitunshuffle (lz_bitunshuffle_launch)")
    return dst


def bitshuffle_occupancy():
    """{kernel: (registers a thread, resident CTAs per SM)} of the two CUDA
    kernels, from the CUDA occupancy API."""
    out = (ctypes.c_int * 4)()
    lib = _build.library("lz_bitshuffle")
    _build.check(lib, lib.lz_bitshuffle_occupancy(ctypes.cast(out, ctypes.c_void_p)),
                 "bitshuffle occupancy")
    return {"bitshuffle": (out[0], out[1]), "bitunshuffle": (out[2], out[3])}
