"""The entropy-stage kernels: byte histogram and gap-array Huffman decode.

The CUDA kernels are in ``csrc/lz_entropy.cu``; they replace the TPU
kernels ``repro/kernels/lz_entropy.py:_hist_kernel`` and
``_gap_decode_kernel``.  ``*_plain`` are their plain PyTorch versions (the
reference's XLA scatter-add histogram and its ``_decode_scan``, vectorised
over sub-blocks); ``kernels/ops.py`` chooses by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

N_SYMBOLS = 256
MAX_CODE_LEN = 15


def _check_range(buf, start, length):
    if start < 0 or length < 0 or start + length > buf.numel():
        raise ValueError(
            f"histogram range [{start}, {start + length}) is outside the "
            f"{buf.numel()}-byte buffer"
        )


# ------------------------------------------------------------- histogram


def byte_histogram_plain(buf, start: int, length: int):
    """(256,) int32 counts of the byte values of ``buf[start : start + length]``.

    ``buf`` is a flat integer tensor of byte values; positions outside the
    range go to a 257th slot that is dropped, as in the reference.
    """
    b = buf.reshape(-1)
    _check_range(b, start, length)
    idx = torch.arange(b.numel(), device=b.device)
    in_range = (idx >= start) & (idx < start + length)
    slot = torch.where(in_range, b.to(torch.int64) & 0xFF, N_SYMBOLS)
    ones = torch.ones_like(slot, dtype=torch.int32)
    hist = torch.zeros(N_SYMBOLS + 1, dtype=torch.int32, device=b.device)
    return hist.index_add_(0, slot, ones)[:N_SYMBOLS]


def histogram_occupancy():
    """(registers a thread, resident blocks per SM) of the CUDA histogram,
    from the CUDA occupancy API."""
    out = (ctypes.c_int * 2)()
    lib = _build.library("lz_entropy")
    _build.check(lib, lib.lz_byte_histogram_occupancy(ctypes.cast(out, ctypes.c_void_p)),
                 "histogram occupancy")
    return out[0], out[1]


def byte_histogram_cuda(buf, start: int, length: int):
    """The same function by one launch of the CUDA histogram kernel."""
    _build.require_cuda("byte_histogram", buf)
    if buf.dtype != torch.uint8:
        raise ValueError(f"byte_histogram takes a uint8 buffer, got {buf.dtype}")
    b = buf.reshape(-1).contiguous()
    _check_range(b, start, length)
    out = torch.zeros(N_SYMBOLS, dtype=torch.int32, device=b.device)
    lib = _build.library("lz_entropy")
    code = lib.lz_byte_histogram_launch(b.data_ptr(), start, length, out.data_ptr(), _build.stream(b))
    _build.check(lib, code, "byte_histogram (lz_byte_histogram_launch)")
    return out


# ---------------------------------------------------------- gap decoder


def _gap_args(blob, wstarts, rems, first, count, base, order, sub):
    if wstarts.dim() != 1 or wstarts.shape != rems.shape:
        raise ValueError(
            f"wstarts and rems must be two (nsub,) tensors, got "
            f"{tuple(wstarts.shape)} and {tuple(rems.shape)}"
        )
    for name, t, n in (("first", first, MAX_CODE_LEN + 1), ("count", count, MAX_CODE_LEN + 1),
                       ("base", base, MAX_CODE_LEN + 1), ("order", order, N_SYMBOLS)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    if sub <= 0 or sub % 4:
        raise ValueError(f"sub must be a positive multiple of 4: {sub}")


def huffman_gap_decode_plain(blob, wstarts, rems, first, count, base, order, *, sub: int):
    """Gap-array canonical-Huffman decode -> (nsub, sub) uint8 symbols.

    Sub-block ``t`` decodes ``sub`` codewords starting at bit
    ``8 * wstarts[t] + rems[t]`` of ``blob``; ``first`` / ``count`` /
    ``base`` (16,) and ``order`` (256,) are the canonical tables of
    ``core/entropy.canonical_tables``.  Bytes past the end of ``blob`` read
    as zeros.  A window that matches no length takes length 1 (the
    reference's argmax over an all-false row): such lanes lie past a
    section's live bytes, and the caller masks them.
    """
    _gap_args(blob, wstarts, rems, first, count, base, order, sub)
    dev = blob.device
    b = blob.reshape(-1)
    n = b.numel()
    padded = torch.cat([b.to(torch.int64) & 0xFF, torch.zeros(1, dtype=torch.int64, device=dev)])
    ls = torch.arange(1, MAX_CODE_LEN + 1, device=dev, dtype=torch.int64)
    first, count, base = (t.to(torch.int64) for t in (first, count, base))
    order = order.to(torch.uint8)
    fc, cn = first[1:][None, :], count[1:][None, :]
    bit = wstarts.to(torch.int64) * 8 + rems.to(torch.int64)
    out = torch.empty(bit.shape[0], sub, dtype=torch.uint8, device=dev)

    def at(p):
        return padded[torch.where((p >= 0) & (p < n), p, n)]

    for k in range(sub):
        pos = bit >> 3
        w24 = (at(pos) << 16) | (at(pos + 1) << 8) | at(pos + 2)
        win = (w24 >> (9 - (bit & 7))) & ((1 << MAX_CODE_LEN) - 1)
        cand = win[:, None] >> (MAX_CODE_LEN - ls)[None, :]
        ok = (cand >= fc) & (cand - fc < cn)
        sel = torch.argmax(ok.to(torch.int32), dim=1)  # first hit, else 0
        lsel = sel + 1
        csel = cand.gather(1, sel[:, None])[:, 0]
        sidx = base[lsel] + csel - first[lsel]
        out[:, k] = order[sidx.clamp(0, N_SYMBOLS - 1)]
        bit = bit + lsel
    return out


def gap_decode_occupancy():
    """(registers a thread, resident blocks per SM) of the CUDA gap decoder,
    from the CUDA occupancy API."""
    out = (ctypes.c_int * 2)()
    lib = _build.library("lz_entropy")
    _build.check(lib, lib.lz_gap_decode_occupancy(ctypes.cast(out, ctypes.c_void_p)),
                 "gap decoder occupancy")
    return out[0], out[1]


def huffman_gap_decode_cuda(blob, wstarts, rems, first, count, base, order, *, sub: int):
    """The same function by one launch of the CUDA gap decoder."""
    _build.require_cuda("huffman_gap_decode", blob, wstarts, rems, first, count, base, order)
    _gap_args(blob, wstarts, rems, first, count, base, order, sub)
    if blob.dtype != torch.uint8:
        raise ValueError(f"huffman_gap_decode takes a uint8 blob, got {blob.dtype}")
    if sub % 16:
        raise ValueError(f"the CUDA gap decoder stores 16 bytes at a time: sub={sub}")
    b = blob.reshape(-1).contiguous()
    ws = wstarts.to(torch.int64).contiguous()
    rm = rems.to(torch.int32).contiguous()
    tabs = [t.to(torch.int32).contiguous() for t in (first, count, base, order)]
    nsub = ws.shape[0]
    out = torch.empty(nsub, sub, dtype=torch.uint8, device=b.device)
    lib = _build.library("lz_entropy")
    code = lib.lz_gap_decode_launch(
        b.data_ptr(), b.numel(), ws.data_ptr(), rm.data_ptr(), nsub,
        *(t.data_ptr() for t in tabs), sub, out.data_ptr(), _build.stream(b),
    )
    _build.check(lib, code, "huffman_gap_decode (lz_gap_decode_launch)")
    return out
