"""Kernels II and III: global section offsets and the deflate-scatter.

The CUDA kernels are in ``csrc/lz_scatter.cu``; they replace the TPU
kernels ``repro/kernels/lz_scatter.py:_offsets_kernel`` (Kernel II) and
``_scatter_kernel`` (Kernel III).  Both take a batch of ``rows`` buffers of
``nc`` chunks each.  ``*_plain`` are their plain PyTorch versions, built
from ``core/deflate.py``; ``kernels/ops.py`` chooses by the tensor's device.
"""

from __future__ import annotations

import torch

from repro_torch.core import deflate
from repro_torch.kernels import _build


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(name, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} takes CUDA tensors, got one on {t.device}")


# ------------------------------------------------------------ Kernel II


def global_offsets_plain(n_tokens, payload_sizes):
    """(rows, nc) per-chunk sizes -> (flag_off, pay_off, totals).

    ``flag_off`` / ``pay_off`` are (rows, nc) int32 exclusive prefix sums of
    the flag sizes ceil(n_tokens / 8) and of the payload sizes; ``pay_off``
    is pre-based by the row's flag total.  ``totals`` is (rows, 2) int32:
    (flag_total, pay_total) per row.
    """
    fs = (n_tokens.to(torch.int32) + 7) // 8
    ps = payload_sizes.to(torch.int32)
    fcsum = torch.cumsum(fs, 1, dtype=torch.int32)
    pcsum = torch.cumsum(ps, 1, dtype=torch.int32)
    f_tot, p_tot = fcsum[:, -1], pcsum[:, -1]
    return fcsum - fs, pcsum - ps + f_tot[:, None], torch.stack([f_tot, p_tot], 1)


def global_offsets_cuda(n_tokens, payload_sizes):
    """The same function by one launch of the CUDA Kernel II."""
    _require_cuda("Kernel II", n_tokens, payload_sizes)
    if n_tokens.dim() != 2 or n_tokens.shape != payload_sizes.shape:
        raise ValueError(
            f"Kernel II takes two (rows, nc) tensors, got "
            f"{tuple(n_tokens.shape)} and {tuple(payload_sizes.shape)}"
        )
    rows, nc = n_tokens.shape
    nt = n_tokens.to(torch.int32).contiguous()
    ps = payload_sizes.to(torch.int32).contiguous()
    flag_off = torch.empty_like(nt)
    pay_off = torch.empty_like(nt)
    totals = torch.empty(rows, 2, dtype=torch.int32, device=nt.device)
    lib = _build.library("lz_scatter")
    code = lib.lz_global_offsets_launch(
        nt.data_ptr(), ps.data_ptr(), rows, nc,
        flag_off.data_ptr(), pay_off.data_ptr(), totals.data_ptr(), _stream(nt),
    )
    _build.check(lib, code, "Kernel II (lz_global_offsets_launch)")
    return flag_off, pay_off, totals


# ----------------------------------------------------------- Kernel III


def scatter_plain(symbols, lengths, offsets, emitted, local_off, flag_off, pay_off,
                  *, symbol_size, min_match, cap, sec_flags):
    """Kernel-I outputs of (rows, nc, C) chunks -> (rows, cap) uint8 blobs.

    Row ``r``'s flag section is written at ``sec_flags + flag_off[r]`` and
    its payload at ``sec_flags + pay_off[r]`` (pre-based by the flag
    total); every other byte is zero.
    """
    rows, nc, c = symbols.shape

    def flat(t):
        return t.reshape(rows * nc, c)

    emitted = flat(emitted)
    lengths = flat(lengths)
    use_match = emitted & (lengths >= min_match)
    sizes = torch.where(emitted, torch.where(use_match, 2, symbol_size), 0)
    fields = dict(use_match=use_match, sizes=sizes, local_off=flat(local_off))
    flag_bytes, flag_sizes = deflate.pack_flags(emitted, use_match)
    payload = deflate.build_chunk_payloads(
        flat(symbols), lengths, flat(offsets), fields, symbol_size=symbol_size
    )
    pay_sizes = sizes.sum(1, dtype=torch.int32)
    row_base = torch.arange(rows, device=symbols.device, dtype=torch.int64)[:, None] * cap
    out = torch.zeros(rows * cap, dtype=torch.int32, device=symbols.device)
    deflate.scatter_section(
        out, sec_flags, flag_bytes, flag_sizes, (flag_off + row_base).reshape(-1)
    )
    deflate.scatter_section(
        out, sec_flags, payload, pay_sizes, (pay_off + row_base).reshape(-1)
    )
    return out.to(torch.uint8).reshape(rows, cap)


def scatter_cuda(symbols, lengths, offsets, emitted, local_off, flag_off, pay_off,
                 *, symbol_size, min_match, cap, sec_flags):
    """The same function by one launch of the CUDA Kernel III."""
    _require_cuda("Kernel III", symbols, lengths, offsets, emitted, local_off,
                  flag_off, pay_off)
    rows, nc, c = symbols.shape
    for name, t, shape in (
        ("lengths", lengths, (rows, nc, c)), ("offsets", offsets, (rows, nc, c)),
        ("emitted", emitted, (rows, nc, c)), ("local_off", local_off, (rows, nc, c)),
        ("flag_off", flag_off, (rows, nc)), ("pay_off", pay_off, (rows, nc)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"Kernel III: {name} has shape {tuple(t.shape)}, expected {shape}")
    args = [t.to(dtype).contiguous() for t, dtype in (
        (symbols, torch.int32), (lengths, torch.int32), (offsets, torch.int32),
        (emitted, torch.uint8), (local_off, torch.int32), (flag_off, torch.int32),
        (pay_off, torch.int32),
    )]
    blob = torch.zeros(rows, cap, dtype=torch.uint8, device=symbols.device)
    lib = _build.library("lz_scatter")
    code = lib.lz_scatter_launch(
        *[a.data_ptr() for a in args], rows, nc, c, symbol_size, min_match,
        sec_flags, cap, blob.data_ptr(), _stream(blob),
    )
    _build.check(lib, code, "Kernel III (lz_scatter_launch)")
    return blob
