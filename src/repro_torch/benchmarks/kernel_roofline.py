"""Roofline of the GPULZ kernels on one NVIDIA H100 (the PyTorch port).

The port's twin of the reference's ``benchmarks/kernel_roofline.py``.  The
reference modelled the Pallas kernel on a TPU's vector unit; this models
the port's CUDA kernels on the H100 with the constants of
``launch/roofline.py`` (``HBM_BW``, ``INT32_OPS``), and it is the one home
of the arithmetic behind ``chip_smoke.py``'s ``bound_ms`` column:

  operations: the walking kernels' symbol compares (``kernel1_compares``:
              what a per-thread far-to-near window walk makes on the
              data, counted on the data), one op a position for the
              scatter and the decoders, two a chunk for Kernel II, one a
              byte for the histogram, 16 a unit for the bitshuffle pair
  bytes:      each input read once and each output written once
              (``kernel_bytes_ops``)
  bound:      the larger of bytes / HBM_BW and operations / INT32_OPS

``analytic`` prints, for each window W and symbol size S, the one-launch
compressor's compute and memory bounds in GB/s of input on a corpus slice
(the compares depend on the data).  The second part counts the plain
PyTorch ``pipeline.compress_chunks`` (the unfused path: each of the W
offsets materialises its equality and run-length tensors) under
``roofline.CountingMode`` at the reference's shape (nc=64, C=2048, S=2,
W=64), in flops and bytes a symbol, beside the one-launch kernel's bytes a
symbol: the fused-vs-unfused comparison of the paper's Fig. 4 (c) vs (d).

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_roofline [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, resolve_device
from repro_torch.core import format as fmt
from repro_torch.launch.roofline import HBM_BW, INT32_OPS

SUB = 1 << fmt.DEFAULT_SUB_LOG2  # gap-array sub-block: decoded bytes per entry point
WINDOWS = (32, 64, 128, 255)
DATASET = "hurr-quant"  # the corpus the compares are counted on


def kernel1_compares(sym, window: int, c: int) -> int:
    """Symbol compares a per-thread far-to-near window walk makes on ``sym``:
    the operations of the walking kernels' bound.  The warp walk makes other
    compares; the bound keeps this count so that it stays comparable with
    the bounds recorded for the per-thread walk it replaced.

    For each position the walk visits offsets d = min(i, W) .. 1 while the
    cap min(d, 255, C - i) exceeds the best length so far; a visited offset
    costs one compare, plus min(run, cap - 1) more when its first symbol
    matches.  Computed offset by offset on ``sym``'s device, like the plain
    matcher.
    """
    from repro_torch.core.match import capped_run_lengths

    x = sym.to(torch.int32)
    nc = x.shape[0]
    idx = torch.arange(c, device=x.device, dtype=torch.int32).expand(nc, c)
    padded = torch.cat([torch.zeros(nc, window, dtype=torch.int32, device=x.device), x], 1)
    best = torch.zeros_like(x)
    total = 0
    for d in range(window, 0, -1):
        cap = torch.clamp(c - idx, max=min(d, 255))
        visited = (idx >= d) & (cap > best)
        eq = (x == padded[:, window - d : window - d + c]) & (idx >= d)
        levels = 0
        while (1 << levels) < min(d, 255):
            levels += 1
        run = torch.minimum(capped_run_lengths(eq, levels), cap)
        hit = eq & visited
        total += int(visited.sum()) + int(torch.minimum(run, cap - 1)[hit].sum())
        best = torch.where(visited & (run > best), run, best)
    return total


def kernel_bytes_ops(name: str, *, nc=0, c=0, cap=0, compares=0, flag_bytes=0,
                     payload_bytes=0, length=0, nbits=0, nsub=0, n_units=0) -> tuple:
    """(bytes, operations) of one launch of kernel ``name`` (``ops.KERNELS``'
    names): each input read once, each output written once.  ``nc`` chunks
    of ``c`` symbols (int32 in, ``pos = nc * c``), ``cap`` the container's
    bytes, ``compares`` from ``kernel1_compares``, ``flag_bytes`` /
    ``payload_bytes`` a container's two sections, ``length`` the
    histogram's bytes, ``nbits`` / ``nsub`` the gap decoder's stream bits
    and sub-blocks, ``n_units`` the bitshuffle pair's u16 units."""
    pos = nc * c
    table = {
        # symbols in; lengths, offsets, emitted, local offsets out; tables
        "lz_kernel1": (4 * pos + 13 * pos + 8 * nc, compares),
        "lz_global_offsets": (8 * nc + 8 * nc + 8, 2 * nc),
        "lz_scatter": (17 * pos + 8 * nc + cap, pos),
        "lz_decode": (flag_bytes + payload_bytes + 4 * nc + 4 * pos, pos),
        # the symbols in, the container (zeros included) and its tables out
        "lz_fused_mono": (4 * pos + cap + 8 * nc + 8, compares),
        # the compact sections and the tables in, 4 bytes out per symbol
        "lz_decode_mono": (flag_bytes + payload_bytes + 8 * nc + 4 * pos, pos),
        # the symbols in, lengths and offsets out; the walk's compares
        "lz_match": (4 * pos + 8 * pos, compares),
        "byte_histogram": (length + 4 * 256, length),
        # the stream, 12 bytes of entry point and 1 byte out per codeword's
        # sub-block slot; one range test per code length tried (the
        # stream's bit count) and one order lookup per codeword
        "huffman_gap_decode": ((nbits + 7) // 8 + 12 * nsub + 4 * (3 * 16 + 256) + SUB * nsub,
                               nbits + SUB * nsub),
        "bitshuffle": (4 * n_units, 16 * n_units),
        "bitunshuffle": (4 * n_units, 16 * n_units),
    }
    return table[name]


def bound_ms(nbytes: int, ops: int) -> tuple:
    """(the least milliseconds, "bytes" or "operations") on the H100."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / INT32_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _symbols(data: np.ndarray, s: int, c: int, dev) -> torch.Tensor:
    from repro_torch.core import pipeline

    n = data.size // (s * c) * (s * c)
    raw = torch.from_numpy(np.ascontiguousarray(data[:n])).to(dev)
    return pipeline.pack_symbols(raw, s).reshape(-1, c)


def analytic(run_unfused_comparison: bool = True, nbytes: int = 1 << 16,
             device=None) -> dict:
    """The H100 model's rows; returns ``{row name: value}``."""
    from repro_torch.data import datasets

    dev = resolve_device(device)
    data = datasets.load(DATASET, nbytes)
    c = 2048
    rows = {}
    print("# kernel_roofline: name,us_per_call,derived")
    for w in WINDOWS:
        for s in (1, 2, 4):
            sym = _symbols(data, s, c, dev)
            nc = sym.shape[0]
            pos = nc * c
            cap = fmt.max_compressed_bytes(pos * s, s, c)
            nbytes_k, ops = kernel_bytes_ops("lz_fused_mono", nc=nc, c=c, cap=cap,
                                             compares=kernel1_compares(sym, w, c))
            compute_gbs = INT32_OPS / (ops / pos) * s / 1e9
            memory_gbs = HBM_BW / (nbytes_k / pos) * s / 1e9
            by = "compute" if compute_gbs <= memory_gbs else "memory"
            rows[f"kernel/analytic/W{w}/S{s}"] = min(compute_gbs, memory_gbs)
            emit(f"kernel/analytic/W{w}/S{s}", 0.0,
                 f"{min(compute_gbs, memory_gbs):.2f}GB/s-{by}-bound"
                 f"|compares/sym={ops / pos:.2f}|bytes/sym={nbytes_k / pos:.2f}")
            rows[f"kernel/analytic/W{w}/S{s}/compute"] = compute_gbs
            rows[f"kernel/analytic/W{w}/S{s}/memory"] = memory_gbs
    if not run_unfused_comparison:
        return rows
    # the unfused plain pipeline under the counting mode
    from repro_torch.core import pipeline
    from repro_torch.launch import roofline

    nc, c, s, w = 64, 2048, 2, 64
    cfg = pipeline.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c, backend="torch")
    sym = _symbols(datasets.load(DATASET, nc * c * s), s, c, dev)
    _, counts = roofline.count(pipeline.compress_chunks, sym, cfg)
    n = nc * c
    cap = fmt.max_compressed_bytes(n * s, s, c)
    fused_bytes = kernel_bytes_ops("lz_fused_mono", nc=nc, c=c, cap=cap)[0] / n
    rows["kernel/torch-unfused/W64/flops-per-symbol"] = counts["flops"] / n
    rows["kernel/torch-unfused/W64/bytes-per-symbol"] = counts["bytes"] / n
    rows["kernel/fused-mono/W64/bytes-per-symbol"] = fused_bytes
    rows["kernel/fused-vs-unfused/hbm-reduction"] = counts["bytes"] / n / fused_bytes
    emit("kernel/torch-unfused/W64/flops-per-symbol", 0.0, f"{counts['flops'] / n:.0f}")
    emit("kernel/torch-unfused/W64/bytes-per-symbol", 0.0, f"{counts['bytes'] / n:.0f}")
    emit("kernel/fused-mono/W64/bytes-per-symbol", 0.0, f"{fused_bytes:.2f}")
    emit("kernel/fused-vs-unfused/hbm-reduction", 0.0,
         f"{counts['bytes'] / n / fused_bytes:.0f}x")
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nbytes", type=int, default=1 << 16,
                    help="hurr-quant slice the compares are counted on")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args()
    analytic(nbytes=args.nbytes, device=args.device)
