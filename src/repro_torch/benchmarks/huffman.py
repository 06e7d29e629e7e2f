"""Byte-level canonical Huffman size estimator (host, numpy).

The port's twin of the reference's ``benchmarks/huffman.py``.  Used by the
Table-3 use case: original cuSZ = Huffman(quant codes); improved cuSZ =
Huffman(GPULZ(quant codes)).  Size-exact (codebook + bitstream),
encoder-only: the use case reports ratios and throughput of the GPULZ
stage; full Huffman decode rides the ``deflate-full`` container backend
(core/entropy.py), not this estimator.

The code-length assignment lives in ``repro_torch.core.entropy``; this
module keeps only the size arithmetic on top of it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.entropy import huffman_code_lengths

__all__ = [
    "huffman_code_lengths",
    "huffman_compressed_bytes",
    "huffman_ratio",
]


def huffman_compressed_bytes(data: np.ndarray) -> int:
    """Exact canonical-Huffman payload size + 256-entry length table."""
    d = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    counts = np.bincount(d, minlength=256)
    lengths = huffman_code_lengths(counts)
    bits = int((counts * lengths).sum())
    return (bits + 7) // 8 + 256  # payload + codebook lengths


def huffman_ratio(data: np.ndarray) -> float:
    d = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return d.size / max(1, huffman_compressed_bytes(d))
