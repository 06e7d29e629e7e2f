"""LZ4-block-format size counter (ratio baseline for Fig. 8/9).

Faithful LZ4 *format* accounting: greedy hash-table matching over a 64 KB
window, min match 4, sequences of [token | literal-length ext | literals |
2-byte offset | match-length ext], final literal run.  Numpy/host — the
paper's nvCOMP LZ4 baseline is closed-source; what matters for Fig. 8 is the
format's ratio behaviour (fixed token overhead vs LZSS flag bits).  The
port's own copy of the reference package's counter (numpy only), so that
the port's twins import nothing of it.
"""

from __future__ import annotations

import numpy as np

MIN_MATCH = 4
WINDOW = 1 << 16


def lz4_compressed_size(data: np.ndarray, max_bytes: int | None = None) -> int:
    """Size in bytes of a greedy LZ4-block encoding of ``data``."""
    d = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    if max_bytes is not None:
        d = d[:max_bytes]
    n = d.size
    if n < 13:
        return n + 1
    # hash table over 4-byte sequences
    dv = d[: n - 3].astype(np.uint32)
    seq = dv | (d[1 : n - 2].astype(np.uint32) << 8) \
        | (d[2 : n - 1].astype(np.uint32) << 16) \
        | (d[3:n].astype(np.uint32) << 24)
    hashes = ((seq * np.uint32(2654435761)) >> np.uint32(16)).astype(np.int64)
    table = {}
    out = 0
    i = 0
    anchor = 0
    limit = n - 12  # LZ4: last 12 bytes are literals
    db = d.tobytes()
    while i < limit:
        h = hashes[i]
        cand = table.get(h, -1)
        table[h] = i
        if (
            cand >= 0
            and i - cand <= WINDOW
            and db[cand : cand + 4] == db[i : i + 4]
        ):
            ln = 4
            maxl = n - i - 5
            while ln < maxl and db[cand + ln] == db[i + ln]:
                ln += 1
            lit = i - anchor
            out += 1 + (max(0, lit - 15) + 254) // 255 + lit  # token+ext+lits
            out += 2 + (max(0, ln - 4 - 15) + 254) // 255     # offset+ext
            i += ln
            anchor = i
        else:
            i += 1
    lit = n - anchor
    out += 1 + (max(0, lit - 15) + 254) // 255 + lit
    return out


def lz4_ratio(data: np.ndarray, max_bytes: int | None = None) -> float:
    d = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    if max_bytes is not None:
        d = d[:max_bytes]
    return d.size / max(1, lz4_compressed_size(d))
