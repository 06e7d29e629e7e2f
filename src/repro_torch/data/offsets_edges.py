"""Seeded inputs at the edges of Kernel II, the global prefix sums.

Kernel II (``csrc/lz_scatter.cu``, ``global_offsets``) gives a row one
block of 1,024 threads and reads it in a frame that starts at the row's
first 16-byte boundary at or before ``n_tokens``' row start: a lane takes
one int4 vector of 4 chunks a round, a warp up to 4 rounds of 128 chunks
a tile, so a tile holds up to 16,384 chunks.  A row whose frame fits one
tile scans its flag and payload sizes in one pass; a longer row takes
tiles with carries.  The tests and ``chip_smoke.py`` hold the kernel to
its plain version on these inputs, and the plain version to the reference
package.

``offsets_inputs(kind, rows, nc, seed)`` gives (rows, nc) int32
``n_tokens`` and ``payload_sizes``:

  zeros     all zeros
  literals  every chunk all literals at C = 2048, S = 4: 2048 tokens and
            8192 payload bytes, the largest sums (at nc = 262,144 the
            payload total is 2^31: every implementation wraps mod 2^32,
            and they are compared so)
  random    tokens in [0, 2048], payload bytes in [0, 8192]
  ragged    the same with n_tokens never a multiple of 8
  last      zeros but the last chunk of each row (2047 tokens, 8191 bytes)

at every nc of ``NCS`` (1 to 262,144: both sides of the warp's round of
128 chunks, the round of all warps of 4,096 and the tile of 16,384, and
the frame's shift, which makes nc = 16,384 two tiles where the row starts
off a 16-byte boundary) and every ``ROWS``.  With rows > 1 and nc not a
multiple of 4, the rows start on every residue mod 16.  ``view_at`` gives
the same values as a view that starts 4, 8 or 12 bytes past a 16-byte
boundary (``VIEW_BYTES``).
"""

from __future__ import annotations

import numpy as np
import torch

NCS = (1, 3, 5, 31, 32, 33, 1023, 1024, 1025, 16383, 16384, 16385, 32767, 32768, 32769,
       65541, 262144)
ROWS = (1, 3, 8)
KINDS = ("zeros", "literals", "random", "ragged", "last")
VIEW_BYTES = (4, 8, 12)
MAX_TOKENS, MAX_PAYLOAD = 2048, 8192  # C = 2048 all literals at S = 4


def offsets_inputs(kind: str, rows: int, nc: int, seed: int = 0):
    """(rows, nc) int32 ``n_tokens`` and ``payload_sizes`` of ``kind`` (see
    the module docstring)."""
    shape = (rows, nc)
    rng = np.random.default_rng([seed, rows, nc, KINDS.index(kind) if kind in KINDS else 99])
    if kind == "zeros":
        nt, ps = np.zeros(shape, np.int32), np.zeros(shape, np.int32)
    elif kind == "literals":
        nt, ps = np.full(shape, MAX_TOKENS, np.int32), np.full(shape, MAX_PAYLOAD, np.int32)
    elif kind == "random":
        nt = rng.integers(0, MAX_TOKENS + 1, shape).astype(np.int32)
        ps = rng.integers(0, MAX_PAYLOAD + 1, shape).astype(np.int32)
    elif kind == "ragged":
        nt = (8 * rng.integers(0, MAX_TOKENS // 8, shape) + rng.integers(1, 8, shape))
        nt = nt.astype(np.int32)
        ps = rng.integers(0, MAX_PAYLOAD + 1, shape).astype(np.int32)
    elif kind == "last":
        nt, ps = np.zeros(shape, np.int32), np.zeros(shape, np.int32)
        nt[:, -1], ps[:, -1] = MAX_TOKENS - 1, MAX_PAYLOAD - 1
    else:
        raise ValueError(f"unknown Kernel II edge {kind!r}: one of {KINDS}")
    return nt, ps


def edge_cases():
    """Every (kind, rows, nc) of the edges."""
    return [(kind, rows, nc) for kind in KINDS for nc in NCS for rows in ROWS]


def view_at(t: torch.Tensor, shift: int) -> torch.Tensor:
    """A contiguous view holding ``t``'s values whose first element lies
    ``shift`` bytes (a multiple of 4) past a 16-byte boundary."""
    size = t.element_size()
    if shift % size or not 0 <= shift < 16:
        raise ValueError(f"a shift of {shift} bytes: a multiple of {size} below 16")
    buf = torch.empty(t.numel() + 16 // size, dtype=t.dtype, device=t.device)
    k = (shift - buf.data_ptr()) % 16 // size
    view = buf[k : k + t.numel()].view(t.shape)
    view.copy_(t)
    return view
