"""The batched read: ``repro_torch.core.lzss.decompress_many(batch)`` on a
``BatchedCompressResult`` held on the host, a field's chunks read back in
one call; a call ends when every chunk's bytes are on the host.

Set-up cuts the fields as ``compress_many.py`` does (the traffic's
``buffer_bytes``, a field's chunks a call) and makes each call's batch
with the program's ``compress_many``.  The check holds the bytes of every
chunk of each kept call, in order, to the configuration's guarantee
against the field itself, so it needs nothing the program made.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.ops import _codec

ENTRY = "decompress_many"
LIMITS = {}
small = _codec.small_batches


class Op:
    direction = "read"

    def __init__(self, run):
        from repro_torch.core import lzss

        self.run = run
        self.lzss = lzss
        self.items = _codec.batches(run)
        typed = _codec.typed_fields(run)
        cfgs = _codec.configs(run, lzss)
        self.batches = [
            lzss.compress_many(_codec.buffers(typed[k], ranges), cfgs[k], device=run.device)
            for k, ranges in self.items
        ]
        self.stored = [int(b.total_bytes.sum()) for b in self.batches]
        self.widest = [int(b.total_bytes.max()) for b in self.batches]

    def __len__(self):
        return len(self.items)

    def item_fields(self, i) -> list:
        """The flat byte slices item ``i`` restores."""
        k, ranges = self.items[i]
        return [self.run.program_fields[k, a:b] for a, b in ranges]

    def call(self, i):
        return self.lzss.decompress_many(self.batches[i], device=self.run.device)

    def sizes(self, i, out):
        """(field bytes, stored bytes) of one call."""
        return sum(o.nbytes for o in out), self.stored[i]

    def kept(self, out):
        return out

    def release(self):
        self.batches = None

    def check(self, kept: dict) -> list:
        run = self.run
        rows = []
        for i, outs in kept.items():
            k = self.items[i][0]
            got = torch.from_numpy(np.concatenate(outs)).to(run.device)
            rows.append(run.guarantee.compare(run.fields[k], got, run.config["guarantee"]))
        return rows

    def traced_counts(self, call) -> tuple:
        """(bytes copied, host syncs) that the program's tracer counts for one
        call on the card's registry, as ``tests/test_torch_trace.py`` counts
        its path: ``_validated``'s host copy of each container, their copy
        into the stacked batch, its H2D with the two (B, nc) tables, and a
        D2H a buffer."""
        codec = self.run.config["codec"]
        if codec.get("backend", "auto") not in ("auto", "fused-mono"):
            raise NotImplementedError(f"no traced counts for backend {codec['backend']!r}")
        ranges = self.items[call.item][1]
        n = len(ranges)
        nc = -(-max(b - a for a, b in ranges) // (codec["symbol_size"] * codec["chunk_symbols"]))
        stacked = n * self.widest[call.item]
        tables = 2 * n * nc * 4
        return 2 * self.stored[call.item] + stacked + tables + call.field_bytes, n + 3
