"""The batched write: ``repro_torch.core.lzss.compress_many(buffers, config)``
on a device-resident field stored as independently decodable chunks, as
nvCOMP's batched API stores an input.  Each field is cut from its start
into the traffic's ``buffer_bytes`` chunks (views, no copies; the last one
shorter), all of them one call; a call ends when the
``BatchedCompressResult`` is on the host.  Its stored bytes are the
containers' ``total_bytes``, not the (B, cap) buffer they arrive in.

The check decodes every container of each kept call with the benchmark's
own decoder (``reference/gplz.py``) and holds the call's bytes to the
configuration's guarantee against the field; ``bad_containers`` counts
containers the decoder refuses or whose returned sizes disagree with
their bytes or their buffer (limit 0).
"""

from __future__ import annotations

import torch

from bench.ops import _codec
from bench.reference import gplz

ENTRY = "compress_many"
LIMITS = {"bad_containers": 0}
small = _codec.small_batches


class Op:
    direction = "write"

    def __init__(self, run):
        from repro_torch.core import lzss

        self.run = run
        self.lzss = lzss
        self.items = _codec.batches(run)
        typed = _codec.typed_fields(run)
        self.cfgs = _codec.configs(run, lzss)
        self.bufs = [_codec.buffers(typed[k], ranges) for k, ranges in self.items]
        self.bad_sizes = 0

    def __len__(self):
        return len(self.items)

    def item_fields(self, i) -> list:
        """The flat byte slices item ``i`` compresses."""
        k, ranges = self.items[i]
        return [self.run.program_fields[k, a:b] for a, b in ranges]

    def call(self, i):
        k = self.items[i][0]
        return self.lzss.compress_many(self.bufs[i], self.cfgs[k], device=self.run.device)

    def sizes(self, i, out):
        """(field bytes, stored bytes) of one call."""
        want = [b - a for a, b in self.items[i][1]]
        if out.orig_bytes.tolist() != want or int(out.total_bytes.max()) > out.data.shape[1]:
            self.bad_sizes += 1
        return int(out.orig_bytes.sum()), int(out.total_bytes.sum())

    def kept(self, out):
        return [out.data[b, : int(out.total_bytes[b])] for b in range(len(out))]

    def release(self):
        self.bufs = self.cfgs = None

    def check(self, kept: dict) -> list:
        """One dict of compared numbers a kept call."""
        run = self.run
        rows = [{"bad_containers": self.bad_sizes}]
        for i, blobs in kept.items():
            k, ranges = self.items[i]
            parts = []
            for (a, b), y in zip(ranges, gplz.decode_many(blobs, run.device)):
                if isinstance(y, gplz.ContainerError):
                    run.log(f"field {k} bytes {a}-{b}: the reference refuses the container: {y}")
                    rows.append({"bad_containers": 1})
                    y = torch.zeros(0, dtype=torch.uint8, device=run.device)
                parts.append(y)
            rows.append(run.guarantee.compare(run.fields[k], torch.cat(parts),
                                              run.config["guarantee"]))
        return rows

    def traced_counts(self, call) -> tuple:
        """(bytes copied, host syncs) that the program's tracer counts for one
        call on the card's registry, as ``tests/test_torch_trace.py`` counts
        its path: a header's H2D a buffer, the section totals' read and the
        (B, cap) batch's D2H."""
        from repro_torch.core import format as fmt

        codec = self.run.config["codec"]
        if codec.get("backend", "auto") not in ("auto", "fused-mono"):
            raise NotImplementedError(f"no traced counts for backend {codec['backend']!r}")
        ranges = self.items[call.item][1]
        n = len(ranges)
        s, c = codec["symbol_size"], codec["chunk_symbols"]
        nc = -(-max(b - a for a, b in ranges) // (s * c))
        cap = fmt.max_compressed_bytes(nc * c * s, s, c)
        return n * fmt.HEADER_BYTES + 8 * n + n * cap, n + 2
