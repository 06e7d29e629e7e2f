"""The write direction: ``repro_torch.core.lzss.compress(field, config)``
on a device-resident field; a call ends when the container is on the host.

The check decodes each kept container with the benchmark's own decoder
(``reference/gplz.py``) and holds the bytes to the configuration's
guarantee; ``bad_containers`` counts containers the decoder refuses or
whose returned sizes disagree with their bytes (limit 0).
"""

from __future__ import annotations

import torch

from bench.ops import _codec
from bench.reference import gplz

ENTRY = "compress"
LIMITS = {"bad_containers": 0}
TABLES = 4 * (256 + 256 + 16 + 16 + 16 + 256)  # entropy.canonical_tables: six int32 tables


class Op:
    direction = "write"

    def __init__(self, run):
        from repro_torch.core import lzss

        self.run = run
        self.lzss = lzss
        self.fields = _codec.typed_fields(run)
        self.cfgs = _codec.configs(run, lzss)
        self.field_bytes = run.program_fields.shape[1]
        self.bad_sizes = 0

    def __len__(self):
        return len(self.fields)

    def call(self, i):
        return self.lzss.compress(self.fields[i], self.cfgs[i], device=self.run.device)

    def sizes(self, i, out):
        """(field bytes, stored bytes) of one call."""
        if out.total_bytes != out.data.size or out.orig_bytes != self.field_bytes:
            self.bad_sizes += 1
        return out.orig_bytes, out.data.size

    def kept(self, out):
        return out.data

    def release(self):
        self.fields = self.cfgs = None

    def check(self, kept: dict) -> list:
        """One dict of compared numbers a kept call."""
        run = self.run
        rows = [{"bad_containers": self.bad_sizes}]
        for i, blob in kept.items():
            try:
                y = gplz.decode(blob, run.device)
            except gplz.ContainerError as e:
                run.log(f"field {i}: the reference refuses the container: {e}")
                rows.append({"bad_containers": 1})
                y = torch.zeros(0, dtype=torch.uint8, device=run.device)
            rows.append(run.guarantee.compare(run.fields[i], y, run.config["guarantee"]))
        return rows

    def traced_counts(self, call) -> tuple:
        """(bytes copied, host syncs) that the program's tracer counts for one
        call on the card's registry: the container's D2H and every small
        copy's site, as ``tests/test_torch_trace.py`` counts them a path."""
        from repro_torch.core import format as fmt

        codec = self.run.config["codec"]
        backend = codec.get("backend", "auto")
        totals = 8  # pipeline.totals: one row of two int32
        if backend == "deflate-full":  # + entropy.lz's header, the histograms, two bit counts
            d2h = totals + fmt.HEADER_BYTES + 2 * 256 * 4 + 2 * 8
            h2d = fmt.HEADER_BYTES + 2 * TABLES + fmt.HEADER_BYTES + fmt.ENTROPY_META_FIXED
            return call.stored_bytes + d2h + h2d, 21
        if backend == "lossy-fz" and codec.get("lossy_inner") == "deflate-full":
            d2h = totals + fmt.HEADER_BYTES + 2 * 256 * 4 + 2 * 8
            h2d = (2 * 4 + fmt.HEADER_BYTES + 2 * TABLES + fmt.HEADER_BYTES
                   + fmt.ENTROPY_META_FIXED + fmt.HEADER_BYTES + fmt.LOSSY_META_FIXED)
            return call.stored_bytes + d2h + h2d, 26
        if backend in ("auto", "fused-mono"):
            return call.stored_bytes + totals + fmt.HEADER_BYTES, 3
        raise NotImplementedError(f"no traced counts for backend {backend!r}")
