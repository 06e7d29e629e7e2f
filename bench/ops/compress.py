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

LIMITS = {"bad_containers": 0}


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
