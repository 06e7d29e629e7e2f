"""The read direction: ``repro_torch.core.lzss.decompress(container)`` on a
host container; a call ends when the bytes are on the host.

Set-up makes one container a field with the program's ``compress``, held
in host memory.  The check holds each kept call's bytes to the
configuration's guarantee against the field itself, so it needs nothing
the program made.
"""

from __future__ import annotations

import torch

from bench.ops import _codec

LIMITS = {}


class Op:
    direction = "read"

    def __init__(self, run):
        from repro_torch.core import lzss

        self.run = run
        self.lzss = lzss
        cfgs = _codec.configs(run, lzss)
        self.containers = [
            lzss.compress(f, c, device=run.device).data
            for f, c in zip(_codec.typed_fields(run), cfgs)
        ]

    def __len__(self):
        return len(self.containers)

    def call(self, i):
        return self.lzss.decompress(self.containers[i], device=self.run.device)

    def sizes(self, i, out):
        """(field bytes, stored bytes) of one call."""
        return out.nbytes, self.containers[i].size

    def kept(self, out):
        return out

    def release(self):
        self.containers = None

    def check(self, kept: dict) -> list:
        run = self.run
        return [
            run.guarantee.compare(run.fields[i], torch.from_numpy(out).to(run.device),
                                  run.config["guarantee"])
            for i, out in kept.items()
        ]
