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
from bench.ops.compress import TABLES

ENTRY = "decompress"
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

    def traced_counts(self, call) -> tuple:
        """(bytes copied, host syncs) that the program's tracer counts for one
        call on the card's registry: the container's H2D and ``_validated``'s
        host copy of it, the bytes' D2H, and every small copy's site, as
        ``tests/test_torch_trace.py`` counts them a path."""
        from repro_torch.core import format as fmt

        codec = self.run.config["codec"]
        backend = codec.get("backend", "auto")
        nc = -(-call.field_bytes // (codec["symbol_size"] * codec["chunk_symbols"]))
        moved = 2 * call.stored_bytes + call.field_bytes
        if backend == "deflate-full":  # the codes' tables; the codebooks
            return moved + 2 * TABLES + 256, 15
        if backend == "lossy-fz" and codec.get("lossy_inner") == "deflate-full":
            _, _, inner_nc = fmt.lossy_stream_geometry(nc, codec["chunk_symbols"],
                                                       fmt.LOSSY_MODE_QUANT)
            h2d = 2 * TABLES + 2 * 4 + 1  # tables, two f32 scalars, the outlier mask's True
            d2h = 256 + 4 + fmt.HEADER_BYTES + 8 * inner_nc + fmt.ENTROPY_META_FIXED
            return moved + h2d + d2h, 20
        if backend in ("auto", "fused-mono"):
            return moved + 8 * nc, 4  # the A/B tables beside the container
        raise NotImplementedError(f"no traced counts for backend {backend!r}")
