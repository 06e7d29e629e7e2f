"""The four cells of the first benchmark read what they read before the
harness took each cell's direction, entry point, copy counts and items
from its op: a traced CPU run of each at a small size, on the card's
registry with the kernels' launches counted, reads the values worked out
the old way, by the cell's name: one row of the fields an item, the
direction from the name's suffix, the copies and syncs of that cell."""

from __future__ import annotations

import pytest

from _perf_common import man, small  # noqa: F401
from bench import harness, roofline

SEED = 3_000_000_023
FIRST = ("isabel-quant-lz.write", "isabel-f32-fz.write", "isabel-quant-lz.read",
         "isabel-f32-fz.read")
# Each cell's readings the old way, frozen at the small size: the bytes a
# call copies besides the container (once each way, and once on the host in
# a read) and the field (in a read); its host syncs; its launches on the card.
OLD_EXTRA = {"isabel-quant-lz.write": 56, "isabel-f32-fz.write": 9104,
             "isabel-quant-lz.read": 8, "isabel-f32-fz.read": 7125}
OLD_SYNCS = {"isabel-quant-lz.write": 3, "isabel-f32-fz.write": 26,
             "isabel-quant-lz.read": 4, "isabel-f32-fz.read": 20}
OLD_LAUNCHES = {"isabel-quant-lz.write": 1, "isabel-f32-fz.write": 4,
                "isabel-quant-lz.read": 1, "isabel-f32-fz.read": 4}  # the card's (PERF.md)
FIELD_BYTES = {"isabel-quant-lz": 4096, "isabel-f32-fz": 8192}  # the small size's


@pytest.fixture
def card_paths(monkeypatch):
    """The card's registry on the CPU, with each CUDA kernel's launch
    counted and run by its plain twin, as on the card."""
    from repro_torch.core import pipeline
    from repro_torch.kernels import (lz_bitshuffle, lz_decode, lz_decode_mono, lz_entropy,
                                     lz_fused, lz_match, lz_scatter, ops)

    monkeypatch.setattr(pipeline, "default_backend", lambda device: "fused-mono")
    monkeypatch.setattr(pipeline, "default_decoder", lambda device: "fused-mono")
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    for mod, names in ((lz_match, ("lz_kernel1", "lz_match")),
                       (lz_scatter, ("global_offsets", "scatter")), (lz_decode, ("lz_decode",)),
                       (lz_fused, ("lz_fused_mono",)), (lz_decode_mono, ("lz_decode_mono",)),
                       (lz_entropy, ("byte_histogram", "huffman_gap_decode"))):
        for name in names:
            monkeypatch.setattr(mod, f"{name}_cuda", getattr(mod, f"{name}_plain"))
    for name in ("bitshuffle", "bitunshuffle"):
        plain = getattr(lz_bitshuffle, f"{name}_plain")
        monkeypatch.setattr(lz_bitshuffle, f"{name}_cuda", lambda x, out=None, p=plain, n=name:
                            lz_bitshuffle.write_into(out, p(x), n))


@pytest.fixture
def runs(monkeypatch):
    made = []

    class Recorded(harness.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(harness, "Run", Recorded)
    return made


@pytest.mark.parametrize("cell", FIRST)
def test_the_first_cells_read_what_they_read(man, cell, card_paths, runs):
    result, checks = harness.run_cell(man, cell, seed=SEED, seconds=0.3, trace=True,
                                      device="cpu", **small(man, cell))
    assert result["correct"], checks
    run = runs[0]
    assert run.program_fields.shape[1] == FIELD_BYTES[run.cell["config"]]
    variant = cell.rsplit(".", 1)[1]
    assert run.op.direction == variant
    compares = run.prepared["bench.metrics.kernels_roofline"]
    if variant == "write" and run.config.get("roofline_ops") == "window_walk_compares":
        codec = run.config["codec"]
        old = [roofline.window_walk_compares(
            roofline.symbols(f, codec["symbol_size"], codec["chunk_symbols"]), codec["window"])
            for f in run.program_fields]
        assert compares == old
    else:
        assert compares is None
    got = result["metrics"]
    calls = len(run.calls)
    moved = run.stored_bytes() * (1 if variant == "write" else 2)  # + _validated's copy
    moved += 0 if variant == "write" else run.field_bytes()
    want = (moved + calls * OLD_EXTRA[cell]) / run.field_bytes()
    assert got[f"copy_bytes_per_field_byte.{variant}"]["value"] == pytest.approx(want, rel=1e-12)
    assert got[f"host_syncs_per_call.{variant}"]["value"] == OLD_SYNCS[cell]
    assert got[f"launches_per_call.{variant}"]["value"] == OLD_LAUNCHES[cell]
