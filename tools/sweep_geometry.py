"""The chunk-width ladder of the autotuner on real data, timed on one card.

    python3 tools/sweep_geometry.py

For S in {1, 2, 4} and every C of ``autotune.CHUNK_SYMBOL_CANDIDATES``,
times the one-launch compressor (``lz_fused_mono``) and the one-launch
decoder (``lz_decode_mono``, on the compressor's container) on real data:
hurr-quant 128 MiB at S=2, rtm-float32 and tpch-string 64 MiB at S=4 and
S=1.  The Cs are timed in turns (ascending, then descending, three times),
each turn 10 launches between two CUDA events; printed are each C's mean and
spread, and beside it the tuner's own measure of that C on its synthetic
workload (``autotune._default_measure``), with the card's name and power
limit.  Every container is checked against the decoder before it is timed.
Needs a CUDA card and nvcc.
"""
import pathlib
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
from repro_torch import core  # noqa: E402
from repro_torch.core import autotune, format as fmt, pipeline as pl  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.kernels import _build, lz_decode_mono, lz_fused  # noqa: E402

card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(f"[sweep] {card}")
_build.build_all()
dev = torch.device("cuda")
LADDER = autotune.CHUNK_SYMBOL_CANDIDATES
REAL = {2: ("hurr-quant", 128 << 20), 4: ("rtm-float32", 64 << 20), 1: ("tpch-string", 64 << 20)}


def events(fn, reps=10):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def real_pair(s, flat, c):
    """(compress fn, decode fn) of the one-launch pair on ``flat`` at C."""
    nc = flat.numel() // c
    sym = flat[: nc * c].reshape(1, nc, c)
    kw = dict(window=128, min_match=core.LZSSConfig(symbol_size=s).min_match, symbol_size=s,
              cap=fmt.max_compressed_bytes(nc * c * s, s, c), sec_flags=fmt.HEADER_BYTES + 8 * nc)
    blobs, nt, ps, tot = lz_fused.lz_fused_mono_cuda(sym, **kw)
    dargs = (blobs[:, : kw["sec_flags"] + int(tot.sum())].contiguous(), nt, ps)
    got = lz_decode_mono.lz_decode_mono_cuda(*dargs, symbol_size=s, chunk_symbols=c)
    assert torch.equal(got, sym), f"decode at S={s} C={c} is not exact"
    return (lambda: lz_fused.lz_fused_mono_cuda(sym, **kw),
            lambda: lz_decode_mono.lz_decode_mono_cuda(*dargs, symbol_size=s, chunk_symbols=c))


for s in (1, 2, 4):
    name, nbytes = REAL[s]
    flat = pl.pack_symbols(torch.from_numpy(datasets.load(name, nbytes).copy()).to(dev), s)
    fns = {c: real_pair(s, flat, c) for c in LADDER}
    for i, direction in enumerate(("compress", "decompress")):
        times = {c: [] for c in LADDER}
        for _ in range(3):
            for c in list(LADDER) + list(reversed(LADDER)):
                times[c].append(events(fns[c][i]))
        key = autotune.TuneKey(autotune.device_kind(), autotune.default_dtype(s), s,
                               128 if direction == "compress" else 0, direction, None)
        measure = autotune._default_measure(key)
        tuner = {c: measure(c, autotune.DEFAULT_CHUNKS_PER_BLOCK) * 1e3 for c in LADDER}
        means = {c: statistics.mean(v) for c, v in times.items()}
        cells = ", ".join(
            f"C={c} {means[c]:.4f} ms ({min(times[c]):.4f}-{max(times[c]):.4f}; "
            f"{nbytes / means[c] / 1e6:.1f} GB/s; tuner's workload {tuner[c]:.4f})"
            for c in LADDER)
        print(f"[sweep] {card} | {direction} S={s} {name} {nbytes} B: {cells}; fastest C="
              f"{min(means, key=means.get)}, tuner's pick C={min(tuner, key=tuner.get)}")
