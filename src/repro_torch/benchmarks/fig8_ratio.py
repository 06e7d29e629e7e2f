"""Compression ratio: generic sweep over ALL registered compressor backends.

The port's twin of the reference's ``benchmarks/fig8_ratio.py``.  The
paper's Fig. 8 table (gpulz vs CULZSS-style vs LZ4, per dataset) stays
available behind ``--paper-table``.  The default entry point is the backend
ratio sweep: every lossless key in ``lzss.available_backends()`` compresses
the same corpus slice and the achieved ratio lands in
``BENCH_torch_ratio.json`` (never a tracked ``BENCH_*.json`` name).

All method-0 (raw LZSS) backends produce byte-identical containers, so their
ratios coincide by construction, and they equal the reference package's;
``deflate_full_over_fused_mono`` records how much the canonical Huffman
second stage buys over the LZSS-only container on the same corpus.  The
sweep runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig8_ratio --nbytes 131072 \\
        --sweep-nbytes 65536
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.benchmarks.common import emit, platform_fields, resolve_device
from repro_torch.benchmarks.lz4_format import lz4_ratio
from repro_torch.core import lzss
from repro_torch.data import datasets

BASELINE = "fused-mono"

# Paper Fig. 8 reference ratios (gpulz default / culzss / nvcomp-lz4)
PAPER = {
    "hurr-quant": (4.9, 4.4, 3.2), "hacc-quant": (2.0, 1.9, 1.9),
    "nyx-quant": (7.2, 6.2, 4.0), "tpch-int32": (1.3, 1.4, 1.2),
    "tpch-string": (2.4, 2.6, 2.3), "rtm-float32": (2.9, 2.7, 2.5),
}


def ratio_key(backend: str) -> str:
    """JSON key for a backend's ratio gain over the baseline."""
    return f"{backend.replace('-', '_')}_over_{BASELINE.replace('-', '_')}"


def ratio_sweep(
    data: np.ndarray,
    backends=None,
    sweep_nbytes: int = 1 << 16,
    out_json: str = "BENCH_torch_ratio.json",
    dataset: str = "hurr-quant",
    device=None,
) -> dict:
    """Compress the same slice with each registered backend; write the JSON.

    ``backends=None`` sweeps every *lossless* key in
    ``lzss.available_backends()`` — the ``lossy-fz`` ratio is a function of
    its error bound, which this sweep has no axis for.
    """
    from repro_torch.core import format as fmt, pipeline

    dev = resolve_device(device)
    if backends is None:
        backends = tuple(
            b for b in lzss.available_backends()
            if pipeline.container_method(b) != fmt.METHOD_LOSSY
        )
    slice_ = np.ascontiguousarray(data[:sweep_nbytes])
    results = {}
    for backend in backends:
        cfg = lzss.LZSSConfig(
            symbol_size=2, window=128, chunk_symbols=2048, backend=backend
        )
        res = lzss.compress(slice_, cfg, dev)
        emit(f"fig8/{dataset}/backend-{backend}", 0.0, f"{res.ratio:.4f}")
        results[backend] = {
            "ratio": float(res.ratio),
            "total_bytes": int(res.total_bytes),
            "orig_bytes": int(slice_.nbytes),
            "nbytes": int(slice_.nbytes),
        }
    record = {
        "benchmark": "fig8_ratio_sweep",
        "dataset": dataset,
        **platform_fields(dev),
        "backends": results,
    }
    if BASELINE in results:
        base = results[BASELINE]["ratio"]
        for key, entry in results.items():
            if key != BASELINE:
                record[ratio_key(key)] = entry["ratio"] / max(base, 1e-12)
    with open(out_json, "w") as f:
        json.dump(record, f, indent=2)
    print(f"# wrote {out_json}")
    return record


def best_ratio(data, device=None):
    best = 0.0
    for c in (2048, 4096):
        for w in (32, 64, 128, 255):
            for s in (1, 2, 4):
                cfg = lzss.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c)
                best = max(best, lzss.compress(data, cfg, device).ratio)
    return best


def run_paper_table(nbytes: int = 1 << 21, device=None):
    """The paper-reference table (Fig. 8 reproduction)."""
    dev = resolve_device(device)
    print("# fig8: name,us_per_call,ratio[|paper]")
    for ds in datasets.DATASETS:
        data = datasets.load(ds, nbytes)
        gpulz = lzss.compress(data, lzss.DEFAULT_CONFIG, dev).ratio
        culzss = lzss.compress(
            data,
            lzss.LZSSConfig(symbol_size=1, window=128, chunk_symbols=2048),
            dev,
        ).ratio
        lz4 = lz4_ratio(data, max_bytes=1 << 20)
        best = best_ratio(data, dev)
        p = PAPER.get(ds, ("?",) * 3)
        emit(f"fig8/{ds}/gpulz", 0.0, f"{gpulz:.2f}|paper={p[0]}")
        emit(f"fig8/{ds}/gpulz-best", 0.0, f"{best:.2f}")
        emit(f"fig8/{ds}/culzss-style", 0.0, f"{culzss:.2f}|paper={p[1]}")
        emit(f"fig8/{ds}/lz4-format", 0.0, f"{lz4:.2f}|paper={p[2]}")


def run(nbytes: int = 1 << 20, dataset: str = "hurr-quant",
        backends: str = "all", sweep_nbytes: int = 1 << 16,
        out_json: str = "BENCH_torch_ratio.json", device=None):
    print("# fig8: name,us_per_call,ratio")
    data = datasets.load(dataset, nbytes)
    # a restricted list always keeps the baseline so the gain keys exist
    if backends == "all":
        keys = None
    else:
        keys = tuple(dict.fromkeys(
            [BASELINE] + [b for b in backends.split(",") if b]
        ))
    return ratio_sweep(data, backends=keys, sweep_nbytes=sweep_nbytes,
                       out_json=out_json, dataset=dataset, device=device)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nbytes", type=int, default=1 << 20)
    ap.add_argument("--dataset", default="hurr-quant")
    ap.add_argument("--backends", default="all",
                    help="comma-separated registry keys to sweep against the "
                         f"{BASELINE} baseline, or 'all' (default) for every "
                         "registered backend")
    ap.add_argument("--sweep-nbytes", type=int, default=1 << 16,
                    help="corpus slice for the ratio sweep")
    ap.add_argument("--out-json", default="BENCH_torch_ratio.json",
                    help="sweep artifact path")
    ap.add_argument("--paper-table", action="store_true",
                    help="print the paper Fig. 8 reference table instead of "
                         "running the backend ratio sweep")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args()
    if args.paper_table:
        run_paper_table(nbytes=args.nbytes, device=args.device)
    else:
        run(nbytes=args.nbytes, dataset=args.dataset, backends=args.backends,
            sweep_nbytes=args.sweep_nbytes, out_json=args.out_json, device=args.device)
