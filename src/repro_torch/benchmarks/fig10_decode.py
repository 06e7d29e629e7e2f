"""Decode-side throughput: generic sweep over ALL registered decoders.

The port's twin of the reference's ``benchmarks/fig10_decode.py``.  The
decoder registry of ``core/pipeline.py`` holds ``torch-parallel`` (the plain
parallel decoder, the baseline), ``torch-scan`` (the sequential token
walk), ``fused`` (the CUDA decoder on gathered sections), ``fused-mono``
(the one-launch CUDA decoder reading the container in place),
``deflate-full`` (gap-array Huffman decode, then the device's LZSS decoder)
and ``sharded`` (the batch layer; one device here).  The sweep enumerates
``lzss.available_decoders()``, so a newly registered decoder joins
``BENCH_torch_decode.json`` automatically; every non-baseline decoder gets
a ``<decoder>_over_torch_parallel`` speedup key.  Throughput is in
*decoded* bytes per second of the host API (host clock, each call between
two synchronisations of the card); the JSON names the card and its power
limit.  ``--device cpu`` runs the plain versions (no speed meaning).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig10_decode
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.benchmarks.common import (
    emit, platform_fields, resolve_device, throughput_gbs, time_fn)
from repro_torch.core import lzss
from repro_torch.data import datasets

BASELINE = "torch-parallel"


def ratio_key(decoder: str) -> str:
    """JSON key for a decoder's speedup over the baseline."""
    return f"{decoder.replace('-', '_')}_over_{BASELINE.replace('-', '_')}"


def decoder_sweep(
    data: np.ndarray,
    decoders=None,
    sweep_nbytes: int = 1 << 16,
    out_json: str = "BENCH_torch_decode.json",
    dataset: str = "hurr-quant",
    device=None,
) -> dict:
    """Time each registered decoder on the same container; write the JSON.

    ``decoders=None`` sweeps every *lossless* key in
    ``lzss.available_decoders()`` (the ``lossy-fz`` decoder reads only lossy
    containers, whose geometry depends on the error bound).  Each decoder
    gets a container of its own method: the raw decoders the method-0
    container, the entropy decoder a method-1 one.
    """
    from repro_torch.core import format as fmt, pipeline

    dev = resolve_device(device)
    if decoders is None:
        decoders = tuple(
            d for d in lzss.available_decoders()
            if pipeline.container_method(d) != fmt.METHOD_LOSSY
        )
    slice_ = np.ascontiguousarray(data[:sweep_nbytes])
    res = lzss.compress(slice_, lzss.DEFAULT_CONFIG, dev)
    per_method = {pipeline.container_method("auto"): res}
    results = {}
    for decoder in decoders:
        key = lzss.resolve_decoder(decoder, dev)
        method = pipeline.container_method(key)
        if method not in per_method:
            cfg = lzss.LZSSConfig(
                symbol_size=lzss.DEFAULT_CONFIG.symbol_size,
                window=lzss.DEFAULT_CONFIG.window,
                chunk_symbols=lzss.DEFAULT_CONFIG.chunk_symbols,
                backend="deflate-full",
            )
            per_method[method] = lzss.compress(slice_, cfg, dev)
        blob = per_method[method].data
        t = time_fn(
            lambda: lzss.decompress(blob, decoder=key, device=dev), warmup=1, iters=2
        )
        gbs = throughput_gbs(slice_.nbytes, t)
        emit(f"fig10/{dataset}/decoder-{key}", t, f"{gbs:.4f}")
        results[key] = {
            "seconds_per_call": t,
            "gb_per_s": gbs,
            "nbytes": int(slice_.nbytes),
        }
    record = {
        "benchmark": "fig10_decoder_sweep",
        "dataset": dataset,
        **platform_fields(dev),
        "container_bytes": int(res.total_bytes),
        "ratio": res.ratio,
        "decoders": results,
    }
    if BASELINE in results:
        base_t = results[BASELINE]["seconds_per_call"]
        for key, entry in results.items():
            if key != BASELINE:
                record[ratio_key(key)] = base_t / max(
                    entry["seconds_per_call"], 1e-12
                )
    with open(out_json, "w") as f:
        json.dump(record, f, indent=2)
    print(f"# wrote {out_json}")
    return record


def run(nbytes: int = 1 << 20, dataset: str = "hurr-quant",
        decoders: str = "all", sweep_nbytes: int = 1 << 16,
        out_json: str = "BENCH_torch_decode.json", device=None):
    dev = resolve_device(device)
    print("# fig10: name,us_per_call,GB/s")
    data = datasets.load(dataset, nbytes)

    # headline: default-config container, decoded with the plain baseline
    res = lzss.compress(data, lzss.DEFAULT_CONFIG, dev)
    t = time_fn(
        lambda: lzss.decompress(res.data, decoder=BASELINE, device=dev),
        warmup=1, iters=2,
    )
    emit(f"fig10/{dataset}/gpulz-decode", t,
         f"{throughput_gbs(data.nbytes, t):.4f}")

    # decoder sweep: every registered decoder by default; a restricted list
    # always keeps the baseline so the speedup keys exist
    if decoders == "all":
        keys = None
    else:
        keys = tuple(dict.fromkeys(
            [BASELINE] + [d for d in decoders.split(",") if d]
        ))
    return decoder_sweep(data, decoders=keys, sweep_nbytes=sweep_nbytes,
                         out_json=out_json, dataset=dataset, device=dev)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nbytes", type=int, default=1 << 20)
    ap.add_argument("--dataset", default="hurr-quant")
    ap.add_argument("--decoders", default="all",
                    help="comma-separated registry keys to sweep against the "
                         f"{BASELINE} baseline, or 'all' (default) for every "
                         "registered decoder")
    ap.add_argument("--sweep-nbytes", type=int, default=1 << 16,
                    help="corpus slice for the decoder sweep")
    ap.add_argument("--out-json", default="BENCH_torch_decode.json",
                    help="sweep artifact path")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args()
    run(nbytes=args.nbytes, dataset=args.dataset, decoders=args.decoders,
        sweep_nbytes=args.sweep_nbytes, out_json=args.out_json, device=args.device)
