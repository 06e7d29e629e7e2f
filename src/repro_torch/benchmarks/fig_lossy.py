"""Lossy frontend: ratio/throughput vs error bound for the ``lossy-fz`` pair.

The port's twin of the reference's ``benchmarks/fig_lossy.py``.  The
lossless sweeps (fig8/fig9/fig10) exclude the method-2 pair: its ratio is a
function of the error bound, which those registry-generic sweeps have no
axis for.  This driver IS that axis: the same f32 corpus slice (the
``hurr-field`` surrogate, the hurr quant dataset's pre-quantization field)
compresses at each bound in the sweep, and every row records ratio,
compress and decode throughput, and the measured ``max |x' - x|``.

Every row *asserts* reconstruction within its bound before it is written:
a record that exists at all certifies the bound held at every point, on
the platform named inside it.  The ``eb = 0`` row is the bit-exact
passthrough mode and doubles as the lossless reference ratio.  Times are
the host API's (host clock, each call between two synchronisations of the
card); ``--device cpu`` runs the plain versions (ratios and the bound
check hold, times say nothing of the card).  The record goes to
``BENCH_torch_lossy.json`` (never the tracked ``BENCH_lossy.json``).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_lossy [--sweep-nbytes N]
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.benchmarks.common import (
    emit, platform_fields, resolve_device, throughput_gbs, time_fn)
from repro_torch.core import lzss
from repro_torch.data import datasets

# ratio-vs-bound sweep points; 0.0 = the bit-exact passthrough reference
EBS = (1e-2, 1e-3, 1e-4, 0.0)


def _eb_key(eb: float) -> str:
    return f"{eb:g}"


def lossy_sweep(
    data: np.ndarray,
    ebs=EBS,
    sweep_nbytes: int = 1 << 16,
    out_json: str = "BENCH_torch_lossy.json",
    dataset: str = "hurr-field",
    inner: str = "auto",
    device=None,
) -> dict:
    """Compress/decode the same f32 slice at each bound; write the JSON.

    ``data`` is a uint8 view of an f32 stream (``datasets.load``'s layout).
    Raises AssertionError if any row's reconstruction violates its bound:
    the artifact is only ever written with every row certified.
    """
    dev = resolve_device(device)
    nbytes = (sweep_nbytes // 4) * 4
    slice_ = np.ascontiguousarray(data[:nbytes])
    x = slice_.view(np.float32)
    results = {}
    for eb in ebs:
        cfg = lzss.LZSSConfig(
            symbol_size=4, window=128, chunk_symbols=2048,
            backend="lossy-fz", lossy_eb=eb, lossy_inner=inner,
        )
        res = lzss.compress(slice_, cfg, dev)
        t_c = time_fn(lambda: lzss.compress(slice_, cfg, dev), warmup=1, iters=2)
        blob = res.data
        t_d = time_fn(lambda: lzss.decompress(blob, device=dev), warmup=1, iters=2)
        rec = np.asarray(lzss.decompress(blob, device=dev)).view(np.float32)
        fin = np.isfinite(x)
        assert np.array_equal(
            rec[~fin].view(np.uint32), x[~fin].view(np.uint32)
        ), f"eb={eb}: non-finite elements must round-trip bit-exactly"
        max_err = float(np.max(np.abs(rec[fin] - x[fin]))) if fin.any() else 0.0
        if eb == 0.0:
            assert np.array_equal(
                rec.view(np.uint32), x.view(np.uint32)
            ), "eb=0 must be bit-exact"
        else:
            assert max_err <= float(np.float32(eb)), (
                f"eb={eb}: max err {max_err} violates the bound"
            )
        emit(f"fig_lossy/{dataset}/eb-{_eb_key(eb)}", t_c,
             f"{res.ratio:.4f}")
        results[_eb_key(eb)] = {
            "eb": float(eb),
            "ratio": float(res.ratio),
            "total_bytes": int(res.total_bytes),
            "orig_bytes": int(slice_.nbytes),
            "nbytes": int(slice_.nbytes),
            "max_abs_err": max_err,
            "bound_ok": True,  # asserted above; recorded for the schema
            "compress_seconds_per_call": t_c,
            "compress_gb_per_s": throughput_gbs(slice_.nbytes, t_c),
            "decode_seconds_per_call": t_d,
            "decode_gb_per_s": throughput_gbs(slice_.nbytes, t_d),
        }
    record = {
        "benchmark": "fig_lossy_sweep",
        "dataset": dataset,
        **platform_fields(dev),
        "inner": inner,
        "ebs": results,
    }
    # the headline the sweep exists for: how much ratio each bound buys
    # over the bit-exact reference on the same corpus
    lossless_key = _eb_key(0.0)
    if lossless_key in results:
        base = results[lossless_key]["ratio"]
        for key, entry in results.items():
            if key != lossless_key:
                record[f"eb_{key}_over_lossless"] = entry["ratio"] / max(
                    base, 1e-12
                )
    with open(out_json, "w") as f:
        json.dump(record, f, indent=2)
    print(f"# wrote {out_json}")
    return record


def run(nbytes: int = 1 << 20, dataset: str = "hurr-field",
        sweep_nbytes: int = 1 << 16, inner: str = "auto",
        out_json: str = "BENCH_torch_lossy.json", device=None):
    print("# fig_lossy: name,us_per_call,ratio")
    data = datasets.load(dataset, nbytes)
    return lossy_sweep(data, sweep_nbytes=sweep_nbytes, out_json=out_json,
                       dataset=dataset, inner=inner, device=device)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nbytes", type=int, default=1 << 20)
    ap.add_argument("--dataset", default="hurr-field",
                    help="f32 corpus (uint8 view of an f32 stream)")
    ap.add_argument("--sweep-nbytes", type=int, default=1 << 16,
                    help="corpus slice for the sweep")
    ap.add_argument("--inner", default="auto",
                    help="inner lossless stage registry key "
                         "('auto'/'deflate-full'/...)")
    ap.add_argument("--out-json", default="BENCH_torch_lossy.json",
                    help="sweep artifact path")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args()
    run(nbytes=args.nbytes, dataset=args.dataset,
        sweep_nbytes=args.sweep_nbytes, inner=args.inner,
        out_json=args.out_json, device=args.device)
