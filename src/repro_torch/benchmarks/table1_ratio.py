"""Paper Table 1: compression ratio vs (chunk size C, window W, symbol S)
on the dataset surrogates, on the card.

The port's twin of the reference's ``benchmarks/table1_ratio.py``: the same
rows (``table1/<dataset>/C<c>/W<w>/S<s>``, the host API's microseconds a
compress and the ratio).  The paper's own measurements (A100 / A4000
ratios) are printed in the last column for calibration: the surrogates
match the datasets' character, not their bytes.  ``run`` also returns the
rows as ``{name: (seconds, ratio)}``.

    PYTHONPATH=src python -m repro_torch.benchmarks.table1_ratio [--nbytes N] [--device cpu]
"""

from __future__ import annotations

from repro_torch.benchmarks.common import emit, resolve_device, time_fn
from repro_torch.core import lzss
from repro_torch.data import datasets

# Paper Table 1 reference values at C=2048 (ratio), keyed (dataset, W, S)
PAPER_C2048 = {
    ("hurr-quant", 32, 1): 3.14, ("hurr-quant", 32, 2): 3.77,
    ("hurr-quant", 128, 2): 4.91, ("hurr-quant", 255, 2): 5.32,
    ("hacc-quant", 128, 2): 1.97, ("nyx-quant", 128, 2): 7.19,
    ("tpch-int32", 128, 1): 1.43, ("tpch-int32", 128, 2): 1.34,
    ("tpch-string", 128, 1): 2.57, ("rtm-float32", 128, 4): 2.94,
}


def run(nbytes: int = 1 << 21, chunks=(2048, 4096), windows=(32, 64, 128, 255),
        symbols=(1, 2, 4), device=None) -> dict:
    dev = resolve_device(device)
    rows = {}
    print("# table1: name,us_per_call,ratio[|paper]")
    for ds in datasets.DATASETS:
        data = datasets.load(ds, nbytes)
        for c in chunks:
            for w in windows:
                for s in symbols:
                    cfg = lzss.LZSSConfig(symbol_size=s, window=w,
                                          chunk_symbols=c)
                    t = time_fn(lambda: lzss.compress(data, cfg, dev), iters=1)
                    r = lzss.compress(data, cfg, dev).ratio
                    paper = PAPER_C2048.get((ds, w, s))
                    tag = f"{r:.2f}" + (f"|paper={paper}" if paper and c == 2048
                                        else "")
                    emit(f"table1/{ds}/C{c}/W{w}/S{s}", t, tag)
                    rows[f"table1/{ds}/C{c}/W{w}/S{s}"] = (t, r)
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nbytes", type=int, default=1 << 21)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args()
    run(nbytes=args.nbytes, device=args.device)
