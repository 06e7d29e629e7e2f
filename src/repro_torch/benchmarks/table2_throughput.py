"""Paper Table 2: compression throughput vs (C, W, S), on the card.

The port's twin of the reference's ``benchmarks/table2_throughput.py``: the
same rows (``table2/<dataset>/C<c>/W<w>/S<s>``, microseconds a compress and
GB/s of input, then the decompression row at the default config).  Times
are the host API's (host clock, each call between two synchronisations of
the card), H2D and D2H copies included; with ``--device cpu`` the plain
versions run and the times say nothing of the card.  ``run`` also returns
the rows as ``{name: (seconds, GB/s)}``.

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_throughput [--nbytes N]
"""

from __future__ import annotations

from repro_torch.benchmarks.common import emit, resolve_device, throughput_gbs, time_fn
from repro_torch.core import lzss
from repro_torch.data import datasets


def run(nbytes: int = 1 << 21, dataset: str = "nyx-quant", device=None) -> dict:
    dev = resolve_device(device)
    rows = {}
    print("# table2: name,us_per_call,GB/s")
    data = datasets.load(dataset, nbytes)
    for c in (2048, 4096):
        for w in (32, 64, 128, 255):
            for s in (1, 2, 4):
                cfg = lzss.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c)
                t = time_fn(lambda: lzss.compress(data, cfg, dev), warmup=1,
                            iters=2)
                emit(
                    f"table2/{dataset}/C{c}/W{w}/S{s}", t,
                    f"{throughput_gbs(nbytes, t):.4f}",
                )
                rows[f"table2/{dataset}/C{c}/W{w}/S{s}"] = (t, throughput_gbs(nbytes, t))
    # decompression throughput (paper §4.4 tail)
    cfg = lzss.DEFAULT_CONFIG
    blob = lzss.compress(data, cfg, dev).data
    t = time_fn(lambda: lzss.decompress(blob, device=dev), warmup=1, iters=2)
    emit(f"table2/{dataset}/decompress", t,
         f"{throughput_gbs(nbytes, t):.4f}")
    rows[f"table2/{dataset}/decompress"] = (t, throughput_gbs(nbytes, t))
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nbytes", type=int, default=1 << 21)
    ap.add_argument("--dataset", default="nyx-quant")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args()
    run(nbytes=args.nbytes, dataset=args.dataset, device=args.device)
