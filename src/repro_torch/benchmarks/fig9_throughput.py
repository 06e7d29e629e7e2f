"""Paper Fig. 9: throughput comparison — gpulz default vs gpulz-best-speed
(fastest config) vs the CULZSS-workflow emulation, on the card.

The port's twin of the reference's ``benchmarks/fig9_throughput.py``.  The
paper's speedup over CULZSS comes from moving encode off the
CPU-sequential path onto the GPU.  ``culzss-workflow`` is that structure
(their Fig. 4a): the CUDA match-only kernel, then a host-Python sequential
encode over every position; ``gpulz`` is the host API with the card's
default, the one-launch compressor (their Fig. 4d).  The host loop makes the
workflow slow, so it runs on a 1 MiB head of the corpus (``CULZSS_HEAD``)
only, which is all of it at the default ``--nbytes``.

``--backend`` additionally sweeps the pipeline backends (the plain
``torch`` baseline vs the CUDA Kernel I (``fused``) vs Kernels I-III
(``fused-deflate``) vs the one-launch compressor (``fused-mono``)) and
records them in ``BENCH_torch_pipeline.json``, with the ``<key>_over_torch``
speedups.  Times are the host API's (host clock, each call between two
synchronisations of the card), GB/s of input bytes; the JSON names the card
and its power limit.  ``--device cpu`` runs the plain versions (no speed
meaning).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig9_throughput
"""

from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.benchmarks.common import (
    emit, platform_fields, resolve_device, throughput_gbs, time_fn)
from repro_torch.core import lzss
from repro_torch.data import datasets
from repro_torch.kernels import ops

BASELINE = "torch"
CULZSS_HEAD = 1 << 20  # bytes the host-loop workflow runs on


def culzss_workflow_seconds(data: np.ndarray, window=128, c=2048, device=None) -> float:
    """GPU matching + host sequential encode (CULZSS structure)."""
    import time

    dev = resolve_device(device)
    n = data.size
    nc = -(-n // c)
    padded = np.zeros(nc * c, np.uint8)
    padded[:n] = data
    symbols = lzss.pack_symbols(torch.from_numpy(padded).to(dev), 1).reshape(nc, c)
    ops.lz_match(symbols, window=window, symbol_size=1)  # warm the build

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    lengths, _ = ops.lz_match(symbols, window=window, symbol_size=1)
    lengths = lengths.cpu().numpy()
    # host-side sequential encode per chunk (the CULZSS CPU stage)
    out_bytes = 0
    for k in range(nc):
        i = 0
        while i < c:
            ln = int(lengths[k, i])
            if ln >= 3:
                out_bytes += 2
                i += ln
            else:
                out_bytes += 1
                i += 1
    return time.perf_counter() - t0


def backend_sweep(
    data: np.ndarray,
    backends=("torch", "fused", "fused-deflate", "fused-mono"),
    sweep_nbytes: int = 1 << 16,
    out_json: str = "BENCH_torch_pipeline.json",
    dataset: str = "hurr-quant",
    device=None,
) -> dict:
    """Time each pipeline backend on the same corpus; write the JSON."""
    dev = resolve_device(device)
    slice_ = np.ascontiguousarray(data[:sweep_nbytes])
    results = {}
    for backend in backends:
        cfg = lzss.LZSSConfig(
            symbol_size=2, window=128, chunk_symbols=2048, backend=backend
        )
        t = time_fn(lambda: lzss.compress(slice_, cfg, dev), warmup=1, iters=2)
        gbs = throughput_gbs(slice_.nbytes, t)
        emit(f"fig9/{dataset}/backend-{backend}", t, f"{gbs:.4f}")
        results[backend] = {
            "seconds_per_call": t,
            "gb_per_s": gbs,
            "nbytes": int(slice_.nbytes),
        }
    record = {
        "benchmark": "fig9_backend_sweep",
        "dataset": dataset,
        **platform_fields(dev),
        "backends": results,
    }
    # per-backend speedup vs the plain baseline ("fused_over_torch", ...)
    if BASELINE in results:
        for key, entry in results.items():
            if key == BASELINE:
                continue
            record[f"{key.replace('-', '_')}_over_{BASELINE}"] = (
                results[BASELINE]["seconds_per_call"]
                / max(entry["seconds_per_call"], 1e-12)
            )
    with open(out_json, "w") as f:
        json.dump(record, f, indent=2)
    print(f"# wrote {out_json}")
    return record


def run(nbytes: int = 1 << 20, dataset: str = "hurr-quant",
        backend: str = "fused-mono", sweep_nbytes: int = 1 << 16,
        out_json: str = "BENCH_torch_pipeline.json", device=None):
    dev = resolve_device(device)
    print("# fig9: name,us_per_call,GB/s")
    data = datasets.load(dataset, nbytes)

    t_gpulz = time_fn(
        lambda: lzss.compress(data, lzss.DEFAULT_CONFIG, dev), warmup=1, iters=2
    )
    emit(f"fig9/{dataset}/gpulz", t_gpulz,
         f"{throughput_gbs(nbytes, t_gpulz):.4f}")

    fast_cfg = lzss.LZSSConfig(symbol_size=4, window=32, chunk_symbols=2048)
    t_fast = time_fn(lambda: lzss.compress(data, fast_cfg, dev), warmup=1, iters=2)
    emit(f"fig9/{dataset}/gpulz-best-speed", t_fast,
         f"{throughput_gbs(nbytes, t_fast):.4f}")

    head = data[:CULZSS_HEAD]
    t_culzss = culzss_workflow_seconds(head, device=dev)
    emit(f"fig9/{dataset}/culzss-workflow", t_culzss,
         f"{throughput_gbs(head.size, t_culzss):.4f}")
    # the speedup compares GB/s: the workflow may run on a head of the data
    speedup = throughput_gbs(nbytes, t_gpulz) / throughput_gbs(head.size, t_culzss)
    emit(f"fig9/{dataset}/speedup-vs-culzss", 0.0,
         f"{speedup:.1f}x|paper=22.2x-avg")

    # pipeline backend sweep: always include the plain baseline (and the
    # intermediate stages when sweeping the fused backends, so the JSON
    # separates the Kernel-I win from the Kernel-II/III win from the
    # one-launch fold)
    if backend == BASELINE:
        backends = (BASELINE,)
    elif backend == "fused-deflate":
        backends = (BASELINE, "fused", "fused-deflate")
    elif backend == "fused-mono":
        backends = (BASELINE, "fused", "fused-deflate", "fused-mono")
    else:
        backends = (BASELINE, backend)
    return backend_sweep(data, backends=backends, sweep_nbytes=sweep_nbytes,
                         out_json=out_json, dataset=dataset, device=dev)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nbytes", type=int, default=1 << 20)
    ap.add_argument("--dataset", default="hurr-quant")
    ap.add_argument("--backend", default="fused-mono",
                    choices=sorted(lzss.available_backends()),
                    help="pipeline backend to sweep against the torch baseline")
    ap.add_argument("--sweep-nbytes", type=int, default=1 << 16,
                    help="corpus slice for the backend sweep")
    ap.add_argument("--out-json", default="BENCH_torch_pipeline.json",
                    help="sweep artifact path")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args()
    run(nbytes=args.nbytes, dataset=args.dataset, backend=args.backend,
        sweep_nbytes=args.sweep_nbytes, out_json=args.out_json,
        device=args.device)
