"""Paper Table 3: the cuSZ use case — error-bounded quantization codes,
with vs without GPULZ before entropy coding (rel_eb 1e-2, A100 in the paper).

  original cuSZ:  field -> Lorenzo quant -> Huffman
  cuSZ + GPULZ:   field -> Lorenzo quant -> GPULZ -> Huffman

Plus the framework's own production variant of the same idea: GPULZ-compressed
*checkpoint* shards (optimizer moments + bf16 params).

The port's twin of the reference's ``benchmarks/table3_usecase.py``: the
same fields and rows.  The quantization runs through
``repro_torch.core.quant`` on the card (the codes come back to the host as
uint16, the reference's dtype), GPULZ through the host API, and the Huffman
sizes on the host (``benchmarks/huffman.py``).  ``run`` also returns the
rows as ``{name: (seconds, value)}``.

    PYTHONPATH=src python -m repro_torch.benchmarks.table3_usecase [--nbytes N] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, resolve_device, throughput_gbs, time_fn
from repro_torch.benchmarks.huffman import huffman_compressed_bytes
from repro_torch.core import lzss, quant

PAPER = {  # (cusz CR, cusz+gpulz CR)
    "cesm-like": (22.6, 43.2), "hurr-like": (24.3, 29.1),
    "nyx-like": (30.1, 74.8), "rtm-like": (28.6, 249.8),
}


def fields(nbytes):
    n = nbytes // 4
    side2 = int(np.sqrt(n))
    side3 = int(round(n ** (1 / 3)))
    y, x = np.mgrid[0:side2, 0:side2].astype(np.float32) / side2
    z3, y3, x3 = np.mgrid[0:side3, 0:side3, 0:side3].astype(np.float32) / side3
    t = np.linspace(0, 120 * np.pi, n).astype(np.float32)
    return {
        "cesm-like": (np.sin(8 * np.pi * x) * np.cos(2 * np.pi * y) * 20, 2),
        "hurr-like": (np.sin(6 * np.pi * x + 2 * y) * 30 + x * 50, 2),
        "nyx-like": ((np.sin(2 * np.pi * x3) * np.sin(2 * np.pi * y3)
                      * np.sin(2 * np.pi * z3)) * 100, 3),
        "rtm-like": ((np.sin(t) * np.exp(-((t % 60) / 30) ** 2) * 100)
                     .reshape(-1), 1),
    }


def quant_codes(field: np.ndarray, rel_eb: float, ndim: int, device) -> np.ndarray:
    """The field's Lorenzo quantization codes (uint16, on the host),
    quantized on ``device``."""
    eb = quant.relative_error_bound(field, rel_eb)
    q = quant.quantize(torch.from_numpy(field).to(device), error_bound=eb, ndim=ndim)
    return q.codes.cpu().numpy().astype(np.uint16)


def run(nbytes: int = 1 << 21, device=None) -> dict:
    dev = resolve_device(device)
    rows = {}
    print("# table3: name,us_per_call,CR[|paper]")
    for name, (field, ndim) in fields(nbytes).items():
        field = field.astype(np.float32)
        codes = quant_codes(field, 1e-2, ndim, dev)
        orig = field.nbytes

        cusz = orig / huffman_compressed_bytes(codes)

        cfg = lzss.LZSSConfig(symbol_size=2, window=128, chunk_symbols=4096)
        t_lz = time_fn(lambda: lzss.compress(codes, cfg, dev), warmup=1, iters=2)
        lz = lzss.compress(codes, cfg, dev)
        improved = orig / huffman_compressed_bytes(lz.data)

        p = PAPER.get(name, ("?", "?"))
        emit(f"table3/{name}/cusz", 0.0, f"{cusz:.1f}|paper={p[0]}")
        emit(f"table3/{name}/cusz+gpulz", t_lz,
             f"{improved:.1f}|paper={p[1]}")
        emit(f"table3/{name}/gpulz-throughput", t_lz,
             f"{throughput_gbs(codes.nbytes, t_lz):.4f}GB/s")
        rows[f"table3/{name}/cusz"] = (0.0, cusz)
        rows[f"table3/{name}/cusz+gpulz"] = (t_lz, improved)
        rows[f"table3/{name}/gpulz-throughput"] = (t_lz, throughput_gbs(codes.nbytes, t_lz))

    # framework production variant: checkpoint-shard compression
    rng = np.random.default_rng(0)
    m = (rng.normal(0, 1e-3, 1 << 19).astype(np.float32)
         * (rng.random(1 << 19) < 0.05))  # sparse adam moments
    cfg = lzss.LZSSConfig(symbol_size=4, window=64, chunk_symbols=4096)
    t = time_fn(lambda: lzss.compress(m, cfg, dev), warmup=1, iters=2)
    ratio = lzss.compress(m, cfg, dev).ratio
    emit("table3/checkpoint-moments/gpulz", t, f"{ratio:.2f}")
    rows["table3/checkpoint-moments/gpulz"] = (t, ratio)
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nbytes", type=int, default=1 << 21)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args()
    run(nbytes=args.nbytes, device=args.device)
