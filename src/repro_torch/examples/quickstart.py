"""Quickstart: GPULZ compression of multi-byte data, on the card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's twin of the reference's ``examples/quickstart.py``.  Shows the
paper's core API: multi-byte symbols (S), window levels (W), chunked
parallel compression, the adaptive parameter selector, and the on-device
path used for gradient/KV compression (``pipeline.compress_chunks`` on a
device tensor: no host copy of the symbols or the container).
"""

import argparse

import numpy as np
import torch

from repro_torch.core import lzss, pipeline, quant
from repro_torch.core.params import select_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    dev = lzss.resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- 1. uint16 quantization codes (the paper's flagship data type) -----
    t = np.linspace(0, 60 * np.pi, 1 << 19).astype(np.float32)
    field = np.sin(t) * 50 + np.cos(3 * t) * 4
    eb = quant.relative_error_bound(field, 1e-3)
    q = quant.quantize(torch.from_numpy(field).to(dev), error_bound=eb, ndim=1)
    codes = q.codes.cpu().numpy().astype(np.uint16)

    for s in (1, 2):
        for w in (32, 128):
            cfg = lzss.LZSSConfig(symbol_size=s, window=w, chunk_symbols=2048)
            res = lzss.compress(codes, cfg, dev)
            print(f"S={s} W={w:3d}: ratio {res.ratio:5.2f} "
                  f"({res.orig_bytes} -> {res.total_bytes} bytes)")

    # --- 2. lossless roundtrip ---------------------------------------------
    cfg = lzss.DEFAULT_CONFIG  # paper default C=2048, S=2, W=128
    res = lzss.compress(codes, cfg, dev)
    out = lzss.decompress(res.data, device=dev)
    assert np.array_equal(out.view(np.uint16), codes.reshape(-1))
    print(f"roundtrip OK at default config, ratio {res.ratio:.2f}")

    # --- 3. adaptive parameter selection (paper §3.2.3) ---------------------
    picked = select_params(codes, level=3, device=dev)
    print(f"selector picked: S={picked.symbol_size} W={picked.window}")
    noisy = rng.integers(0, 2**31, 1 << 16).astype(np.int32)
    picked2 = select_params(noisy, level=3, device=dev)
    print(f"selector on incompressible int32: S={picked2.symbol_size} "
          f"(falls back to byte matching)")

    # --- 4. on-device compression (gradient/KV compression's entry) ---------
    raw = torch.from_numpy(codes.view(np.uint8)).to(dev)
    symbols = pipeline.pack_symbols(raw, 2).reshape(-1, cfg.chunk_symbols)
    buf, total = pipeline.compress_chunks(symbols, cfg)
    assert buf.device.type == dev.type
    print(f"on-device compress_chunks: {symbols.numel() * 2} -> {int(total)} bytes"
          f" (stays on {buf.device.type}, used for gradient/KV compression)")


if __name__ == "__main__":
    main()
