"""TPC-H lineitem's l_comment text at SF 10 through the S=1 host API, on one card.

    PYTHONPATH=.:src python3 tools/tpch_text_check.py [SEED]

Makes the chars of ``bench/configs/tpch-lineitem-comment-u8.json`` on the
card (``bench/gen/tpch_text.py``, the 16 slices of SEED, default 0), then
for each of the 16 slices of about 99 MB:

  1. ``lzss.compress`` through the one-launch compressor (``fused-mono``)
     and through the plain ``torch`` backend must give byte-identical
     containers, and the benchmark's own decoder (``bench/reference/gplz.py``)
     must give the slice back;
  2. prints the slice's ratio, each backend's call and the decoder's time
     (host clock, after a synchronise) and the ``symbol_bytes`` counter over
     the slice's bytes;

and times ``bench/roofline.py``'s ``window_walk_compares`` on one slice
(what the traced run's set-up counts for each).

Needs a CUDA card.  Exits 1 if a comparison fails.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from bench import manifest, roofline
from bench.gen import tpch_text
from bench.reference import gplz
from repro_torch.core import lzss
from repro_torch.runtime import trace


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(seed: int) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[text] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    cfg = manifest.config(manifest.load(), "tpch-lineitem-comment-u8")
    spec, codec = cfg["data"], cfg["codec"]
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    fields, t_make = _timed(lambda: tpch_text.make(spec, seed, dev))
    print(f"[text] seed {seed}: {fields.shape[0]} slices x {fields.shape[1]} bytes in "
          f"{t_make:.3f} s; peak {torch.cuda.max_memory_allocated()} bytes", flush=True)
    mono = lzss.LZSSConfig(**codec)
    plain = lzss.LZSSConfig(**codec, backend="torch")
    lzss.compress(fields[0, :65536], mono, device=dev)  # builds and warms the kernel
    ok, stored = True, 0
    for k in range(fields.shape[0]):
        x = fields[k]
        trace.reset()
        trace.enable()
        a, t_a = _timed(lambda: lzss.compress(x, mono, device=dev))
        trace.disable()
        sym = trace.snapshot()["counters"]["symbol_bytes"]
        b, t_b = _timed(lambda: lzss.compress(x, plain, device=dev))
        same = a.data.size == b.data.size and bool((a.data == b.data).all())
        back, t_d = _timed(lambda: gplz.decode(a.data, dev))
        exact = torch.equal(back, x)
        ok &= same and exact
        stored += a.total_bytes
        print(f"[text] slice {k}: {a.orig_bytes} -> {a.total_bytes} bytes (ratio {a.ratio:.6f}); "
              f"fused-mono {t_a * 1e3:.2f} ms, torch {t_b * 1e3:.2f} ms, containers "
              f"{'byte-identical' if same else 'DIFFER'}; gplz.decode {t_d * 1e3:.2f} ms, "
              f"{'the slice back' if exact else 'WRONG BYTES'}; symbol_bytes "
              f"{sym / a.orig_bytes:.6f} a byte", flush=True)
        del a, b, back
    print(f"[text] all 16 slices: ratio {fields.numel() / stored:.6f}; peak "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    s, c, w = codec["symbol_size"], codec["chunk_symbols"], codec["window"]
    total, t_walk = _timed(lambda: roofline.window_walk_compares(
        roofline.symbols(fields[0], s, c), w))
    print(f"[text] window_walk_compares of slice 0: {total} ({total / fields.shape[1]:.3f} a "
          f"byte) in {t_walk:.3f} s", flush=True)
    print(f"[text] {'all comparisons hold' if ok else 'A COMPARISON FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 0))
