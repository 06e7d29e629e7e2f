"""TPC-H lineitem's int32 columns at SF 10 through the S=4 host API, on one card.

    PYTHONPATH=.:src python3 tools/tpch_columns_check.py [SEED ...]

Makes the table of ``bench/configs/tpch-lineitem-i32.json`` on the card
(``bench/gen/tpch_lineitem.py``), then:

  1. for ``l_partkey`` (nearly all literals) and ``l_orderkey`` (runs of
     1..7 equal keys), each a whole column of 239,944,208 bytes in row
     order: ``lzss.compress`` through the one-launch compressor
     (``fused-mono``) and through the plain ``torch`` backend must give
     byte-identical containers, and the benchmark's own decoder
     (``bench/reference/gplz.py``) must give the column back;
  2. prints each column's ratio through ``fused-mono``, in row order and,
     for each SEED given, as that seed orders and shifts the columns;
  3. times ``bench/roofline.py``'s ``window_walk_compares`` on the 11
     columns (what the traced run's set-up counts) and a call of each
     backend (host clock, after a synchronise).

Needs a CUDA card.  Exits 1 if a comparison fails.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from bench import manifest, roofline
from bench.gen import tpch_lineitem as tpch
from bench.reference import gplz
from repro_torch.core import lzss


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(seeds) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[tpch] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    cfg = manifest.config(manifest.load(), "tpch-lineitem-i32")
    spec, codec = cfg["data"], cfg["codec"]
    dev = torch.device("cuda")
    (cols, t_make) = _timed(lambda: {k: v for k, v in tpch.table(spec, dev)
                                     if k in spec["columns"]})
    print(f"[tpch] table of {len(cols)} columns x {spec['rows']} rows in {t_make:.3f} s; "
          f"peak {torch.cuda.max_memory_allocated()} bytes", flush=True)
    mono = lzss.LZSSConfig(**codec)
    plain = lzss.LZSSConfig(**codec, backend="torch")
    ok = True
    for name in ("l_partkey", "l_orderkey"):
        col = cols[name]
        lzss.compress(col[:65536], mono, device=dev)  # builds and warms the kernel
        a, t_a = _timed(lambda: lzss.compress(col, mono, device=dev))
        b, t_b = _timed(lambda: lzss.compress(col, plain, device=dev))
        same = a.data.size == b.data.size and bool((a.data == b.data).all())
        back, t_d = _timed(lambda: gplz.decode(a.data, dev))
        exact = torch.equal(back, col.view(torch.uint8))
        ok &= same and exact
        print(f"[tpch] {name}: {a.orig_bytes} bytes -> {a.total_bytes} (ratio {a.ratio:.6f}); "
              f"fused-mono {t_a * 1e3:.2f} ms, torch {t_b * 1e3:.2f} ms, containers "
              f"{'byte-identical' if same else 'DIFFER'}; gplz.decode {t_d * 1e3:.2f} ms, "
              f"{'the column back' if exact else 'WRONG BYTES'}", flush=True)
        del a, b, back
    for name, col in cols.items():
        r = lzss.compress(col, mono, device=dev)
        print(f"[tpch] row order {name}: ratio {r.ratio:.6f} ({r.total_bytes} bytes)", flush=True)
    s, c, w = codec["symbol_size"], codec["chunk_symbols"], codec["window"]
    total, t_walk = _timed(lambda: sum(
        roofline.window_walk_compares(roofline.symbols(col.view(torch.uint8), s, c), w)
        for col in cols.values()))
    print(f"[tpch] window_walk_compares of the 11 columns: {total} in {t_walk:.3f} s", flush=True)
    del cols
    for seed in seeds:
        fields = tpch.make(spec, seed, dev)
        names, _ = tpch.layout(spec, seed)
        ratios = [lzss.compress(fields[k].view(torch.int32), mono, device=dev).ratio
                  for k in range(fields.shape[0])]
        print(f"[tpch] seed {seed}: " + ", ".join(f"{n} {r:.6f}" for n, r in zip(names, ratios)),
              flush=True)
        del fields
    print(f"[tpch] {'all comparisons hold' if ok else 'A COMPARISON FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]]))
