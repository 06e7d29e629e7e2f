"""Shard-mapped batch compression vs the single-device batched dispatch.

The port's twin of the reference's ``benchmarks/sharded_batch.py``.  Times
``lzss.compress_many`` / ``decompress_many`` for a batch of B buffers with
the ``"sharded"`` compressor/decoder pair (the B dimension split over a
mesh of devices; ``sharding/batch.py``) against the plain single-device
dispatch, and verifies byte identity while at it.

The mesh is ``--devices`` torch devices: ``cuda:0`` repeated on the card
(one card stands for them all, so the numbers measure dispatch structure,
not scaling), ``cpu`` repeated with ``--device cpu``; ``--devices 0`` uses
every card present.  No environment variable is needed.  The record goes to
``BENCH_torch_sharded.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.sharded_batch [--device cpu]
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, default=8,
                    help="mesh positions (0 = one per card present)")
    ap.add_argument("--buffers", type=int, default=16, help="batch size B")
    ap.add_argument("--nbytes", type=int, default=1 << 16,
                    help="bytes per buffer")
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--chunk-symbols", type=int, default=2048)
    ap.add_argument("--out-json", default="BENCH_torch_sharded.json",
                    help="artifact path")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    return ap.parse_args(argv)


def corpus(b: int, nbytes: int) -> list:
    """Run-heavy + noisy buffers (matches AND literals in every container)."""
    import numpy as np

    rng = np.random.default_rng(0)
    out = []
    for _ in range(b):
        runs = np.repeat(
            rng.integers(0, 9, nbytes // 8).astype(np.uint16), 2
        ).view(np.uint8)
        noise = rng.integers(0, 256, nbytes // 4, dtype=np.uint16).view(np.uint8)
        filler = rng.integers(0, 256, nbytes, dtype=np.uint8)
        # pad with noise so any --nbytes works, not just multiples of 8
        buf = np.concatenate([runs, noise, filler])[:nbytes]
        assert buf.size == nbytes
        out.append(buf.copy())
    return out


def make_mesh(devices: int, device=None) -> tuple:
    """``devices`` positions of ``device`` (0: one per card present)."""
    import torch

    from repro_torch.benchmarks.common import resolve_device

    dev = resolve_device(device)
    if devices:
        return (dev,) * devices
    if dev.type != "cuda":
        return (dev,)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def run(args) -> dict:
    import numpy as np

    from repro_torch.benchmarks.common import (
        emit, platform_fields, resolve_device, throughput_gbs, time_fn)
    from repro_torch.core import lzss

    dev = resolve_device(args.device)
    print("# sharded_batch: name,us_per_call,GB/s")
    mesh = make_mesh(args.devices, dev)
    items = corpus(args.buffers, args.nbytes)
    total = sum(x.size for x in items)
    kw = dict(
        symbol_size=2, window=args.window, chunk_symbols=args.chunk_symbols
    )
    single = lzss.LZSSConfig(**kw)
    sharded = lzss.LZSSConfig(
        **kw, backend="sharded", decoder="sharded", mesh=mesh
    )

    results = {}
    ref = lzss.compress_many(items, single, dev)
    for name, cfg in (("single-device", single), ("sharded", sharded)):
        t_c = time_fn(lambda: lzss.compress_many(items, cfg, dev))
        batch = lzss.compress_many(items, cfg, dev)
        assert np.array_equal(batch.data, ref.data), f"{name}: blobs diverged"
        mesh_arg = mesh if name == "sharded" else None
        t_d = time_fn(lambda: lzss.decompress_many(batch, device=dev, mesh=mesh_arg))
        outs = lzss.decompress_many(batch, device=dev, mesh=mesh_arg)
        assert all(np.array_equal(o, x) for o, x in zip(outs, items)), (
            f"{name}: round trip not exact")
        emit(f"sharded_batch/compress-{name}", t_c,
             f"{throughput_gbs(total, t_c):.4f}")
        emit(f"sharded_batch/decompress-{name}", t_d,
             f"{throughput_gbs(total, t_d):.4f}")
        results[name] = {
            "compress_seconds_per_call": t_c,
            "decompress_seconds_per_call": t_d,
            "gb_per_s_compress": throughput_gbs(total, t_c),
            "nbytes_total": int(total),
        }

    record = {
        "benchmark": "sharded_batch",
        **platform_fields(dev),
        "forced_host_devices": False,
        "n_devices": len(mesh),
        "mesh": [str(d) for d in mesh],
        "buffers": args.buffers,
        "byte_identical": True,  # asserted above
        "results": results,
        "sharded_over_single_compress": (
            results["single-device"]["compress_seconds_per_call"]
            / max(results["sharded"]["compress_seconds_per_call"], 1e-12)
        ),
    }
    with open(args.out_json, "w") as f:
        json.dump(record, f, indent=2)
    print(f"# wrote {args.out_json}")
    return record


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
