"""Smoke run of repro_torch on one NVIDIA card: build, check, drive, time.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc).  It imports nothing of JAX or of the reference package.
Phases, any failure of which exits non-zero:

  1. card       name and power limit (nvidia-smi), torch's device name
  2. build      the four kernels from src/repro_torch/csrc, ptxas -v lines
  3. kernels    each CUDA kernel against its plain PyTorch version on the
                same CUDA tensors, at C=2048 with S in {1,2,4} x W in
                {32,128,255}, and C=32768: integer outputs, exactly equal
  4. golden     the 7 raw golden inputs compress to their .gplz bytes; the
                7 current and 7 version-1 raw blobs decode to their inputs
  5. main path  the host API (compress / decompress, compress_many /
                decompress_many) at real sizes, launch counts read around
                it; round trips exact and containers equal to the plain
                PyTorch path run on the card
  6. times      host-clock throughput of the main path, CUDA-event times of
                each kernel, its plain version and (Kernel II) torch.cumsum
                at the main path's shapes, and each kernel's bound

The last two lines of standard output are the kernels' JSON record and the
device record {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
MIB = 1 << 20
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and the int32 rate of the
# CUDA cores: 132 SMs x 64 INT32 lanes x 1.98 GHz (the 67 TFLOP/s fp32
# figure counts 128 FP32 lanes and 2 flops per FMA; int32 has half the
# lanes and one op per instruction).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("run from a repro checkout: src/repro_torch is missing")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import core
    from repro_torch.core import deflate, format as fmt, pipeline as pl
    from repro_torch.data import datasets
    from repro_torch.kernels import _build, lz_decode, lz_match, lz_scatter, ops

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    for name, lines in _build.ptxas_report().items():
        for ln in lines:
            print(f"[build] {name}: {ln}")

    # ------------------------------------- kernels against plain versions
    sources = {1: "tpch-string", 2: "hurr-quant", 4: "rtm-float32"}
    pool = {s: datasets.load(name, 8 * MIB) for s, name in sources.items()}
    err = dict.fromkeys(ops.KERNELS, 0)

    def diff(a, b) -> int:
        if a.shape != b.shape:
            fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0

    def hold(s: int, w: int, c: int, nc: int) -> None:
        cfg = core.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c)
        raw = torch.from_numpy(pool[s][: nc * c * s].copy()).to(dev)
        sym = pl.pack_symbols(raw, s).reshape(nc, c)
        kw = dict(window=w, min_match=cfg.min_match, symbol_size=s)
        k1 = lz_match.lz_kernel1_cuda(sym, **kw)
        p1 = lz_match.lz_kernel1_plain(sym, **kw)
        err["lz_kernel1"] = max(err["lz_kernel1"], *(diff(k1[k], p1[k]) for k in p1))
        args2 = (p1["n_tokens"][None], p1["payload_sizes"][None])
        k2, p2 = lz_scatter.global_offsets_cuda(*args2), lz_scatter.global_offsets_plain(*args2)
        err["lz_global_offsets"] = max(err["lz_global_offsets"], *(diff(a, b) for a, b in zip(k2, p2)))
        args3 = [sym[None]] + [p1[k][None] for k in ("lengths", "offsets", "emitted", "local_off")]
        args3 += list(p2[:2])
        kw3 = dict(symbol_size=s, min_match=cfg.min_match,
                   cap=fmt.max_compressed_bytes(nc * c * s, s, c), sec_flags=fmt.HEADER_BYTES + 8 * nc)
        blob = lz_scatter.scatter_plain(*args3, **kw3)
        err["lz_scatter"] = max(err["lz_scatter"], diff(lz_scatter.scatter_cuda(*args3, **kw3), blob))
        total = fmt.HEADER_BYTES + 8 * nc + int(p2[2].sum())
        flags, pay, nt = sections(blob[0], p1["n_tokens"], p1["payload_sizes"], s, c)
        d = lz_decode.lz_decode_cuda(flags, pay, nt, symbol_size=s)
        err["lz_decode"] = max(err["lz_decode"], diff(d, lz_decode.lz_decode_plain(flags, pay, nt, symbol_size=s)))
        if not torch.equal(d, sym):
            fail(f"decoder does not invert the compressor at S={s} W={w} C={c}")
        print(f"[kernels] S={s} W={w} C={c} nc={nc}: {total} container bytes, "
              f"max |kernel - plain| so far {err}")

    def sections(blob, n_tokens, payload_sizes, s, c):
        nc = n_tokens.numel()
        fs = (n_tokens.to(torch.int64) + 7) // 8
        ps = payload_sizes.to(torch.int64)
        sec = fmt.HEADER_BYTES + 8 * nc
        flags = deflate.gather_section(blob, sec, fs, torch.cumsum(fs, 0) - fs, c // 8)
        pay = deflate.gather_section(blob, sec + int(fs.sum()), ps, torch.cumsum(ps, 0) - ps, c * s)
        return flags, pay, n_tokens

    for s in (1, 2, 4):
        for w in (32, 128, 255):
            hold(s, w, 2048, 256)
    for s, w in ((4, 128), (2, 255), (1, 32)):
        hold(s, w, 32768, 8)
    torch.cuda.synchronize()
    if any(err.values()):
        fail(f"a kernel disagrees with its plain version: {err}")

    # ----------------------------------------------------------- golden
    gdir = ROOT / "tests" / "golden"
    raw_cases = sorted(p.name[:-10] for p in gdir.glob("*.input.bin")
                       if re.fullmatch(r"[a-z0-9]+_s\d_w\d+_c\d+", p.name[:-10]))
    if len(raw_cases) != 7:
        fail(f"expected 7 raw golden cases, found {raw_cases}")
    for name in raw_cases:
        s, w, c = map(int, re.fullmatch(r"\w+?_s(\d)_w(\d+)_c(\d+)", name).groups())
        data = np.frombuffer((gdir / f"{name}.input.bin").read_bytes(), np.uint8)
        gold = (gdir / f"{name}.gplz").read_bytes()
        got = core.compress(data, core.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c))
        if bytes(got.data) != gold:
            fail(f"golden {name}: container bytes differ")
        for blob in (gold, (gdir / "v1" / f"{name}.gplz").read_bytes()):
            if not np.array_equal(core.decompress(blob), data):
                fail(f"golden {name}: decoded bytes differ")
    print(f"[golden] {len(raw_cases)} containers byte-identical, {2 * len(raw_cases)} blobs decoded")

    # -------------------------------------------------------- main path
    runs = [
        ("hurr-quant", 128 * MIB, core.LZSSConfig()),
        ("rtm-float32", 64 * MIB, core.LZSSConfig(symbol_size=4)),
        ("tpch-string", 64 * MIB, core.LZSSConfig(symbol_size=1)),
    ]
    inputs = {name: datasets.load(name, n) for name, n, _ in runs}
    batch = [inputs["hurr-quant"][i * 8 * MIB : (i + 1) * 8 * MIB] for i in range(8)]
    # warm-up: the first host-API call pays allocator and module set-up
    core.decompress(core.compress(batch[0][: MIB]).data)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    results, times = {}, {}
    for name, n, cfg in runs:
        t0 = time.perf_counter()
        res = core.compress(inputs[name], cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = core.decompress(res.data)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        results[name] = (res, back)
        times[name] = (t1 - t0, t2 - t1)
    t0 = time.perf_counter()
    many = core.compress_many(batch, core.LZSSConfig())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    many_back = core.decompress_many(many)
    torch.cuda.synchronize()
    times["batch 8 x 8 MiB hurr-quant"] = (t1 - t0, time.perf_counter() - t1)
    launches = ops.launch_counts()
    print(f"[main] launches on the main path: {launches}")
    if any(v < 1 for v in launches.values()):
        fail(f"a kernel was not launched on the main path: {launches}")

    for name, n, cfg in runs:
        res, back = results[name]
        if not np.array_equal(back, inputs[name]):
            fail(f"{name}: round trip is not exact")
        plain = core.compress(inputs[name], core.LZSSConfig(
            symbol_size=cfg.symbol_size, window=cfg.window, chunk_symbols=cfg.chunk_symbols,
            backend="torch"))
        if not np.array_equal(plain.data, res.data):
            fail(f"{name}: the kernels' container differs from the plain path's")
        print(f"[main] {name} {n // MIB} MiB S={cfg.symbol_size} W={cfg.window} "
              f"C={cfg.chunk_symbols}: ratio {res.ratio!r}, {res.total_bytes} bytes, exact, "
              f"equal to the plain path")
    plain_many = core.compress_many(batch, core.LZSSConfig(backend="torch"))
    if not np.array_equal(plain_many.data, many.data):
        fail("batch: the kernels' containers differ from the plain path's")
    if not all(np.array_equal(a, b) for a, b in zip(many_back, batch)):
        fail("batch: round trip is not exact")
    print(f"[main] batch 8 x 8 MiB: ratio {many.ratio!r}, exact, equal to the plain path")
    for name, (tc, td) in times.items():
        n = sum(b.size for b in batch) if name.startswith("batch") else inputs[name].size
        print(f"[time] {card} | {name}: compress {tc * 1e3:.1f} ms ({n / tc / 1e9:.3f} GB/s), "
              f"decompress {td * 1e3:.1f} ms ({n / td / 1e9:.3f} GB/s), host clock, "
              f"host API incl. copies")

    # ------------------------------------- host API stage breakdown
    # The stages of one compress + decompress of the 128 MiB hurr-quant
    # input, each timed on the host clock around a synchronize.
    data = inputs["hurr-quant"]
    stages = {}

    def stage(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[label] = (time.perf_counter() - t) * 1e3
        return out

    cfg = core.LZSSConfig()
    raw = stage("h2d input", lambda: torch.from_numpy(data).to(dev))
    sym = stage("pack symbols", lambda: pl.pack_symbols(raw, cfg.symbol_size).reshape(-1, cfg.chunk_symbols))
    buf, total = stage("compress_chunks (kernels I-III, zeros, header)",
                       lambda: pl.compress_chunks(sym, cfg, data.size))
    blob = stage("d2h container", lambda: buf[:total].cpu().numpy())
    h, nt, ps = stage("validate_container (numpy)", lambda: fmt.validate_container(blob))
    dblob = stage("h2d container + tables", lambda: (
        torch.from_numpy(blob).to(dev), torch.from_numpy(nt).to(dev), torch.from_numpy(ps).to(dev)))
    out = stage("decompress_chunks (gathers + decoder)", lambda: pl.decompress_chunks(
        *dblob, symbol_size=h.symbol_size, chunk_symbols=h.chunk_symbols, n_chunks=h.n_chunks))
    back = stage("unpack + d2h output", lambda: pl.unpack_symbols(out.reshape(-1), h.symbol_size).cpu().numpy())
    if not np.array_equal(back, data):
        fail("stage breakdown: round trip is not exact")
    for label, t in stages.items():
        print(f"[time] {card} | stage {label}: {t:.3f} ms, hurr-quant 128 MiB")

    # ------------------------------------------------- per-kernel times
    cfg = core.LZSSConfig()
    s, w, c = cfg.symbol_size, cfg.window, cfg.chunk_symbols
    raw = torch.from_numpy(inputs["hurr-quant"]).to(dev)
    sym = pl.pack_symbols(raw, s).reshape(-1, c)
    nc = sym.shape[0]
    kw = dict(window=w, min_match=cfg.min_match, symbol_size=s)
    k1 = lz_match.lz_kernel1_cuda(sym, **kw)
    args2 = (k1["n_tokens"][None], k1["payload_sizes"][None])
    fo, po, tot = lz_scatter.global_offsets_cuda(*args2)
    args3 = [sym[None]] + [k1[k][None] for k in ("lengths", "offsets", "emitted", "local_off")] + [fo, po]
    cap = fmt.max_compressed_bytes(nc * c * s, s, c)
    kw3 = dict(symbol_size=s, min_match=cfg.min_match, cap=cap, sec_flags=fmt.HEADER_BYTES + 8 * nc)
    blob = lz_scatter.scatter_cuda(*args3, **kw3)
    flags, pay, nt = sections(blob[0], k1["n_tokens"], k1["payload_sizes"], s, c)
    fs_ps = torch.stack([(k1["n_tokens"] + 7) // 8, k1["payload_sizes"]])

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    pos = nc * c
    comp = kernel1_compares(sym, w, c)
    flag_total, pay_total = (int(v) for v in tot[0].tolist())
    spec = {
        "lz_kernel1": dict(
            kernel=lambda: lz_match.lz_kernel1_cuda(sym, **kw),
            plain=lambda: lz_match.lz_kernel1_plain(sym, **kw),
            library=None, bytes=4 * pos + 13 * pos + 8 * nc, ops=comp,
            source="src/repro_torch/csrc/lz_match.cu",
            replaces="src/repro/kernels/lz_match.py:136"),
        "lz_global_offsets": dict(
            kernel=lambda: lz_scatter.global_offsets_cuda(*args2),
            plain=lambda: lz_scatter.global_offsets_plain(*args2),
            library=lambda: torch.cumsum(fs_ps, 1), bytes=8 * nc + 8 * nc + 8, ops=2 * nc,
            source="src/repro_torch/csrc/lz_scatter.cu",
            replaces="src/repro/kernels/lz_scatter.py:55"),
        "lz_scatter": dict(
            kernel=lambda: lz_scatter.scatter_cuda(*args3, **kw3),
            plain=lambda: lz_scatter.scatter_plain(*args3, **kw3),
            library=None, bytes=17 * pos + 8 * nc + cap, ops=pos,
            source="src/repro_torch/csrc/lz_scatter.cu",
            replaces="src/repro/kernels/lz_scatter.py:159"),
        "lz_decode": dict(
            kernel=lambda: lz_decode.lz_decode_cuda(flags, pay, nt, symbol_size=s),
            plain=lambda: lz_decode.lz_decode_plain(flags, pay, nt, symbol_size=s),
            library=None, bytes=flag_total + pay_total + 4 * nc + 4 * pos, ops=pos,
            source="src/repro_torch/csrc/lz_decode.cu",
            replaces="src/repro/kernels/lz_decode.py:122"),
    }
    record = []
    for name, k in spec.items():
        t_bytes = k["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = k["ops"] / INT32_OPS_PER_S * 1e3
        row = dict(
            name=name, route="cuda", source=k["source"], replaces=k["replaces"],
            launches=launches[name], max_abs_err=err[name],
            ms=ms(k["kernel"], 10), plain_ms=ms(k["plain"], 2),
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=ms(k["library"], 10) if k["library"] else None,
        )
        record.append(row)
        print(f"[time] {card} | {name}: {row['ms']:.4f} ms kernel, {row['plain_ms']:.4f} ms plain, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({k['bytes']} bytes, {k['ops']} int32 ops), at nc={nc} C={c} S={s} W={w}")
    # Kernel I's cost depends on the data: the far-to-near walk stops at
    # the first offset whose cap the best length reaches.  All-equal
    # symbols stop at once; two-symbol noise visits every offset.
    for label, x in (
        ("all-equal symbols", torch.zeros_like(sym)),
        ("two-symbol noise", torch.randint(0, 2, sym.shape, device=dev,
                                           generator=torch.Generator(dev).manual_seed(0),
                                           dtype=torch.int32)),
    ):
        t = ms(lambda: lz_match.lz_kernel1_cuda(x, **kw), 3)
        print(f"[time] {card} | lz_kernel1 on {label}: {t:.4f} ms "
              f"({kernel1_compares(x, w, c)} compares), at nc={nc} C={c} S={s} W={w}")
    print(f"[kernels] {launches} max |kernel - plain| {err}")
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def kernel1_compares(sym, window: int, c: int) -> int:
    """Symbol compares Kernel I's far-to-near window walk makes on ``sym``.

    For each position the walk visits offsets d = min(i, W) .. 1 while the
    cap min(d, 255, C - i) exceeds the best length so far; a visited offset
    costs one compare, plus min(run, cap - 1) more when its first symbol
    matches.  Computed offset by offset on the card, like the plain matcher.
    """
    import torch

    from repro_torch.core.match import capped_run_lengths

    x = sym.to(torch.int32)
    nc = x.shape[0]
    idx = torch.arange(c, device=x.device, dtype=torch.int32).expand(nc, c)
    padded = torch.cat([torch.zeros(nc, window, dtype=torch.int32, device=x.device), x], 1)
    best = torch.zeros_like(x)
    total = 0
    for d in range(window, 0, -1):
        cap = torch.clamp(c - idx, max=min(d, 255))
        visited = (idx >= d) & (cap > best)
        eq = (x == padded[:, window - d : window - d + c]) & (idx >= d)
        levels = 0
        while (1 << levels) < min(d, 255):
            levels += 1
        run = torch.minimum(capped_run_lengths(eq, levels), cap)
        hit = eq & visited
        total += int(visited.sum()) + int(torch.minimum(run, cap - 1)[hit].sum())
        best = torch.where(visited & (run > best), run, best)
    return total


if __name__ == "__main__":
    main()
