"""Smoke run of repro_torch on one NVIDIA card: build, check, drive, time.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc).  It imports nothing of JAX or of the reference package.
Phases, any failure of which exits non-zero:

  1. card       name and power limit (nvidia-smi), torch's device name
  2. build      the eleven kernels' seven sources from src/repro_torch/csrc,
                ptxas -v lines, and the registers and resident blocks per
                SM of the three kernels that walk the window, the two LZSS
                decoders, the gap decoder, the bitshuffle pair, the
                histogram, Kernel II and Kernel III (with its shared-memory
                layout)
  3. kernels    each CUDA kernel against its plain PyTorch version on the
                same CUDA tensors, exactly equal (integer outputs): the
                LZSS kernels (split, one-launch and match-only) at C=2048
                with S in {1,2,4} x W in {32,128,255}, and C=32768, the
                one-launch pair also against the split kernels and on a
                ragged batch of 3 blobs holding only their live bytes; the
                three kernels that walk the window on the walk's edge inputs
                (repro_torch/data/walk_edges.py) at C=2048 and at the
                largest chunks accepted (C=38,568 at S=4, 57,856 at S=1); the
                two LZSS decoders on the decoders' edge inputs
                (repro_torch/data/decode_edges.py: literal-only chunks, the
                deepest copy chain, a partial last tile, mixed runs) at C=8
                and 2048 with S in {1,2,4} and at C=38,568 (S=4) and 57,856
                (S=1), and the gap decoder on its edge codes; the
                byte histogram over
                unaligned ranges of a 37 MB container; the gap decoder on
                a skewed code, a stored-escape code and partial last
                sub-blocks; bitshuffle / unshuffle on the pair's edge inputs
                (repro_torch/data/bitshuffle_edges.py: five patterns at
                block counts around a tile, the one-hot map, 65,536 and
                65,537 blocks), on views that are not 16-byte aligned and
                into larger out= buffers; Kernel III and the histogram on
                their edge inputs (repro_torch/data/scatter_edges.py:
                literal-only, pointer-only, ragged and mixed chunks at C in
                {8, 40, 2056, 32768} and either side of the staged layout's
                limit, S in {1,2,4}, both layouts; byte patterns at every
                start mod 16 and lengths 0, 1, 15, 16, 17; 64 MiB of one
                value); Kernel II on its edge inputs
                (repro_torch/data/offsets_edges.py: five kinds at nc from 1
                to 262,144 and 1, 3 and 8 rows, through the wrapper and the
                C entry point, and on views at every 16-byte residue)
  4. golden     the 12 golden inputs (7 raw, 3 deflate-full, 2 lossy-fz)
                compress to their .gplz bytes; the 12 current and 7
                version-1 blobs decode (lossy ones within their bound)
  5. main path  the host API at real sizes, in two paths, each with the
                launch counts set to 0 before it and read after it: the
                raw LZSS codec and the two container formats
                (deflate-full, lossy-fz at eb=1e-3 with a deflate-full
                inner stage and at eb=0, and a compress_many batch).  The
                raw path runs the default one-launch pair (exactly one
                launch per compress and per decompress call, single or
                batched, and no split kernel), the split kernels
                (backend="fused-deflate", decoder="fused") and the
                match-only backend ("cuda-match"); round trips exact or
                within eb, containers equal to the plain PyTorch path run
                on the card, no plain emit tail on the default path, and
                the bitshuffle pair's pointers 16-byte aligned there
  5b. modules   the codec's modules, one path each, the launch counts set
                to 0 before it and read after it (each must launch its
                kernels): the chunk-geometry tuner (the one-launch pair
                against its plain versions at every C of the ladder, S in
                {1,2,4}, on the sweep's 32 MiB inputs; the joint sweeps over
                C in both directions at S=2 and 4 with each candidate's
                time, the cache validated and re-read with zero sweeps;
                hurr-quant 128 MiB at the tuned C equal to the plain path);
                ParamSelector over the datasets on the card and on the CPU
                (equal picks and ratios); the "sharded" batch layer and
                deflate-full with meshes of one and two cuda:0 at B=3, equal
                to the unsharded compress_many; the Fig. 8-10 twins (fig8
                at 128 KiB / 64 KiB with the recorded ratios, fig9 and
                fig10 at 1 MiB and at 128 MiB, JSONs to chiprun_out/); the
                Prefetcher on the card over 4 steps; the model zoo
                (models_phase, plain PyTorch, no kernel of the table):
                llama3.2-1b whole in bf16 (prefill (4, 2048), dense and
                paged decode of a 512-token prompt + 32 greedy tokens,
                paged bit-identical to dense, times and peak memory), all
                ten architectures at published width cut to 2 layers
                (decode against forward in f32 with TF32 off, loss_fn,
                bf16 prefill (2, 1024)), the reduced configs on the card
                against the CPU, and layer 0's K cache through the codec;
                the serving engine (serving_phase: llama3.2-1b whole, 4
                sequences of a 128-token prompt + 32 greedy tokens, dense
                and through the compressed paged tier at 40 blocks of
                budget with prefetch and async prefetch, deflate-full on a
                2-layer cut, hymba's window on a 2-layer cut; paged tokens
                bit-identical to dense, one launch of the one-launch pair a
                round, sampled rounds equal to the plain path; rounds timed)
                and the gradient exchange (grad_phase: llama3.2-1b's
                gradients of two pods over a mesh of two cuda:0, ratio_cap
                1.0 and 2.0 and lossy, equal to the per-pod quantize mean
                at 1.0, lossy error within eb, sampled wires equal to the
                plain path's; then one adamw_update); the trainer
                (train_phase: llama3.2-1b whole, batch 8 x 256, through
                launch.train.main: a run killed by a simulated crash at
                its step-6 save after saving step 3, a run resumed from
                step 3 with asynchronous checkpoints, a straight run, all
                equal bit for bit under deterministic algorithms; each
                save and restore one launch of the one-launch pair a
                group, timed in parts; step 6 restored alone bit for bit;
                two groups' containers equal to the plain path's; a lossy
                checkpoint within eb; two compressed steps over a mesh of
                two cuda:0 pods; launch.serve.main on the reduced config);
                the last slice's modules (bench_phase: the dry run of
                llama3.2-1b x {train_4k, prefill_32k, decode_32k} on both
                production meshes, traced on meta, and its prefill (4,
                2048) counted on meta and on the card, equal, beside its
                measured time; the paper's tables 1-3 and fig_lossy at 64
                and 128 MiB through their twins, one launch a host call;
                kv_paging and sharded_batch at the reference's defaults;
                after step 6's times, the four examples as subprocesses,
                each exiting 0)
  6. times      host-clock throughput of the main path, the one-launch and
                split host APIs in turns, a stage breakdown
                of one raw and one lossy-fz round trip, CUDA-event times of
                each kernel, its plain version and, where one exists, the
                PyTorch call computing the same function, at the main
                path's shapes, and each kernel's bound; the three walking
                kernels also on all-equal symbols and two-symbol noise, and
                the compressor's time split into the walk, the selection
                and scan, and the one-launch phases B + C; the two LZSS
                decoders also on all-literal and long-chain chunks, and the
                gap decoder also on the container's flag section and on a
                stored-escape section of the payload's size; beside the
                bitshuffle pair, a device-to-device copy of its bytes;
                Kernel III alone and through its wrapper, and the histogram
                alone and through its wrapper, with the L2 hot and cold, on
                the payload section, the flag section and one value; Kernel
                II through its wrapper and alone (its C entry into
                preallocated outputs) at nc = 32,768, 8 rows of 2,048 and
                262,144, beside a one-element launch (x.add_(1)) and a
                device-to-device copy moving as many bytes

The last two lines of standard output are the kernels' JSON record and the
device record {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
MIB = 1 << 20


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
    # cuBLAS's fixed workspaces, which torch.use_deterministic_algorithms
    # needs in train_phase; read when cuBLAS first starts, so set first
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import core
    from repro_torch.core import deflate, format as fmt, pipeline as pl
    from repro_torch.data import datasets, decode_edges, scatter_edges, walk_edges
    from repro_torch.benchmarks.kernel_roofline import bound_ms, kernel1_compares, kernel_bytes_ops
    from repro_torch.kernels import (
        _build, lz_decode, lz_decode_mono, lz_entropy, lz_fused, lz_match, lz_scatter, ops)
    # the H100 data sheet's rates, from their one home
    from repro_torch.launch.roofline import HBM_BW

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.SOURCES)} sources for {len(ops.KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, lines in _build.ptxas_report().items():
        for ln in lines:
            print(f"[build] {name}: {ln}")
    for s, c in ((2, 2048), (4, 38568), (1, 57856)):
        occ = lz_match.walk_occupancy(symbol_size=s, chunk_symbols=c)
        occ.update(lz_decode.decode_occupancy(symbol_size=s, chunk_symbols=c))
        print(f"[build] at S={s} C={c}: " + ", ".join(
            f"{k} {r} registers a thread, {b} resident blocks per SM" for k, (r, b) in occ.items()))
    r, b = lz_entropy.gap_decode_occupancy()
    print(f"[build] huffman_gap_decode {r} registers a thread, {b} resident blocks per SM")
    from repro_torch.kernels import lz_bitshuffle

    print("[build] " + ", ".join(f"{k} {r} registers a thread, {b} resident blocks per SM"
                                 for k, (r, b) in lz_bitshuffle.bitshuffle_occupancy().items()))
    r, b = lz_entropy.histogram_occupancy()
    print(f"[build] byte_histogram {r} registers a thread, {b} resident blocks per SM")
    r, b = lz_scatter.global_offsets_occupancy()
    print(f"[build] lz_global_offsets {r} registers a thread, {b} resident blocks per SM")
    for s, c in [(2, 2048)] + [(s, c) for s in (1, 2, 4) for c in scatter_edges.layout_edge(s)]:
        occ = lz_scatter.scatter_occupancy(chunk_symbols=c, symbol_size=s)
        print(f"[build] lz_scatter at S={s} C={c}: {occ['registers']} registers a thread, "
              f"{occ['blocks']} resident blocks per SM, {occ['layout']} layout")

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
        ml = lz_match.lz_match_cuda(sym, window=w, symbol_size=s)
        pl_ = lz_match.lz_match_plain(sym, window=w, symbol_size=s)
        err["lz_match"] = max(err["lz_match"], *(diff(a, b) for a, b in zip(ml, pl_)))
        hold_mono(sym[None], s, w, c, blob, (p1["n_tokens"][None], p1["payload_sizes"][None], p2[2]), d[None])
        print(f"[kernels] S={s} W={w} C={c} nc={nc}: {total} container bytes, "
              f"max |kernel - plain| so far {err}")

    def hold_mono(sym, s, w, c, split_blob, split_tables, split_symbols) -> None:
        """The one-launch pair on (B, nc, C) symbols against its plain
        versions and the split kernels' blobs, tables and symbols; the
        decoder reads blobs cut to the longest live end (each row's bytes
        past its live end are zeros)."""
        nc = sym.shape[1]
        kwm = dict(window=w, min_match=core.LZSSConfig(symbol_size=s).min_match, symbol_size=s,
                   cap=fmt.max_compressed_bytes(nc * c * s, s, c), sec_flags=fmt.HEADER_BYTES + 8 * nc)
        mono = lz_fused.lz_fused_mono_cuda(sym, **kwm)
        err["lz_fused_mono"] = max(err["lz_fused_mono"], *(
            diff(a, b) for a, b in zip(mono, lz_fused.lz_fused_mono_plain(sym, **kwm))))
        if diff(mono[0], split_blob) or any(diff(a, b) for a, b in zip(mono[1:], split_tables)):
            fail(f"one-launch compressor differs from the split kernels at S={s} W={w} C={c}")
        live = kwm["sec_flags"] + int(mono[3].sum(1).max())
        args = (mono[0][:, :live].contiguous(), mono[1], mono[2])
        dm = lz_decode_mono.lz_decode_mono_cuda(*args, symbol_size=s, chunk_symbols=c)
        err["lz_decode_mono"] = max(err["lz_decode_mono"], diff(
            dm, lz_decode_mono.lz_decode_mono_plain(*args, symbol_size=s, chunk_symbols=c)))
        if diff(dm, split_symbols) or diff(dm, sym):
            fail(f"one-launch decoder differs from the split decoder at S={s} W={w} C={c}")

    def hold_ragged(s, w, c, nc) -> None:
        """A batch of 3 unlike buffers (data, data with a zeroed half,
        noise) through the split kernels and the one-launch pair."""
        n = nc * c * s
        raws = [pool[s][:n].copy(), pool[s][n : 2 * n].copy(),
                np.random.default_rng(c).integers(0, 256, n).astype(np.uint8)]
        raws[1][n // 2 :] = 0
        sym = torch.stack([pl.pack_symbols(torch.from_numpy(r).to(dev), s).reshape(nc, c)
                           for r in raws])
        kw = dict(window=w, min_match=core.LZSSConfig(symbol_size=s).min_match, symbol_size=s)
        k1 = lz_match.lz_kernel1_cuda(sym.reshape(3 * nc, c), **kw)
        k1 = {k: v.reshape(3, nc, *v.shape[1:]) for k, v in k1.items()}
        fo, po, tot = lz_scatter.global_offsets_cuda(k1["n_tokens"], k1["payload_sizes"])
        blob = lz_scatter.scatter_cuda(
            sym, k1["lengths"], k1["offsets"], k1["emitted"], k1["local_off"], fo, po,
            symbol_size=s, min_match=kw["min_match"], cap=fmt.max_compressed_bytes(n, s, c),
            sec_flags=fmt.HEADER_BYTES + 8 * nc)
        d = torch.stack([lz_decode.lz_decode_cuda(*sections(blob[r], k1["n_tokens"][r],
                                                            k1["payload_sizes"][r], s, c),
                                                  symbol_size=s) for r in range(3)])
        hold_mono(sym, s, w, c, blob, (k1["n_tokens"], k1["payload_sizes"], tot), d)
        print(f"[kernels] ragged batch of 3 at S={s} W={w} C={c} nc={nc}: live ends "
              f"{[fmt.HEADER_BYTES + 8 * nc + int(t) for t in tot.sum(1).tolist()]}, "
              f"one-launch pair equal to its plain versions and the split kernels")

    def hold_walk(kind, s, w, c, nc) -> None:
        """The three kernels that walk the window on one edge input."""
        sym = torch.from_numpy(walk_edges.walk_edge_symbols(kind, nc, c, s, w)).to(dev)
        got = lz_match.lz_match_cuda(sym, window=w, symbol_size=s)
        err["lz_match"] = max(err["lz_match"], *(
            diff(a, b) for a, b in zip(got, lz_match.lz_match_plain(sym, window=w, symbol_size=s))))
        kw = dict(window=w, min_match=core.LZSSConfig(symbol_size=s).min_match, symbol_size=s)
        k1, p1 = lz_match.lz_kernel1_cuda(sym, **kw), lz_match.lz_kernel1_plain(sym, **kw)
        err["lz_kernel1"] = max(err["lz_kernel1"], *(diff(k1[k], p1[k]) for k in p1))
        kw.update(cap=fmt.max_compressed_bytes(nc * c * s, s, c), sec_flags=fmt.HEADER_BYTES + 8 * nc)
        mono = lz_fused.lz_fused_mono_cuda(sym[None], **kw)
        err["lz_fused_mono"] = max(err["lz_fused_mono"], *(
            diff(a, b) for a, b in zip(mono, lz_fused.lz_fused_mono_plain(sym[None], **kw))))

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
    for s, w, c, nc in ((2, 128, 2048, 64), (4, 255, 2048, 32), (1, 32, 32768, 4)):
        hold_ragged(s, w, c, nc)
    hold_scatter_edges(err)
    hold_offsets_edges(err)
    edges = [(kind, s, w, 2048, 32) for kind in walk_edges.KINDS
             for s, w in ((1, 1), (2, 128), (4, 255))]
    edges += [(kind, s, w, c, 2) for s, w, c in ((4, 128, 38568), (1, 255, 57856))
              for kind in ("word-cross", "cap", "chunk-end")]
    for case in edges:
        hold_walk(*case)

    def hold_decode(kind, s, c, nc) -> None:
        """The two LZSS decoders on one edge container."""
        x, blob, nt, ps = (torch.from_numpy(a).to(dev) for a in
                           decode_edges.lz_edge_container(kind, nc, c, s, device=dev))
        flags, pay, _ = sections(blob, nt, ps, s, c)
        d = lz_decode.lz_decode_cuda(flags, pay, nt, symbol_size=s)
        err["lz_decode"] = max(err["lz_decode"], diff(d, lz_decode.lz_decode_plain(
            flags, pay, nt, symbol_size=s)))
        args, kw = (blob[None], nt[None], ps[None]), dict(symbol_size=s, chunk_symbols=c)
        dm = lz_decode_mono.lz_decode_mono_cuda(*args, **kw)
        err["lz_decode_mono"] = max(err["lz_decode_mono"], diff(
            dm, lz_decode_mono.lz_decode_mono_plain(*args, **kw)))
        if diff(d, x) or diff(dm[0], x):
            fail(f"a decoder does not decode the {kind} edge at S={s} C={c}")

    decodes = [(kind, s, c, 2 if c > 2048 else 16) for kind in decode_edges.LZ_KINDS
               for s, c in ((1, 8), (2, 8), (4, 8), (1, 2048), (2, 2048), (4, 2048), (4, 38568),
                            (1, 57856))]
    for case in decodes:
        hold_decode(*case)
    for gap_kind in decode_edges.GAP_KINDS:
        inp = decode_edges.gap_edge_inputs(gap_kind, device=dev)
        gargs = [inp[k] for k in ("blob", "wstarts", "rems", "first", "count", "base", "order")]
        got = lz_entropy.huffman_gap_decode_cuda(*gargs, sub=decode_edges.SUB)
        err["huffman_gap_decode"] = max(err["huffman_gap_decode"], diff(
            got, lz_entropy.huffman_gap_decode_plain(*gargs, sub=decode_edges.SUB)))
        if not np.array_equal(got.reshape(-1)[: inp["section"].size].cpu().numpy(), inp["section"]):
            fail(f"the gap decoder does not decode the {gap_kind} edge")
    print(f"[kernels] the decoders' edges ({len(decodes)} containers: "
          f"{', '.join(decode_edges.LZ_KINDS)}; C in {{8, 2048, 38568, 57856}}; gap codes "
          f"{', '.join(decode_edges.GAP_KINDS)}): max |kernel - plain| lz_decode "
          f"{err['lz_decode']}, lz_decode_mono {err['lz_decode_mono']}, huffman_gap_decode "
          f"{err['huffman_gap_decode']}")
    print(f"[kernels] the walk's edges ({len(edges)} cases: {', '.join(walk_edges.KINDS)}; "
          f"W in {{1, 128, 255}}, C in {{2048, 38568, 57856}}): max |kernel - plain| "
          f"lz_match {err['lz_match']}, lz_kernel1 {err['lz_kernel1']}, "
          f"lz_fused_mono {err['lz_fused_mono']}")
    runs = [
        ("hurr-quant", 128 * MIB, core.LZSSConfig()),
        ("rtm-float32", 64 * MIB, core.LZSSConfig(symbol_size=4)),
        ("tpch-string", 64 * MIB, core.LZSSConfig(symbol_size=1)),
    ]
    inputs = {name: datasets.load(name, n) for name, n, _ in runs}
    inputs["hurr-field"] = datasets.load("hurr-field", 128 * MIB)
    stage_in = hold_container_kernels(inputs["hurr-quant"], err)
    torch.cuda.synchronize()
    if any(err.values()):
        fail(f"a kernel disagrees with its plain version: {err}")

    # ----------------------------------------------------------- golden
    gdir = ROOT / "tests" / "golden"
    cases = sorted(p.name[:-10] for p in gdir.glob("*.input.bin"))
    if len(cases) != 12:
        fail(f"expected 12 golden cases, found {cases}")
    n_blobs = 0
    for name in cases:
        m = re.fullmatch(r"\w+?_s(\d)_w(\d+)_c(\d+)(_deflate|_lossy|_lossy_eb0)?", name)
        s, w, c = map(int, m.groups()[:3])
        suffix = m.group(4) or ""
        eb = {"_lossy": 1e-3, "_lossy_eb0": 0.0}.get(suffix)
        kw = dict(symbol_size=s, window=w, chunk_symbols=c)
        if suffix == "_deflate":
            kw["backend"] = "deflate-full"
        elif eb is not None:
            kw.update(backend="lossy-fz", lossy_eb=eb)
        data = np.frombuffer((gdir / f"{name}.input.bin").read_bytes(), np.uint8)
        gold = (gdir / f"{name}.gplz").read_bytes()
        if bytes(core.compress(data, core.LZSSConfig(**kw)).data) != gold:
            fail(f"golden {name}: container bytes differ")
        blobs = [gold]
        if not suffix:
            blobs.append((gdir / "v1" / f"{name}.gplz").read_bytes())
        for blob in blobs:
            out = core.decompress(blob)
            if eb:
                bad = lossy_error(data, out, eb)
                if bad:
                    fail(f"golden {name}: {bad}")
            elif not np.array_equal(out, data):
                fail(f"golden {name}: decoded bytes differ")
            n_blobs += 1
    print(f"[golden] {len(cases)} containers byte-identical, {n_blobs} blobs decoded "
          f"(lossy within eb, eb=0 bit-exact)")

    # -------------------------------------------------------- main path
    batch = [inputs["hurr-quant"][i * 8 * MIB : (i + 1) * 8 * MIB] for i in range(8)]
    # warm-up: the first host-API call pays allocator and module set-up
    core.decompress(core.compress(batch[0][: MIB]).data)
    torch.cuda.synchronize()

    # Each host-API call of the raw path is driven through ``call``: it
    # times the call and checks the launches it made (the count deltas)
    # and the plain emit tail's calls against what its entries must launch.
    default = {"compress": {"lz_fused_mono": 1}, "decompress": {"lz_decode_mono": 1}}
    split = {"compress": {"lz_kernel1": 1, "lz_global_offsets": 1, "lz_scatter": 1},
             "decompress": {"lz_decode": 1}}
    emit_calls = count_calls(pl, "emit_torch")

    def call(label, fn, want):
        before = dict(ops.launch_counts(), emit_torch=emit_calls[0])
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        after = dict(ops.launch_counts(), emit_torch=emit_calls[0])
        made = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if made != want:
            fail(f"{label}: launched {made}, expected {want}")
        return out, t

    ops.reset_launch_counts()
    results, times = {}, {}
    for name, n, cfg in runs:
        res, tc = call(f"{name} compress", lambda: core.compress(inputs[name], cfg),
                       default["compress"])
        back, td = call(f"{name} decompress", lambda: core.decompress(res.data),
                        default["decompress"])
        results[name] = (res, back)
        times[name] = (tc, td)
    many, tc = call("batch compress_many", lambda: core.compress_many(batch, core.LZSSConfig()),
                    default["compress"])
    many_back, td = call("batch decompress_many", lambda: core.decompress_many(many),
                         default["decompress"])
    times["batch 8 x 8 MiB hurr-quant"] = (tc, td)
    hq = inputs["hurr-quant"]
    split_cfg = core.LZSSConfig(backend="fused-deflate", decoder="fused")
    split_res, tc = call("split compress", lambda: core.compress(hq, split_cfg), split["compress"])
    split_back, td = call("split decompress", lambda: core.decompress(split_res.data, "fused"),
                          split["decompress"])
    times["hurr-quant split kernels (fused-deflate / fused)"] = (tc, td)
    match_res, tc = call("cuda-match compress",
                         lambda: core.compress(hq, core.LZSSConfig(backend="cuda-match")),
                         {"lz_match": 1, "emit_torch": 1})
    times["hurr-quant cuda-match (then the default decoder)"] = (
        tc, call("cuda-match decompress", lambda: core.decompress(match_res.data),
                 default["decompress"])[1])
    launches = ops.launch_counts()
    print(f"[main] launches on the raw LZSS path: {launches}, plain emit tail calls "
          f"{emit_calls[0]} (the cuda-match run's)")
    if any(launches[k] < 1 for k in RAW_KERNELS):
        fail(f"a kernel was not launched on the raw LZSS path: {launches}")

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
    hq_plain = results["hurr-quant"][0].data
    for label, res, back in (("split kernels", split_res, split_back),
                             ("cuda-match", match_res, None)):
        if not np.array_equal(res.data, hq_plain):
            fail(f"hurr-quant {label}: the container differs from the plain path's")
        if back is not None and not np.array_equal(back, hq):
            fail(f"hurr-quant {label}: round trip is not exact")
        print(f"[main] hurr-quant 128 MiB through the {label}: equal to the plain path")
    plain_many = core.compress_many(batch, core.LZSSConfig(backend="torch"))
    if not np.array_equal(plain_many.data, many.data):
        fail("batch: the kernels' containers differ from the plain path's")
    if not all(np.array_equal(a, b) for a, b in zip(many_back, batch)):
        fail("batch: round trip is not exact")
    print(f"[main] batch 8 x 8 MiB: ratio {many.ratio!r}, exact, equal to the plain path")
    ctimes, claunches = container_main_path(inputs, emit_calls)
    times.update(ctimes)
    launches = {k: launches[k] + claunches[k] for k in ops.KERNELS}
    for name, (tc, td) in times.items():
        n = sum(b.size for b in batch) if name.startswith("batch") else inputs[name.split()[0]].size
        print(f"[time] {card} | {name}: compress {tc * 1e3:.1f} ms ({n / tc / 1e9:.3f} GB/s), "
              f"decompress {td * 1e3:.1f} ms ({n / td / 1e9:.3f} GB/s), host clock, "
              f"host API incl. copies")

    # ----------------------- the one-launch pair and the split kernels, in turns
    # Host-API compress and decompress of the 128 MiB hurr-quant input through
    # each, in the order one-launch, split, split, one-launch, eight times.
    entries = {"one-launch": (core.LZSSConfig(backend="fused-mono"), "fused-mono", default),
               "split": (core.LZSSConfig(backend="fused-deflate"), "fused", split)}
    turns = {who: ([], []) for who in entries}
    for who in ("one-launch", "split", "split", "one-launch") * 8:
        cfg, dec, want = entries[who]
        res, tc = call(f"{who} compress", lambda: core.compress(hq, cfg), want["compress"])
        back, td = call(f"{who} decompress", lambda: core.decompress(res.data, dec),
                        want["decompress"])
        if not (np.array_equal(res.data, hq_plain) and np.array_equal(back, hq)):
            fail(f"{who}: round trip of hurr-quant is not exact or not the plain container")
        turns[who][0].append(tc * 1e3)
        turns[who][1].append(td * 1e3)
    for i, direction in enumerate(("compress", "decompress")):
        one, two = (sum(turns[w][i]) / len(turns[w][i]) for w in entries)
        print(f"[time] {card} | host API {direction}, hurr-quant 128 MiB, in turns: "
              f"one-launch mean {one:.3f} ms {[round(t, 3) for t in turns['one-launch'][i]]}, "
              f"split mean {two:.3f} ms {[round(t, 3) for t in turns['split'][i]]}; "
              f"{'one-launch' if one <= two else 'split'} faster; default "
              f"{pl.default_backend(dev) if i == 0 else pl.default_decoder(dev)}")

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
    buf, total = stage("compress_chunks (the one-launch compressor, header)",
                       lambda: pl.compress_chunks(sym, cfg, data.size))
    blob = stage("d2h container", lambda: buf[:total].cpu().numpy())
    h, nt, ps = stage("validate_container (numpy)", lambda: fmt.validate_container(blob))
    dblob = stage("h2d container + tables", lambda: (
        torch.from_numpy(blob).to(dev), torch.from_numpy(nt).to(dev), torch.from_numpy(ps).to(dev)))
    out = stage("decompress_chunks (the one-launch decoder)", lambda: pl.decompress_chunks(
        *dblob, symbol_size=h.symbol_size, chunk_symbols=h.chunk_symbols, n_chunks=h.n_chunks))
    back = stage("unpack + d2h output", lambda: pl.unpack_symbols(out.reshape(-1), h.symbol_size).cpu().numpy())
    if not np.array_equal(back, data):
        fail("stage breakdown: round trip is not exact")
    split_buf, _ = stage("  split path: compress_chunks (Kernels I-III, zeros, header)",
                         lambda: pl.compress_chunks(sym, core.LZSSConfig(backend="fused-deflate"),
                                                    data.size))
    split_out = stage("  split path: decompress_chunks (gathers + decoder)",
                      lambda: pl.decompress_chunks(*dblob, symbol_size=h.symbol_size,
                                                   chunk_symbols=h.chunk_symbols,
                                                   n_chunks=h.n_chunks, decoder="fused"))
    if not (torch.equal(split_buf, buf) and torch.equal(split_out, out)):
        fail("stage breakdown: the split path differs from the one-launch pair")
    for label, t in stages.items():
        print(f"[time] {card} | stage {label}: {t:.3f} ms, hurr-quant 128 MiB")
    lossy_stage_breakdown(inputs["hurr-field"], card)

    # ------------------------------ the codec's modules: one path each
    seconds = {}
    # serving and grad run before models: right after the gradient exchange
    # the bitshuffle pair and the gap decoder time 7-18% slower for a moment
    # (tools/phase_aftermath.py), so models_phase stands between the
    # exchange and the per-kernel times below, as it did before
    for phase in (autotune_phase, params_phase, sharded_phase, twins_phase, data_phase,
                  serving_phase, grad_phase, train_phase, bench_phase, models_phase):
        t0 = time.perf_counter()
        phase(inputs, card, err)
        seconds[phase.__name__[: -len("_phase")]] = time.perf_counter() - t0
    if any(err.values()):
        fail(f"a kernel disagrees with its plain version: {err}")
    print(f"[phases] {card} | seconds of the module phases: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))

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
    kwm = dict(kw, cap=cap, sec_flags=kw3["sec_flags"])
    mono = lz_fused.lz_fused_mono_cuda(sym[None], **kwm)
    live = kwm["sec_flags"] + int(mono[3].sum())
    argsm = (mono[0][:, :live].contiguous(), mono[1], mono[2])  # the container's live bytes
    kwd = dict(symbol_size=s, chunk_symbols=c)

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

    comp = kernel1_compares(sym, w, c)
    flag_total, pay_total = (int(v) for v in tot[0].tolist())
    spec = {
        "lz_kernel1": dict(
            kernel=lambda: lz_match.lz_kernel1_cuda(sym, **kw),
            plain=lambda: lz_match.lz_kernel1_plain(sym, **kw),
            library=None, cost=kernel_bytes_ops("lz_kernel1", nc=nc, c=c, compares=comp),
            source="src/repro_torch/csrc/lz_match.cu",
            replaces="src/repro/kernels/lz_match.py:136"),
        "lz_global_offsets": dict(
            kernel=lambda: lz_scatter.global_offsets_cuda(*args2),
            plain=lambda: lz_scatter.global_offsets_plain(*args2),
            library=lambda: torch.cumsum(fs_ps, 1), cost=kernel_bytes_ops("lz_global_offsets", nc=nc),
            source="src/repro_torch/csrc/lz_scatter.cu",
            replaces="src/repro/kernels/lz_scatter.py:55"),
        "lz_scatter": dict(
            kernel=lambda: lz_scatter.scatter_cuda(*args3, **kw3),
            plain=lambda: lz_scatter.scatter_plain(*args3, **kw3),
            library=None, cost=kernel_bytes_ops("lz_scatter", nc=nc, c=c, cap=cap),
            source="src/repro_torch/csrc/lz_scatter.cu",
            replaces="src/repro/kernels/lz_scatter.py:159"),
        "lz_decode": dict(
            kernel=lambda: lz_decode.lz_decode_cuda(flags, pay, nt, symbol_size=s),
            plain=lambda: lz_decode.lz_decode_plain(flags, pay, nt, symbol_size=s),
            library=None, cost=kernel_bytes_ops("lz_decode", nc=nc, c=c, flag_bytes=flag_total,
                                                payload_bytes=pay_total),
            source="src/repro_torch/csrc/lz_decode.cu",
            replaces="src/repro/kernels/lz_decode.py:122"),
        "lz_fused_mono": dict(
            kernel=lambda: lz_fused.lz_fused_mono_cuda(sym[None], **kwm),
            plain=lambda: lz_fused.lz_fused_mono_plain(sym[None], **kwm), plain_reps=1,
            library=None, cost=kernel_bytes_ops("lz_fused_mono", nc=nc, c=c, cap=cap, compares=comp),
            source="src/repro_torch/csrc/lz_fused.cu",
            replaces="src/repro/kernels/lz_fused.py:63"),
        "lz_decode_mono": dict(
            kernel=lambda: lz_decode_mono.lz_decode_mono_cuda(*argsm, **kwd),
            plain=lambda: lz_decode_mono.lz_decode_mono_plain(*argsm, **kwd),
            library=None, cost=kernel_bytes_ops("lz_decode_mono", nc=nc, c=c, flag_bytes=flag_total,
                                                payload_bytes=pay_total),
            source="src/repro_torch/csrc/lz_decode_mono.cu",
            replaces="src/repro/kernels/lz_decode_mono.py:55"),
        "lz_match": dict(
            kernel=lambda: lz_match.lz_match_cuda(sym, window=w, symbol_size=s),
            plain=lambda: lz_match.lz_match_plain(sym, window=w, symbol_size=s),
            library=None, cost=kernel_bytes_ops("lz_match", nc=nc, c=c, compares=comp),
            source="src/repro_torch/csrc/lz_match.cu",
            replaces="src/repro/kernels/lz_match.py:90"),
        **container_kernel_spec(stage_in),
    }
    record = []
    for name, k in spec.items():
        nbytes, nops = k["cost"]
        bound, bound_by = bound_ms(nbytes, nops)
        row = dict(
            name=name, route="cuda", source=k["source"], replaces=k["replaces"],
            launches=launches[name], max_abs_err=err[name],
            ms=ms(k["kernel"], 10), plain_ms=ms(k["plain"], k.get("plain_reps", 2)),
            bound_ms=bound, bound_by=bound_by,
            library_ms=ms(k["library"], 10) if k["library"] else None,
        )
        record.append(row)
        lib = "" if row["library_ms"] is None else f", {row['library_ms']:.4f} ms library"
        print(f"[time] {card} | {name}: {row['ms']:.4f} ms kernel, {row['plain_ms']:.4f} ms plain"
              f"{lib}, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({nbytes} bytes, {nops} int32 ops), at {k.get('at', f'nc={nc} C={c} S={s} W={w}')}")
    t = {row["name"]: row["ms"] for row in record}
    # The practical ceiling of a permutation of the bitshuffle pair's bytes:
    # a device-to-device copy of as many (not the same function: no library
    # column for it).
    src8 = torch.empty_like(stage_in["shuffled"])
    dst8 = torch.empty_like(src8)
    print(f"[time] {card} | D2D copy of the bitshuffle pair's {src8.numel()} bytes "
          f"(dst.copy_(src)): {ms(lambda: dst8.copy_(src8), 10):.4f} ms, beside bitshuffle "
          f"{t['bitshuffle']:.4f} ms and bitunshuffle {t['bitunshuffle']:.4f} ms")
    # Kernel III and the histogram alone (their C entry points into
    # preallocated outputs) beside the wrapper times of their rows; the
    # histogram also with the L2 cold: a 128 MiB write before each launch,
    # each launch timed alone.
    flush = torch.empty(128 * MIB, dtype=torch.uint8, device=dev)

    def ms_cold(fn, reps):
        fn()
        evs = []
        for i in range(reps):
            flush.fill_(i)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in evs) / reps

    stream = torch.cuda.current_stream().cuda_stream
    lib3, libh = _build.library("lz_scatter"), _build.library("lz_entropy")
    cargs = [a.contiguous() for a in args3]
    cargs[3] = cargs[3].view(torch.uint8)
    pre = torch.zeros(1, cap, dtype=torch.uint8, device=dev)
    alone = ms(lambda: lib3.lz_scatter_launch(
        *[a.data_ptr() for a in cargs], 1, nc, c, s, cfg.min_match, kw3["sec_flags"], cap,
        pre.data_ptr(), stream), 10)
    if not torch.equal(pre, blob):
        fail("Kernel III alone (the C entry point) differs from its wrapper")
    occ = lz_scatter.scatter_occupancy(chunk_symbols=c, symbol_size=s)
    print(f"[time] {card} | lz_scatter alone (C entry, preallocated blob) {alone:.4f} ms, "
          f"through the wrapper (its zeroed blob) {t['lz_scatter']:.4f} ms, bound "
          f"{kernel_bytes_ops('lz_scatter', nc=nc, c=c, cap=cap)[0] / HBM_BW * 1e3:.4f} ms; "
          f"{occ['registers']} "
          f"registers, {occ['blocks']} blocks per SM, {occ['layout']} layout, at nc={nc} C={c} "
          f"S={s}")
    # Kernel II alone (its C entry into preallocated outputs) beside its
    # wrapper: its floor is a launch, so beside them a one-element add
    # launched back to back and a device-to-device copy moving as many bytes
    # as its bound counts; at the main path's nc, 8 rows of 2,048 (8 x 8 MiB)
    # and nc = 262,144 (1 GiB at C = 2048, S = 2; synthetic sizes).
    from repro_torch.data import offsets_edges

    one = torch.zeros(1, dtype=torch.int32, device=dev)
    launch_floor = ms(lambda: one.add_(1), 50)
    for label, rows2, nc2 in (("hurr-quant 128 MiB", 1, nc), ("8 rows of 2,048", 8, 2048),
                              ("1 row of 262,144 (synthetic)", 1, 262144)):
        if nc2 == nc and rows2 == 1:
            nt2, ps2 = args2
        else:
            nt2, ps2 = (torch.from_numpy(a).to(dev) for a in
                        offsets_edges.offsets_inputs("random", rows2, nc2))
        pre2 = tuple(torch.empty_like(o) for o in lz_scatter.global_offsets_plain(nt2, ps2))
        alone = ms(lambda: lib3.lz_global_offsets_launch(
            nt2.data_ptr(), ps2.data_ptr(), rows2, nc2, *(o.data_ptr() for o in pre2), stream), 50)
        wrapped = ms(lambda: lz_scatter.global_offsets_cuda(nt2, ps2), 50)
        if not all(torch.equal(a, b) for a, b in
                   zip(pre2, lz_scatter.global_offsets_plain(nt2, ps2))):
            fail(f"Kernel II alone (the C entry point) differs from its plain version at {label}")
        nbytes = 16 * rows2 * nc2 + 8 * rows2
        src2 = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        dst2 = torch.empty_like(src2)
        both = torch.stack([nt2, ps2])
        print(f"[time] {card} | lz_global_offsets at {label}: alone (C entry, preallocated "
              f"outputs) {alone:.4f} ms, through the wrapper {wrapped:.4f} ms; "
              f"x.add_(1) {launch_floor:.4f} ms; D2D copy moving as many bytes ({src2.numel()} "
              f"read, as many written) {ms(lambda: dst2.copy_(src2), 50):.4f} ms; torch.cumsum "
              f"of the (2, rows x nc) sizes {ms(lambda: torch.cumsum(both, 2), 50):.4f} ms; "
              f"bound {nbytes / HBM_BW * 1e3:.5f} ms ({nbytes} bytes)")
    hbuf, hstart, hlen = stage_in["hist"]
    hout = torch.zeros(256, dtype=torch.int32, device=dev)
    one_value = torch.full((hlen,), 0x7F, dtype=torch.uint8, device=dev)
    for label, (b8, start, length) in (
            ("payload section", (hbuf, hstart, hlen)), ("flag section", stage_in["hist_flags"]),
            ("one value (0x7F), payload-sized", (one_value, 0, hlen))):
        def launch():
            return libh.lz_byte_histogram_launch(b8.data_ptr(), start, length, hout.data_ptr(),
                                                 stream)

        def wrapper():
            return lz_entropy.byte_histogram_cuda(b8, start, length)

        print(f"[time] {card} | byte_histogram on the {label} ({length} bytes): alone hot "
              f"{ms(launch, 10):.4f} ms, cold {ms_cold(launch, 10):.4f} ms; through the wrapper "
              f"hot {ms(wrapper, 10):.4f} ms, cold {ms_cold(wrapper, 10):.4f} ms; torch.bincount "
              f"hot {ms(lambda: torch.bincount(b8[start:start + length], minlength=256), 10):.4f}"
              f" ms; bound {kernel_bytes_ops('byte_histogram', length=length)[0] / HBM_BW * 1e3:.4f}"
              f" ms")
    sel = t["lz_kernel1"] - t["lz_match"]
    print(f"[time] {card} | compressor split, hurr-quant 128 MiB: walk (lz_match) "
          f"{t['lz_match']:.4f} ms, selection + scan (lz_kernel1 - lz_match) {sel:.4f} ms "
          f"({sel / t['lz_kernel1']:.1%} of lz_kernel1), one-launch phases B + C less Kernel "
          f"I's 13 output bytes a position (lz_fused_mono - lz_kernel1) "
          f"{t['lz_fused_mono'] - t['lz_kernel1']:.4f} ms")
    # The walk's cost depends on the data: a word's walk stops at the first
    # offset where no lane's cap exceeds its best length.  All-equal
    # symbols stop at once; two-symbol noise visits every offset.
    for label, x in (
        ("all-equal symbols", torch.zeros_like(sym)),
        ("two-symbol noise", torch.randint(0, 2, sym.shape, device=dev,
                                           generator=torch.Generator(dev).manual_seed(0),
                                           dtype=torch.int32)),
    ):
        walkers = (("lz_match", lambda: lz_match.lz_match_cuda(x, window=w, symbol_size=s)),
                   ("lz_kernel1", lambda: lz_match.lz_kernel1_cuda(x, **kw)),
                   ("lz_fused_mono", lambda: lz_fused.lz_fused_mono_cuda(x[None], **kwm)))
        cells = ", ".join(f"{name} {ms(fn, 3):.4f} ms" for name, fn in walkers)
        print(f"[time] {card} | on {label}: {cells} ({kernel1_compares(x, w, c)} compares "
              f"of the per-thread walk), at nc={nc} C={c} S={s} W={w}")
    # The decode chain's cost depends on the data too: all-literal chunks
    # hold C tokens and copy nothing; in the long chain every position copies
    # the one before it (the most doubling rounds).
    for label, edge in (("all-literal chunks", "literals"), ("long-chain chunks", "chain")):
        x, b2, n2, p2 = (torch.from_numpy(a).to(dev) for a in
                         decode_edges.lz_edge_container(edge, nc, c, s, device=dev))
        f2, y2, _ = sections(b2, n2, p2, s, c)
        a2 = (b2[None], n2[None], p2[None])
        if diff(lz_decode.lz_decode_cuda(f2, y2, n2, symbol_size=s), x) or diff(
                lz_decode_mono.lz_decode_mono_cuda(*a2, **kwd)[0], x):
            fail(f"a decoder does not decode the {label}")
        cells = (f"lz_decode {ms(lambda: lz_decode.lz_decode_cuda(f2, y2, n2, symbol_size=s), 10):.4f}"
                 f" ms, lz_decode_mono {ms(lambda: lz_decode_mono.lz_decode_mono_cuda(*a2, **kwd), 10):.4f} ms")
        print(f"[time] {card} | on {label}: {cells} ({int(n2.sum())} tokens), at nc={nc} C={c} S={s}")
    for label, key in (("the container's flag section", "gap_flags"),
                       ("a stored escape of the payload's size", "gap_escape")):
        gargs, gbits, glen = stage_in[key]
        gms = ms(lambda: lz_entropy.huffman_gap_decode_cuda(*gargs, sub=SUB), 10)
        print(f"[time] {card} | huffman_gap_decode on {label}: {gms:.4f} ms ({gargs[1].numel()} "
              f"sub-blocks, {gbits} bits, longest code {glen} bits)")
    # the examples last, after every timed phase: their processes load
    # the host and the card while they run
    t0 = time.perf_counter()
    run_examples(card)
    print(f"[phases] {card} | seconds of the four examples: {time.perf_counter() - t0:.1f}")
    print(f"[kernels] {launches} max |kernel - plain| {err}")
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def path_launches(label, want, fn):
    """Run ``fn`` with the launch counts set to 0 before it and read after
    it; fail unless every kernel of ``want`` was launched.  Returns what
    ``fn`` returned."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn()
    made = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"[{label}] launches: {made}")
    missing = [k for k in want if not made.get(k)]
    if missing:
        fail(f"{label}: {missing} not launched on its path: {made}")
    return out


def autotune_phase(inputs, card, err) -> None:
    """The chunk-geometry tuner on the card: the joint sweeps over C for
    both directions at S = 2 and 4 (each candidate's time printed), the
    cache written, validated and re-read with zero sweeps; the one-launch
    pair against its plain versions at every C of the ladder, S in {1, 2,
    4}, on the sweep's own inputs first; then hurr-quant 128 MiB at the
    chosen C, the container equal to the plain path's."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import core
    from repro_torch.core import autotune, pipeline as pl
    from repro_torch.kernels import lz_decode_mono, lz_fused

    # the pair at the sweep's shapes (32 MiB: nc = 65,536 at C = 512, S = 1)
    kind = autotune.device_kind()
    for s in (1, 2, 4):
        dtype = autotune.default_dtype(s)
        enc = autotune.sweep_inputs(autotune.TuneKey(kind, dtype, s, 128, "compress", None))
        lit = autotune.sweep_inputs(autotune.TuneKey(kind, dtype, s, 0, "decompress", None))
        for c in autotune.CHUNK_SYMBOL_CANDIDATES:
            (sym,), kw = enc(c)
            mono = lz_fused.lz_fused_mono_cuda(sym, **kw)
            err["lz_fused_mono"] = max(err["lz_fused_mono"], *(
                max_diff(a, b) for a, b in zip(mono, lz_fused.lz_fused_mono_plain(sym, **kw))))
            live = kw["sec_flags"] + int(mono[3].sum())
            cases = [(mono[0][:, :live].contiguous(), mono[1], mono[2], sym)]
            cases.append((*lit(c)[0], None))  # the sweep's all-literal container
            for b, t, p, want in cases:
                d = lz_decode_mono.lz_decode_mono_cuda(b, t, p, symbol_size=s, chunk_symbols=c)
                err["lz_decode_mono"] = max(err["lz_decode_mono"], max_diff(
                    d, lz_decode_mono.lz_decode_mono_plain(b, t, p, symbol_size=s, chunk_symbols=c)))
                if want is not None and not torch.equal(d, want):
                    fail(f"the one-launch decoder does not invert the compressor at S={s} C={c}")
            print(f"[autotune] one-launch pair at S={s} C={c} nc={sym.shape[1]} (the sweep's "
                  f"inputs): max |kernel - plain| {err['lz_fused_mono']} / {err['lz_decode_mono']}")
            del mono, cases
        del enc, lit
    if err["lz_fused_mono"] or err["lz_decode_mono"]:
        fail(f"the one-launch pair disagrees with its plain versions: {err}")

    tmp = tempfile.mkdtemp(prefix="gpulz-autotune-")
    saved = {k: os.environ.get(k) for k in (autotune.ENABLE_ENV, autotune.CACHE_ENV)}
    os.environ[autotune.ENABLE_ENV] = "1"
    os.environ[autotune.CACHE_ENV] = os.path.join(tmp, "autotune.json")
    timings = {}
    real = autotune._default_measure

    def recording(key, nbytes=None):
        m = real(key, nbytes)

        def measure(c, g):
            timings[(key.direction, key.symbol_size, c)] = t = m(c, g)
            return t

        return measure

    autotune._default_measure = recording
    try:
        autotune.reset()

        def sweeps():
            chosen = {}
            for s in (2, 4):
                cfg = pl.tuned_config(s, 128)
                chosen[("compress", s)] = (cfg.chunk_symbols, cfg.chunks_per_block)
                chosen[("decompress", s)] = autotune.best_geometry(autotune.TuneKey(
                    kind, autotune.default_dtype(s), s, 0, "decompress", None))
            return chosen

        chosen = path_launches("autotune", ("lz_fused_mono", "lz_decode_mono"), sweeps)
        for (direction, s), (c, g) in chosen.items():
            cells = ", ".join(f"C={cc} {timings[(direction, s, cc)] * 1e3:.4f} ms"
                              for cc in autotune.CHUNK_SYMBOL_CANDIDATES)
            print(f"[autotune] {card} | {direction} S={s}, {autotune.SWEEP_BYTES} bytes a "
                  f"candidate, best of 2 after 1 warm-up, CUDA events around each call: "
                  f"{cells}; chosen C={c} (g={g})")
        want_sweeps = {k: 1 for k in autotune._SWEEPS}
        if len(want_sweeps) != 4:
            fail(f"autotune: expected 4 sweeps, made {autotune._SWEEPS}")
        path = autotune.cache_path()
        with open(path) as f:
            autotune.validate_cache(json.load(f))
        n_timed = len(timings)
        if sweeps() != chosen or autotune._SWEEPS != want_sweeps or len(timings) != n_timed:
            fail("autotune: the memoised second call swept again or chose otherwise")
        autotune.reset()
        if sweeps() != chosen or autotune._SWEEPS or len(timings) != n_timed:
            fail("autotune: after reset() the cache was not read back without a sweep")
        print(f"[autotune] cache {path} valid ({len(json.load(open(path))['entries'])} entries); "
              f"the memo and, after reset(), the file answered with zero sweeps")

        c = chosen[("compress", 2)][0]
        data = inputs["hurr-quant"]
        cfg = pl.tuned_config(2, 128)
        res = path_launches("autotune", ("lz_fused_mono",), lambda: core.compress(
            data, core.LZSSConfig(chunk_symbols=c, chunks_per_block=cfg.chunks_per_block,
                                  backend="fused-mono")))
        plain = core.compress(data, core.LZSSConfig(chunk_symbols=c, backend="torch"))
        if not np.array_equal(res.data, plain.data):
            fail(f"autotune: the container at the tuned C={c} differs from the plain path's")
        if not np.array_equal(core.decompress(res.data), data):
            fail(f"autotune: the container at the tuned C={c} does not decode exactly")
        print(f"[autotune] hurr-quant 128 MiB at the tuned C={c}: ratio {res.ratio!r}, "
              f"equal to the plain path, exact round trip")
    finally:
        autotune._default_measure = real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.reset()
        shutil.rmtree(tmp, ignore_errors=True)


def params_phase(inputs, card, err) -> None:
    """ParamSelector over the six datasets, 2 MiB each in two fields, on the
    card and on the CPU: the same configs field by field, equal ratios."""
    from repro_torch import core
    from repro_torch.data import datasets

    def feed(device):
        out = {}
        for name, (_, dtype) in datasets.DATASETS.items():
            data = datasets.load(name, 2 * MIB)
            sel = core.ParamSelector(dtype=dtype)
            picks = [sel.observe(data[i * MIB : (i + 1) * MIB], device=device) for i in range(2)]
            out[name] = (picks, sel.current_config(), sel._ratios)
        return out

    on_card = path_launches("params", ("lz_fused_mono",), lambda: feed("cuda"))
    on_cpu = feed("cpu")
    for name, (picks, nxt, ratios) in on_card.items():
        if (picks, nxt, ratios) != on_cpu[name]:
            fail(f"params: {name} picks {picks} / {ratios} on the card, {on_cpu[name]} on the CPU")
        print(f"[params] {name}: fields at (S, W) {[(p.symbol_size, p.window) for p in picks]}, "
              f"ratios {ratios}, next (S={nxt.symbol_size}, W={nxt.window}); equal on the CPU")


def sharded_phase(inputs, card, err) -> None:
    """The batch layer on one card: B = 3 buffers of 8 MiB through
    "sharded" with mesh=(cuda:0,) and (cuda:0, cuda:0) (B padded to 4), and
    deflate-full with the two-shard mesh, each equal to the unsharded
    compress_many byte for byte and decoded exactly."""
    import numpy as np
    import torch

    from repro_torch import core

    hq = inputs["hurr-quant"]
    items = [hq[i * 8 * MIB : (i + 1) * 8 * MIB] for i in range(3)]
    items[2] = items[2][: 8 * MIB - 12345]
    cuda0 = torch.device("cuda", 0)

    def run():
        for base in (core.LZSSConfig(), core.LZSSConfig(backend="deflate-full")):
            plain = core.compress_many(items, base)
            meshes = ((cuda0,), (cuda0, cuda0)) if base.backend == "auto" else ((cuda0, cuda0),)
            for mesh in meshes:
                cfg = core.LZSSConfig(backend="sharded", mesh=mesh) if base.backend == "auto" \
                    else core.LZSSConfig(backend="deflate-full", mesh=mesh)
                got = core.compress_many(items, cfg)
                if not (np.array_equal(got.data, plain.data)
                        and list(got.total_bytes) == list(plain.total_bytes)):
                    fail(f"sharded: {base.backend} with mesh {mesh} differs from unsharded")
                outs = core.decompress_many(got, mesh=mesh)
                if not all(np.array_equal(o, x) for o, x in zip(outs, items)):
                    fail(f"sharded: {base.backend} with mesh {mesh} does not decode exactly")
                print(f"[sharded] {cfg.backend} B=3 x 8 MiB, mesh of {len(mesh)} x cuda:0: "
                      f"equal to the unsharded compress_many (ratio {got.ratio!r}), exact")

    path_launches("sharded", ("lz_fused_mono", "lz_decode_mono", "byte_histogram",
                              "huffman_gap_decode"), run)


def twins_phase(inputs, card, err) -> None:
    """The Fig. 8-10 twins on the card: fig8 at 128 KiB / 64 KiB (the
    recorded ratios, exact), fig9 and fig10 at the reference's defaults
    (1 MiB, 64 KiB sweeps) and at 128 MiB of hurr-quant; JSONs to
    chiprun_out/."""
    from repro_torch.benchmarks import fig8_ratio, fig9_throughput, fig10_decode

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)

    def run():
        rec = fig8_ratio.run(nbytes=131072, sweep_nbytes=65536,
                             out_json=str(out / "BENCH_torch_ratio.json"))
        for key, entry in rec["backends"].items():
            want = 3.5259052025609297 if key == "deflate-full" else 2.431491856194116
            if entry["ratio"] != want:
                fail(f"twins: fig8 {key} ratio {entry['ratio']!r} != {want!r}")
        print(f"[twins] fig8: {len(rec['backends'])} backends, every method-0 ratio "
              f"2.431491856194116, deflate-full 3.5259052025609297")
        recs = {}
        for label, nbytes in (("1 MiB", MIB), ("128 MiB", 128 * MIB)):
            tag = "" if nbytes == MIB else "_128mib"
            sweep = 1 << 16 if nbytes == MIB else nbytes
            recs["fig9", label] = fig9_throughput.run(
                nbytes=nbytes, sweep_nbytes=sweep,
                out_json=str(out / f"BENCH_torch_pipeline{tag}.json"))
            recs["fig10", label] = fig10_decode.run(
                nbytes=nbytes, sweep_nbytes=sweep,
                out_json=str(out / f"BENCH_torch_decode{tag}.json"))
        for (fig, label), rec in recs.items():
            entries = rec["backends" if fig == "fig9" else "decoders"]
            cells = ", ".join(f"{k} {v['gb_per_s']:.4f} GB/s ({v['nbytes']} bytes)"
                              for k, v in entries.items())
            print(f"[twins] {card} | {fig} at {label}: {cells}; host API, host clock")

    path_launches("twins", RAW_KERNELS + ("byte_histogram", "huffman_gap_decode"), run)


def data_phase(inputs, card, err) -> None:
    """The data pipeline's Prefetcher on the card over 4 steps: int32
    tensors on cuda equal to make_batch_for_step."""
    import numpy as np
    import torch

    from repro_torch.data import pipeline as data_pipeline

    cfg = data_pipeline.DataConfig(vocab_size=32000, seq_len=2048, global_batch=8, seed=0)
    pre = data_pipeline.Prefetcher(cfg, start_step=10, device="cuda")
    for step in range(10, 14):
        got = pre.next()["tokens"]
        if got.device.type != "cuda" or got.dtype != torch.int32 or not np.array_equal(
                got.cpu().numpy(), data_pipeline.make_batch_for_step(cfg, step)["tokens"]):
            fail(f"data: the batch of step {step} is not make_batch_for_step's on the card")
    print(f"[data] Prefetcher(device='cuda'): 4 steps of {tuple(got.shape)} int32 on the card, "
          f"equal to make_batch_for_step")


def bench_phase(inputs, card, err) -> None:
    """The last slice's modules on the card.  (1) The dry run
    (launch/dryrun.py): llama3.2-1b x {train_4k, prefill_32k, decode_32k}
    on the 16x16 and 2x16x16 meshes, traced on meta, each record holding
    the reference's keys; then llama3.2-1b whole prefill (4, 2048) traced
    on meta and run on card tensors under roofline.CountingMode: the FLOPs
    and bytes equal exactly, and the Roofline terms of that count (one
    chip) stand beside the prefill's CUDA-event time.  (2) The paper's
    tables at real sizes through their twins: table1 at 64 MiB a dataset,
    table2 on nyx-quant at 128 MiB, table3 on 64 MiB fields, fig_lossy on
    hurr-field at 64 MiB with a deflate-full inner stage; the one-launch
    compressor once a compress call and the one-launch decoder once a
    decompress call of the raw tables, and the histogram, the gap decoder
    and the bitshuffle pair on the lossy path.  (3) kv_paging and
    sharded_batch at the reference's defaults (paged tokens bit-identical to
    dense at every budget; sharded containers equal to the unsharded
    dispatch, over 8 x cuda:0).  The four examples run at the end of the
    script (run_examples).  Records go to chiprun_out/."""
    import json

    import torch

    from repro_torch import configs
    from repro_torch.benchmarks import (
        fig_lossy, kv_paging, sharded_batch, table1_ratio, table2_throughput, table3_usecase)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline, steps as steps_lib
    from repro_torch.models import model

    out = ROOT / "chiprun_out"
    rec_dir = out / "torch_dryrun"
    rec_dir.mkdir(parents=True, exist_ok=True)
    seconds = {}

    # (1) the dry run
    t0 = time.perf_counter()
    keys = {"arch", "shape", "mesh", "chips", "compressed_grads", "compile_s", "memory",
            "flops_per_device", "bytes_per_device", "collectives", "roofline", "hlo_bytes",
            "direct_scanned_cost", "per_device"}
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        for multi_pod in (False, True):
            rec, _ = dryrun.lower_cell("llama3.2-1b", shape_name, multi_pod, device="cuda")
            if set(rec) != keys or set(rec["memory"]) != {"argument_size_in_bytes",
                                                          "output_size_in_bytes"}:
                fail(f"bench: dry-run record keys {sorted(rec)} / {sorted(rec['memory'])}")
            with open(rec_dir / f"llama3.2-1b__{shape_name}__{rec['mesh']}.json", "w") as f:
                json.dump(rec, f, indent=1)
            r = rec["roofline"]
            print(f"[bench] dryrun llama3.2-1b {shape_name} {rec['mesh']}: trace "
                  f"{rec['compile_s']} s, {rec['flops_per_device']!r} flops and "
                  f"{rec['bytes_per_device']!r} bytes a device, collectives "
                  f"{rec['collectives']['total']} bytes ({rec['collectives']['count']}), "
                  f"compute {r['compute_s']:.4e} s, memory {r['memory_s']:.4e} s, collective "
                  f"{r['collective_s']:.4e} s, {r['dominant']}, roofline fraction "
                  f"{r['roofline_fraction']:.4f} (reckoned from the H100 data sheet)")
    cfg = configs.get_config("llama3.2-1b")
    shape = ShapeConfig("prefill_4x2048", 2048, 4, "prefill")
    t1 = time.perf_counter()
    _, meta = roofline.count(steps_lib.prefill_step, model.abstract_params(cfg),
                             model.input_specs(cfg, shape), cfg=cfg)
    meta_s = time.perf_counter() - t1
    params = model.init_params(cfg, 0, device="cuda")
    batch = model.make_batch(cfg, shape, seed=1, device="cuda")
    logits, real = roofline.count(steps_lib.prefill_step, params, batch, cfg=cfg)
    if real != meta:
        fail(f"bench: the card's prefill counts {real} differ from the meta trace's {meta}")
    if logits.shape != (4, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        fail("bench: the counted prefill gives wrong or non-finite logits")
    steps_lib.prefill_step(params, batch, cfg=cfg)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(3):
        steps_lib.prefill_step(params, batch, cfg=cfg)
    b.record()
    torch.cuda.synchronize()
    measured = a.elapsed_time(b) / 3 / 1e3
    rl = roofline.Roofline("llama3.2-1b", shape.name, "1", 1, real["flops"], real["bytes"], 0.0,
                           roofline.model_flops_for(cfg, shape), {})
    print(f"[bench] {card} | llama3.2-1b prefill (4, 2048): meta trace {meta_s:.2f} s, "
          f"{meta['flops']} flops and {meta['bytes']} bytes, equal on the card; measured "
          f"{measured * 1e3:.3f} ms (CUDA events, mean of 3); Roofline compute_s "
          f"{rl.compute_s * 1e3:.3f} ms ({rl.compute_s / measured:.4f} of measured), memory_s "
          f"{rl.memory_s * 1e3:.3f} ms ({rl.memory_s / measured:.4f} of measured)")
    del params, batch, logits
    torch.cuda.empty_cache()
    seconds["dryrun"] = time.perf_counter() - t0

    # (2) the paper's tables.  The host calls each twin makes, from its rows:
    # a timed row is time_fn's warm-up and timed calls plus one more
    # compress (table1 1 + 1, tables 2 and 3 1 + 2); table2's decompress row
    # one compress and 1 + 2 decompresses; table3 one timed compress a field
    # (three rows) and one for the checkpoint moments' row.
    def host_calls(label, rows):
        if label == "table1":
            return 3 * len(rows), 0
        if label == "table2":
            return 3 * (len(rows) - 1) + 1, 3
        return 4 * ((len(rows) - 1) // 3 + 1), 0

    def raw_table(label, fn):
        rows = path_launches(f"bench {label}", ("lz_fused_mono",), fn)
        made = ops.launch_counts()
        calls = host_calls(label, rows)
        if (made["lz_fused_mono"], made["lz_decode_mono"]) != calls:
            fail(f"bench {label}: {made} for {calls} host calls, not one launch a call")
        return rows, calls

    tables = {}
    for label, fn in (
            ("table1", lambda: table1_ratio.run(nbytes=64 * MIB)),
            ("table2", lambda: table2_throughput.run(nbytes=128 * MIB)),
            ("table3", lambda: table3_usecase.run(nbytes=64 * MIB))):
        t0 = time.perf_counter()
        tables[label], calls = raw_table(label, fn)
        print(f"[bench] {card} | {label}: {len(tables[label])} rows, {calls[0]} "
              f"compress and {calls[1]} decompress calls, one launch each")
        seconds[label] = time.perf_counter() - t0
    with open(out / "BENCH_torch_tables.json", "w") as f:
        json.dump({"card": card, "note": "host API, host clock: (seconds, ratio or GB/s)",
                   "tables": tables}, f, indent=1)
    t0 = time.perf_counter()
    lossy = path_launches("bench fig_lossy", (
        "lz_fused_mono", "lz_decode", "byte_histogram", "huffman_gap_decode", "bitshuffle",
        "bitunshuffle"), lambda: fig_lossy.run(
            nbytes=64 * MIB, sweep_nbytes=64 * MIB, inner="deflate-full",
            out_json=str(out / "BENCH_torch_lossy.json")))
    for key, e in lossy["ebs"].items():
        print(f"[bench] {card} | fig_lossy hurr-field 64 MiB eb {key}: ratio {e['ratio']!r}, "
              f"max err {e['max_abs_err']!r}, compress {e['compress_gb_per_s']:.4f} GB/s, "
              f"decode {e['decode_gb_per_s']:.4f} GB/s (host API, host clock)")
    seconds["fig_lossy"] = time.perf_counter() - t0

    # (3) kv_paging and sharded_batch at the reference's defaults
    t0 = time.perf_counter()
    kv = path_launches("bench kv_paging", ("lz_fused_mono", "lz_decode_mono"),
                       lambda: kv_paging.paging_sweep(out_json=str(out / "BENCH_torch_kv.json")))
    for e in kv["budgets"]:
        if not e["exact"]:
            fail(f"bench: kv_paging at budget {e['budget_blocks']} is not exact")
    print(f"[bench] {card} | kv_paging (reduced llama3.2-1b): dense "
          f"{kv['dense']['tokens_per_s']:.1f} tok/s; " + "; ".join(
              f"budget {e['budget_blocks']}: {e['tokens_per_s']:.1f} tok/s, {e['evictions']} "
              f"evictions, {e['restores']} restores, exact" for e in kv["budgets"]))
    sh = path_launches("bench sharded_batch", ("lz_fused_mono", "lz_decode_mono"),
                       lambda: sharded_batch.main(["--out-json",
                                                   str(out / "BENCH_torch_sharded.json")]))
    print(f"[bench] {card} | sharded_batch: {sh['buffers']} buffers over {sh['n_devices']} x "
          f"cuda:0, byte-identical; " + "; ".join(
              f"{k} compress {v['compress_seconds_per_call'] * 1e3:.3f} ms, decompress "
              f"{v['decompress_seconds_per_call'] * 1e3:.3f} ms" for k, v in sh["results"].items()))
    seconds["kv+sharded"] = time.perf_counter() - t0
    print("[bench] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))


def run_examples(card) -> None:
    """The four examples as subprocesses on the card, in a temporary
    directory that is also their TMPDIR: one train_tiny_lm in the
    background while the other three run one after another; each must
    exit 0 (their own asserts)."""
    import shutil
    import subprocess
    import tempfile

    # two at a time: half the host's cores each, so that their CPU threads
    # do not oversubscribe it
    threads = str(max(1, (os.cpu_count() or 2) // 2))
    tmp = tempfile.mkdtemp()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS=threads, TMPDIR=tmp)
    t0 = time.perf_counter()

    def start(name, *args):
        return subprocess.Popen([sys.executable, "-m", f"repro_torch.examples.{name}", *args],
                                env=env, cwd=tmp, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = {}
    try:
        procs["train_tiny_lm"] = start("train_tiny_lm", "--ckpt-dir", os.path.join(tmp, "ckpt"))
        for name in ("quickstart", "compress_checkpoint", "serve_batched", "train_tiny_lm"):
            if name not in procs:
                procs[name] = start(name)
            proc = procs[name]
            try:
                stdout, stderr = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                fail(f"bench: example {name} ran past 600 s")
            if proc.returncode != 0:
                fail(f"bench: example {name} exited {proc.returncode}:\n{stdout[-2000:]}"
                     f"\n{stderr[-3000:]}")
            tail = "\n".join(stdout.strip().splitlines()[-4:])
            print(f"[bench] {card} | example {name}: exit 0 ({time.perf_counter() - t0:.1f} s "
                  f"after the first started); last lines:\n{tail}")
    finally:  # a failure leaves no example running
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def models_phase(inputs, card, err) -> None:
    """The model zoo on the card.  (1) llama3.2-1b whole (16 layers, d 2048,
    bf16, weights from init_params(cfg, 0)): prefill (4, 2048); dense decode
    of 4 sequences in a 544-slot cache, a 512-token prompt then 32 greedy
    tokens; the same through decode_step_paged (block_tokens=16, map_all),
    every logit and token bit-identical to dense; decode's logits at 511
    against the prefill of the prompt; CUDA-event times and peak memory.
    (2) All ten architectures at their published widths, cut to 2 layers
    (hymba keeps one global layer and its 1024 window): in f32 with TF32 off
    forward over (2, 64) tokens against 64 decode steps within 1e-3 x
    max(1, max|logits|) (MoE at no-drop capacity) and a finite loss_fn; in
    bf16 a finite prefill of (2, 1024).  (3) The ten reduced configs in f32,
    the same weights on the card and the CPU: logits within 1e-4 of max
    |logit|.  (4) Layer 0's K cache of (1) through core.compress and back:
    exact, one launch a call."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs, core
    from repro_torch.kernels import ops
    from repro_torch.models import common, convert, model, transformer as tf

    dev = torch.device("cuda")

    def event_ms(fn, reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    # (1) llama3.2-1b whole
    cfg = configs.get_config("llama3.2-1b")
    torch.cuda.reset_peak_memory_stats()
    m = model.init_params(cfg, 0, device=dev)
    n_params = sum(p.numel() for p in m.parameters())
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g, device=dev, dtype=torch.int32)
    last = tf.prefill(m, cfg, tokens=toks)  # also the warm-up of the timing below
    if last.shape != (4, cfg.padded_vocab) or not bool(torch.isfinite(last).all()):
        fail(f"models: llama3.2-1b prefill gives {tuple(last.shape)} or non-finite logits")
    prefill_ms = event_ms(lambda: tf.prefill(m, cfg, tokens=toks), 3)

    prompt, steps, slots = toks[:, :512], 32, 544
    caches = tf.init_cache(cfg, 4, slots, device=dev)
    paged = tf.init_paged_cache(cfg, 4, slots, block_tokens=16, device=dev)
    td = tp = prompt[:, 0]
    out = []
    for pos in range(slots):
        ld, caches = tf.decode_step(m, cfg, caches, td, pos)
        lp, paged = tf.decode_step_paged(m, cfg, paged, tp, pos)
        if pos == 511:
            at_511 = ld
        if pos + 1 < 512:
            td = tp = prompt[:, pos + 1]
        else:
            td, tp = ld.argmax(-1).to(torch.int32), lp.argmax(-1).to(torch.int32)
            out.append(td)
        if not (torch.equal(ld, lp) and torch.equal(td, tp)):
            fail(f"models: paged decode differs from dense at position {pos}")
    generated = torch.stack(out[:steps], 1)
    pre_prompt = tf.prefill(m, cfg, tokens=prompt)
    gap = float((pre_prompt - at_511).abs().max())
    if not bool(torch.isfinite(at_511).all()):
        fail("models: decode's logits at position 511 are not finite")

    def timed_steps(step, state):
        pos = iter(range(512, slots))
        tok = generated[:, 0]
        step(m, cfg, state, tok, next(pos))  # warm-up
        return event_ms(lambda: step(m, cfg, state, tok, next(pos)), 16)

    dense_ms = timed_steps(tf.decode_step, caches)
    paged_ms = timed_steps(tf.decode_step_paged, paged)
    peak = torch.cuda.max_memory_allocated()

    def device_split(label, fn, reps, event_ms_each):
        """Kernel time a call from torch.profiler, against the call's
        CUDA-event time: the device's busy share, and the top kernels."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # the kernels' own rows (an operator's row repeats its kernels' time)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total]
        if not rows:
            print(f"[models] {card} | {label}: device time not measured (no device events)")
            return
        busy = sum(e.self_device_time_total for e in rows) / 1e3 / reps
        top = sorted(rows, key=lambda e: -e.self_device_time_total)[:5]
        print(f"[models] {card} | {label}: kernels {busy:.3f} ms a call of {event_ms_each:.3f} "
              f"(busy {busy / event_ms_each:.1%}), {sum(e.count for e in rows) / reps:.0f} device "
              f"events a call (torch.profiler, {reps} calls); top: " + "; ".join(
                  f"{e.key[:48]} {e.self_device_time_total / 1e3 / reps:.3f} ms" for e in top))

    device_split("llama3.2-1b prefill (4, 2048)", lambda: tf.prefill(m, cfg, tokens=toks), 2,
                 prefill_ms)
    pos_iter = iter(range(512, slots))
    device_split("llama3.2-1b dense decode step", lambda: tf.decode_step(
        m, cfg, caches, generated[:, 0], next(pos_iter)), 8, dense_ms)
    print(f"[models] {card} | llama3.2-1b whole: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} heads, {cfg.num_kv_heads} KV heads padded to {cfg.padded_kv_heads}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params} parameters in bf16")
    print(f"[models] {card} | llama3.2-1b prefill (4, 2048): {prefill_ms:.3f} ms, "
          f"{4 * 2048 / prefill_ms * 1e3:.1f} tokens/s (CUDA events, mean of 3 after a warm-up)")
    print(f"[models] {card} | llama3.2-1b decode step, 4 sequences, {slots}-slot cache: dense "
          f"{dense_ms:.3f} ms ({4 / dense_ms * 1e3:.1f} tokens/s), paged (16-token blocks) "
          f"{paged_ms:.3f} ms ({4 / paged_ms * 1e3:.1f} tokens/s) (CUDA events, mean of 16 "
          f"after a warm-up); peak memory {peak} bytes")
    print(f"[models] llama3.2-1b: 512-token prompt + {steps} greedy tokens, paged decode "
          f"bit-identical to dense at all {slots} positions; max |prefill - decode| at "
          f"position 511: {gap!r}; first tokens {generated[0, :8].tolist()}")

    # (4) the K cache of layer 0 through the codec (before freeing (1))
    k0 = caches[0]["attn"]["k"]
    ops.reset_launch_counts()
    res = core.compress(k0, core.LZSSConfig(symbol_size=2))
    made_c = ops.launch_counts()
    back = core.decompress(res.data)
    made_d = {k: v - made_c[k] for k, v in ops.launch_counts().items()}
    if {k: v for k, v in made_c.items() if v} != {"lz_fused_mono": 1} or {
            k: v for k, v in made_d.items() if v} != {"lz_decode_mono": 1}:
        fail(f"models: K cache round trip launched {made_c} / {made_d}, want one each")
    if not np.array_equal(back, k0.contiguous().view(torch.uint8).reshape(-1).cpu().numpy()):
        fail("models: the K cache's codec round trip is not exact")
    print(f"[models] layer 0 K cache {tuple(k0.shape)} bf16 ({k0.numel() * 2} bytes) through "
          f"core.compress (S=2): ratio {res.ratio!r}, exact round trip, one launch each way")
    del m, caches, paged, k0, last, pre_prompt
    torch.cuda.empty_cache()

    # (2) the ten architectures at published width, 2 layers
    shape = configs.ShapeConfig("smoke", 64, 2, "train")
    for name in configs.ARCHS:
        base = configs.get_config(name)
        cut = dict(num_layers=2)
        if base.global_attn_layers:
            cut["global_attn_layers"] = (0,)
        cfg = dataclasses.replace(base, dtype="float32", **cut)
        if cfg.moe is not None:  # no-drop capacity: decode routes as the forward does
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        t0 = time.perf_counter()
        m = model.init_params(cfg, 0, device=dev)
        n_params = sum(p.numel() for p in m.parameters())
        g = torch.Generator(device=dev).manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=dev)
        with common.full_f32_matmul(), torch.no_grad():
            full = tf.unembed(m, cfg, tf.forward(m, cfg, tokens=toks, remat="none")[0])
            caches, outs = tf.init_cache(cfg, 2, 64, device=dev), []
            for pos in range(64):
                outs.append(tf.decode_step(m, cfg, caches, toks[:, pos], pos)[0])
            loss, parts = tf.loss_fn(m, cfg, model.make_batch(cfg, shape, 3, dev), remat="none")
        err = float((torch.stack(outs, 1) - full).abs().max())
        bound = 1e-3 * max(1.0, float(full.abs().max()))
        if not (err <= bound and bool(torch.isfinite(loss))):
            fail(f"models: {name} decode {err} from forward (bound {bound}) or loss {loss}")
        del m, caches, outs, full
        torch.cuda.empty_cache()
        m16 = model.init_params(dataclasses.replace(base, **cut), 0, device=dev)
        toks16 = torch.randint(0, base.vocab_size, (2, 1024), generator=g, device=dev)
        last = tf.prefill(m16, m16.cfg, tokens=toks16)
        if not bool(torch.isfinite(last).all()):
            fail(f"models: {name} bf16 prefill (2, 1024) is not finite")
        del m16, last
        torch.cuda.empty_cache()
        print(f"[models] {name} at published width, 2 layers ({n_params} parameters in f32): "
              f"decode against forward {err:.3g} (bound {bound:.3g}), loss {float(loss):.4f} "
              f"(aux {float(parts['aux']):.4g}), bf16 prefill (2, 1024) finite; "
              f"{time.perf_counter() - t0:.1f} s")

    # (3) the card against the CPU
    worst = {}
    for name in configs.ARCHS:
        cfg = dataclasses.replace(configs.reduced_config(configs.get_config(name)),
                                  dtype="float32")
        on_cpu = model.init_params(cfg, 0, device="cpu")
        on_card = convert.params_from_numpy(convert.params_to_numpy(on_cpu), cfg, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(4))
        with common.full_f32_matmul(), torch.no_grad():
            want = tf.unembed(on_cpu, cfg, tf.forward(on_cpu, cfg, tokens=toks, remat="none")[0])
            got = tf.unembed(on_card, cfg, tf.forward(on_card, cfg, tokens=toks.to(dev),
                                                      remat="none")[0])
        worst[name] = float((got.cpu() - want).abs().max()) / float(want.abs().max())
        if worst[name] > 1e-4:
            fail(f"models: {name} reduced, card against CPU {worst[name]} > 1e-4")
    print(f"[models] reduced configs in f32, card against CPU, max |diff| / max |logit|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


class StoreProbe:
    """Wraps one ``KVBlockStore``'s rounds: per round its blocks, the host
    clock around the store call (a synchronize first), CUDA events around
    the pipeline's dispatch and around the one-launch kernels' wrappers, and
    the launches it made.  Every ``sample``-th round is held against the
    plain path on the card: an eviction's blobs against the plain
    compressor's for the same blocks (and its blocks kept, to be checked
    again when they come back), a restore against the plain decoder's
    output on the same blobs."""

    def __init__(self, store, sample, plain_blob, plain_decode):
        import threading

        import numpy as np
        import torch

        from repro_torch.core import lzss
        from repro_torch.kernels import ops

        self.store, self.sample = store, sample
        self.plain_blob, self.plain_decode = plain_blob, plain_decode
        self.rounds = {"evict": [], "restore": []}
        self.kept = {}  # store key -> the evicted block's bytes (sampled rounds)
        self.checked = {"evict": 0, "restore": 0, "returned": 0}
        self.local = threading.local()
        real_evict, real_restore = store.evict_many, store.restore_many

        def timed(kind, fn, *a):
            self.local.events = {"dispatch": [], "kernel": []}
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            ms = (time.perf_counter() - t0) * 1e3
            made = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
            self.rounds[kind].append(dict(ms=ms, made=made, **self.local.events))
            return out

        def evict_many(items):
            items = list(items)
            timed("evict", real_evict, items)
            self.rounds["evict"][-1]["blocks"] = len(items)
            if (len(self.rounds["evict"]) - 1) % self.sample == 0:
                raws = [b.cpu().numpy() for _, b in items]
                plain = self.plain_blob(raws)
                for (key, _), raw, want in zip(items, raws, plain):
                    if not np.array_equal(store._store[key][2], want):
                        fail(f"serving: eviction round {len(self.rounds['evict'])}: the stored "
                             f"blob of {key} differs from the plain path's")
                    self.kept[key] = raw
                self.checked["evict"] += 1

        def restore_many(keys):
            keys = list(keys)
            n = len(self.rounds["restore"])
            blobs = [store._store[k][2] for k in keys] if n % self.sample == 0 else None
            out = timed("restore", real_restore, keys)
            self.rounds["restore"][-1]["blocks"] = len(keys)
            if blobs is not None:
                for key, got, want in zip(keys, out, self.plain_decode(blobs)):
                    if not np.array_equal(got.view(np.uint8).reshape(-1), want):
                        fail(f"serving: restore round {n + 1}: {key} differs from the plain "
                             f"decoder's")
                self.checked["restore"] += 1
            for key, got in zip(keys, out):
                raw = self.kept.pop(key, None)
                if raw is not None:
                    if not np.array_equal(got.view(np.uint8).reshape(-1), raw):
                        fail(f"serving: {key} came back other than it was evicted")
                    self.checked["returned"] += 1
            return out

        store.evict_many, store.restore_many = evict_many, restore_many
        self._patched = []
        for owner, attr, slot in ((lzss, "compress_many_chunks", "dispatch"),
                                  (lzss, "decompress_many_chunks", "dispatch"),
                                  (ops, "lz_fused_mono", "kernel"),
                                  (ops, "lz_decode_mono", "kernel")):
            self._wrap(owner, attr, slot)

    def _wrap(self, owner, attr, slot):
        import torch

        fn = getattr(owner, attr)
        local = self.local

        def evented(*a, **k):
            a0, a1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a0.record()
            out = fn(*a, **k)
            a1.record()
            events = getattr(local, "events", None)
            if events is not None:
                events[slot].append((a0, a1))
            return out

        setattr(owner, attr, evented)
        self._patched.append((owner, attr, fn))

    def close(self) -> dict:
        """Unwrap, and sum up: rounds, blocks a round, ms a round (host
        clock, dispatch and kernel events), launches a round."""
        import torch

        for owner, attr, fn in self._patched:
            setattr(owner, attr, fn)
        torch.cuda.synchronize()
        out = {}
        for kind, rounds in self.rounds.items():
            if not rounds:
                out[kind] = dict(rounds=0)
                continue
            n = len(rounds)
            ev = {slot: sum(a.elapsed_time(b) for r in rounds for a, b in r[slot]) / n
                  for slot in ("dispatch", "kernel")}
            launches = {}
            for r in rounds:
                for k, v in r["made"].items():
                    launches.setdefault(k, set()).add(v)
            out[kind] = dict(rounds=n, blocks=sum(r["blocks"] for r in rounds) / n,
                             host_ms=sum(r["ms"] for r in rounds) / n, dispatch_ms=ev["dispatch"],
                             kernel_ms=ev["kernel"],
                             launches={k: sorted(v) for k, v in launches.items()})
        return out


def serving_phase(inputs, card, err) -> None:
    """The serving engine on the card.  (1) llama3.2-1b whole (16 layers at
    published width, bf16, weights from init_params(cfg, 0)): 4 sequences, a
    128-token prompt, 32 greedy tokens, through ServingEngine dense, then
    paged with the compressed KV tier (kv_compress, 32-token blocks, 40
    blocks of budget: twice the per-layer peak, against a working set of
    320) on the card's default one-launch pair, with prefetch, then the same
    with async_prefetch: tokens bit-identical to dense, every eviction one
    launch of the one-launch compressor and every restore one of the
    one-launch decoder, sampled rounds' blobs equal to the plain path's and
    restored blocks to the plain decoder's; tokens/s, ms a step, rounds,
    blocks and ms a round, the eviction ratio, prefetch hits, peak memory.
    (2) kv_backend="deflate-full" (the histogram and the gap decoder on the
    tier), llama3.2-1b cut to 2 layers, 20 blocks of budget (the per-layer
    peak, against a working set of 40).  (3) hymba-1.5b at published width
    cut to 2 layers (layer 0 global, layer 1 in its 1024-token window):
    2 sequences, a 1088-token prompt and 32 tokens in 64-token blocks, so the
    window slides past a block: dead blocks retire, paged == dense."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs, core
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.serving import engine as serving, kvcache

    dev = torch.device("cuda")

    def run(cfg, m, prompts, new, **kw):
        """One generate() on a fresh engine: (result, engine, seconds, peak)."""
        eng = serving.ServingEngine(cfg, m, max_len=-(-(prompts.shape[1] + new) // 64) * 64,
                                    **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = eng.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        return res, eng, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    def raw_plain(cfg):
        plain_cfg = dataclasses.replace(cfg, backend="torch")
        return lambda raws: [core.compress(r, plain_cfg).data for r in raws]

    def raw_decode(blobs):
        return [core.decompress(b, decoder="torch-parallel") for b in blobs]

    def probed(cfg, m, prompts, new, plain_blob, plain_decode, sample, **kw):
        """A paged run with its store probed (the probe's synchronize
        before each round adds to its time)."""
        eng_kw = dict(kv_compress=True, kv_offload=True, **kw)
        holder = {}
        real_init = kvcache.KVBlockStore.__init__

        def init(self, *a, **k):
            real_init(self, *a, **k)
            holder["probe"] = StoreProbe(self, sample, plain_blob, plain_decode)

        kvcache.KVBlockStore.__init__ = init
        try:
            res, eng, secs, peak = run(cfg, m, prompts, new, **eng_kw)
        finally:
            kvcache.KVBlockStore.__init__ = real_init
        return res, eng, secs, peak, holder["probe"].close(), holder["probe"].checked

    def report(label, res, eng, secs, peak, b, new):
        steps = res.steps
        s = eng.paging_stats() if eng.kv_offload else {}
        st = eng.kv_store.stats
        print(f"[serving] {card} | {label}: {steps} steps in {secs:.3f} s, {secs / steps * 1e3:.3f} "
              f"ms a step, {b * steps / secs:.1f} tokens/s through the model, "
              f"{b * new / secs:.1f} generated tokens/s (host clock); peak memory {peak} bytes"
              + (f"; evictions {st.evictions} in {st.eviction_dispatches} rounds, restores "
                 f"{st.restores} in {st.restore_dispatches} rounds, eviction ratio "
                 f"{st.eviction_ratio!r} ({st.evicted_bytes_raw} -> {st.evicted_bytes_stored} "
                 f"bytes), prefetch issued {s['prefetch_issued']} hits {s['prefetch_hits']}, "
                 f"demand restores {s['demand_restores']}, async batches "
                 f"{s['async_prefetch_batches']}, high water {s['high_water']} of "
                 f"{s['budget_blocks']}, working set {s['working_set_blocks']} blocks"
                 if s else ""))

    def report_rounds(label, rounds, checked):
        for kind, r in rounds.items():
            if not r["rounds"]:
                continue
            events = (f"{r['dispatch_ms']:.4f} ms of it in CUDA events around the pipeline's "
                      f"dispatch, {r['kernel_ms']:.4f} ms around the one-launch kernel's wrapper "
                      f"({r['kernel_ms'] / r['host_ms']:.1%} of the round)" if r["dispatch_ms"]
                      else "container by container (no batched dispatch to time)")
            print(f"[serving] {card} | {label} {kind} rounds: {r['rounds']}, {r['blocks']:.2f} "
                  f"blocks a round, {r['host_ms']:.4f} ms a round on the host clock around the "
                  f"store call, {events}; launches a round {r['launches']}")
        print(f"[serving] {label}: held against the plain path on the card: {checked['evict']} "
              f"eviction rounds' blobs, {checked['restore']} restore rounds' blocks, "
              f"{checked['returned']} sampled blocks back as evicted")

    def one_a_round(label, rounds, want):
        for kind, kernel in (("evict", want[0]), ("restore", want[1])):
            bad = {k: v for k, v in rounds[kind].get("launches", {}).items()
                   if (k, v) != (kernel, [1])}
            if rounds[kind]["rounds"] == 0 or bad or kernel not in rounds[kind]["launches"]:
                fail(f"serving: {label} {kind} rounds launched {rounds[kind].get('launches')}, "
                     f"want one {kernel} a round")

    # (1) llama3.2-1b whole
    cfg = configs.get_config("llama3.2-1b")
    m = model.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    new, kv = 32, dict(block_tokens=32, budget_blocks=40)
    run(cfg, m, prompts[:, :4], 2)  # warm-up
    dense, eng, secs, peak = run(cfg, m, prompts, new)
    report("llama3.2-1b dense", dense, eng, secs, peak, 4, new)
    raw_cfg = kvcache.KV_LZ
    runs = {}
    for label, extra in (("paged, prefetch", {}), ("paged, async prefetch",
                                                   dict(async_prefetch=True))):
        ops.reset_launch_counts()
        res, eng, secs, peak, rounds, checked = probed(
            cfg, m, prompts, new, raw_plain(raw_cfg), raw_decode, 200, **kv, **extra)
        made = {k: v for k, v in ops.launch_counts().items() if v}
        if not np.array_equal(res.tokens, dense.tokens):
            fail(f"serving: llama3.2-1b {label}: tokens differ from dense")
        one_a_round(label, rounds, ("lz_fused_mono", "lz_decode_mono"))
        report(f"llama3.2-1b {label}", res, eng, secs, peak, 4, new)
        report_rounds(f"llama3.2-1b {label}", rounds, checked)
        print(f"[serving] llama3.2-1b {label}: launches {made}; tokens bit-identical to dense")
        runs[label] = secs
    # the same paged run without the probe: its time alone
    ops.reset_launch_counts()
    res, eng, secs, peak = run(cfg, m, prompts, new, kv_compress=True, kv_offload=True, **kv)
    if not np.array_equal(res.tokens, dense.tokens):
        fail("serving: llama3.2-1b paged (no probe): tokens differ from dense")
    report("llama3.2-1b paged, prefetch, no probe", res, eng, secs, peak, 4, new)
    print(f"[serving] llama3.2-1b first generated tokens {dense.tokens[0, 128:136].tolist()}")
    del m
    torch.cuda.empty_cache()

    # (2) deflate-full on the tier, llama3.2-1b cut to 2 layers
    cut = dataclasses.replace(cfg, num_layers=2)
    m = model.init_params(cut, 0, device=dev)
    dense, eng, secs, peak = run(cut, m, prompts, new)
    ent_cfg = dataclasses.replace(raw_cfg, backend="deflate-full")

    def ent_plain(raws):
        return [_plain_container(r, ent_cfg) for r in raws]

    def ent_decode(blobs):
        from repro_torch.core import entropy, format as fmt

        out = []
        for b in blobs:
            h = fmt.parse_header(b)
            sym = entropy.decode_blob_entropy(torch.from_numpy(np.array(b)).to(dev), h,
                                              impl="plain")
            out.append(core.unpack_symbols(sym.reshape(-1), h.symbol_size)[: h.orig_bytes]
                       .cpu().numpy())
        return out

    res, eng, secs, peak, rounds, checked = path_launches(
        "serving deflate-full", ("lz_fused_mono", "byte_histogram", "huffman_gap_decode",
                                 "lz_decode"),
        lambda: probed(cut, m, prompts, new, ent_plain, ent_decode, 50, kv_backend="deflate-full",
                       block_tokens=32, budget_blocks=20))
    if not np.array_equal(res.tokens, dense.tokens):
        fail("serving: llama3.2-1b (2 layers) deflate-full: tokens differ from dense")
    report("llama3.2-1b cut to 2 layers, paged, deflate-full", res, eng, secs, peak, 4, new)
    report_rounds("llama3.2-1b cut to 2 layers, deflate-full", rounds, checked)
    del m
    torch.cuda.empty_cache()

    # (3) hymba-1.5b at published width, 2 layers: the window slides
    base = configs.get_config("hymba-1.5b")
    hcfg = dataclasses.replace(base, num_layers=2, global_attn_layers=(0,))
    m = model.init_params(hcfg, 0, device=dev)
    hp = np.random.default_rng(6).integers(0, hcfg.vocab_size, (2, 1088)).astype(np.int32)
    dense, eng, secs, peak = run(hcfg, m, hp, 32)
    res, eng, secs, peak = path_launches(
        "serving hymba", ("lz_fused_mono",), lambda: run(
            hcfg, m, hp, 32, kv_compress=True, kv_offload=True, block_tokens=64, budget_blocks=64))
    retired = sum(eng._retired_upto.values())
    if not np.array_equal(res.tokens, dense.tokens) or not retired:
        fail(f"serving: hymba paged tokens differ from dense, or no block retired ({retired})")
    report("hymba-1.5b cut to 2 layers (window 1024), paged, prefetch", res, eng, secs, peak, 2, 32)
    print(f"[serving] hymba-1.5b: {retired} dead window blocks retired, tokens bit-identical "
          f"to dense")
    del m
    torch.cuda.empty_cache()


def grad_phase(inputs, card, err) -> None:
    """The optimizer with the compressed gradient exchange on the card.
    llama3.2-1b whole in bf16 (weights from init_params(cfg, 0)); loss_fn
    and backward on two pods' batches of (2, 512) tokens, the gradients
    stacked as (2, ...) leaves; pod_exchange_compressed over a mesh of two
    cuda:0 at ratio_cap 1.0 and 2.0 (lossless) and lossy at ratio_cap 2.0
    with eb = 2**-10 x max |g|; then one adamw_update.  Checks: at ratio_cap
    1.0 the exchange equals the per-pod quantize mean bit for bit; each
    leaf's compression is one launch of the one-launch compressor and its
    decode one of the one-launch decoder (lossy: a compressor launch and a
    bitshuffle a slab, one decoder launch and one unshuffle a leaf); lossy
    slabs sent as containers decode within eb; the wire of sampled leaves
    equals the plain path's on the card, and their decode the plain
    decoder's.  Recorded: wire bytes against the bf16 bytes, the share of
    slabs sent as containers, ms per leaf class and the exchange's total."""
    import contextlib
    import dataclasses
    import functools

    import torch

    from repro_torch import configs, optim
    from repro_torch.core import lossy
    from repro_torch.kernels import ops
    from repro_torch.models import model, transformer as tf
    from repro_torch.optim import grad_compress as gc

    dev = torch.device("cuda")
    cfg = configs.get_config("llama3.2-1b")
    m = model.init_params(cfg, 0, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 512), generator=g, device=dev,
                         dtype=torch.int32)
    names = [n for n, _ in m.named_parameters()]
    per_pod = []
    t0 = time.perf_counter()
    for k in range(2):
        m.zero_grad(set_to_none=True)
        loss, _ = tf.loss_fn(m, cfg, {"tokens": toks[k]}, remat="none")
        loss.backward()
        per_pod.append({n: p.grad for n, p in m.named_parameters()})
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    stack = {n: torch.stack([per_pod[0][n], per_pod[1][n]]) for n in names}
    del per_pod
    m.zero_grad(set_to_none=True)
    gmax = max(float(v.abs().max()) for v in stack.values())
    eb = gmax * 2.0**-10
    n_elems = sum(v[0].numel() for v in stack.values())
    print(f"[grad] {card} | llama3.2-1b loss_fn + backward on 2 pods' (2, 512) tokens: "
          f"{grad_s:.3f} s; {len(names)} leaves, {n_elems} elements a pod, max |g| {gmax!r}, "
          f"lossy eb {eb!r}")

    def leaf_class(name):
        if name == "embed":
            return "embedding"
        if ".attn." in name:
            return "attention"
        if ".mlp." in name:
            return "MLP"
        return f"norms (under {gc.MIN_COMPRESS_SIZE} elements)"

    wires = []
    real_compress, real_decompress = gc.compress_leaf, gc.decompress_leaf

    def recording(x, *a, **k):
        before = ops.launch_counts()
        w = real_compress(x, *a, **k)
        made = {n: v - before[n] for n, v in ops.launch_counts().items() if v != before[n]}
        wires.append(dict(w=w, made=made, x=x))
        return w

    decodes = []

    def recording_d(wire, *a, **k):
        before = ops.launch_counts()
        out = real_decompress(wire, *a, **k)
        decodes.append({n: v - before[n] for n, v in ops.launch_counts().items()
                        if v != before[n]})
        return out

    def exchange(label, **kw):
        """The exchange leaf by leaf (each a pod_exchange_compressed call
        of one leaf, timed on the host clock around a synchronize)."""
        wires.clear()
        decodes.clear()
        out, ms, info = {}, {}, {}
        gc.compress_leaf, gc.decompress_leaf = recording, recording_d
        try:
            for n in names:
                torch.cuda.synchronize()
                t = time.perf_counter()
                first = len(wires)
                out[n] = optim.pod_exchange_compressed({n: stack[n]}, (dev, dev), **kw)[n]
                torch.cuda.synchronize()
                c = leaf_class(n)
                ms[c] = ms.get(c, 0.0) + (time.perf_counter() - t) * 1e3
                info[n] = wires[first:]
        finally:
            gc.compress_leaf, gc.decompress_leaf = real_compress, real_decompress
        total = sum(ms.values())
        wire_bytes = sum(int(w["w"]["payload"].numel()) for ws in info.values() for w in ws)
        raw_bytes = sum(2 * stack[n].numel() for n, ws in info.items() if ws)
        slabs = [bool(u) for ws in info.values() for w in ws for u in w["w"]["used_lz"].tolist()]
        print(f"[grad] {card} | exchange {label}: {total:.3f} ms in all (host clock); "
              + ", ".join(f"{c} {v:.3f} ms" for c, v in ms.items())
              + f"; wire {wire_bytes} bytes against {raw_bytes} bf16 bytes of the compressed "
              f"leaves ({wire_bytes / raw_bytes:.4f}); {sum(slabs)} of {len(slabs)} slabs sent "
              f"as containers ({sum(slabs) / len(slabs):.1%})")
        return out, info

    def want_launches(label, info, lossy_run):
        for n, ws in info.items():
            for w in ws:
                k = w["w"]["used_lz"].numel()
                want = {"lz_fused_mono": k, "bitshuffle": k} if lossy_run else {"lz_fused_mono": 1}
                if w["made"] != want:
                    fail(f"grad: {label} {n}: compress_leaf launched {w['made']}, want {want}")
        for made in decodes:
            allowed = {"lz_decode_mono": 1, "bitunshuffle": 1} if lossy_run else {
                "lz_decode_mono": 1}
            if made and made != allowed:
                fail(f"grad: {label}: decompress_leaf launched {made}, want {allowed} or none")

    @contextlib.contextmanager
    def plain_path():
        """The lossy container's stages through their plain versions."""
        saved = lossy.compress_lossy, lossy.decode_many_lossy
        lossy.compress_lossy = functools.partial(saved[0], impl="plain")
        lossy.decode_many_lossy = functools.partial(saved[1], impl="plain")
        try:
            yield
        finally:
            lossy.compress_lossy, lossy.decode_many_lossy = saved

    sample = ["layers.0.attn.wk", "layers.7.mlp.wd"]

    def hold_plain(label, info, ratio_cap, lossy_eb):
        """Sampled leaves' wires and decodes against the plain path's."""
        plain_cfg = dataclasses.replace(gc.GRAD_LZ, backend="torch", decoder="torch-parallel")
        for n in sample:
            shape = tuple(stack[n].shape[1:])
            for w in info[n]:
                with plain_path():
                    pw = gc.compress_leaf(w["x"], plain_cfg, ratio_cap, lossy_eb)
                    pd = gc.decompress_leaf(pw, shape, plain_cfg, ratio_cap, lossy_eb)
                kw_, kd = w["w"], gc.decompress_leaf(w["w"], shape, gc.GRAD_LZ, ratio_cap,
                                                     lossy_eb)
                if not (torch.equal(kw_["payload"], pw["payload"])
                        and torch.equal(kw_["used_lz"], pw["used_lz"])
                        and torch.equal(kw_["scale"], pw["scale"])
                        and torch.equal(kd.view(torch.int32), pd.view(torch.int32))):
                    fail(f"grad: {label} {n}: the wire or its decode differs from the plain path's")
        print(f"[grad] exchange {label}: wires and decodes of {sample} equal to the plain path's "
              f"on the card")

    torch.cuda.reset_peak_memory_stats()
    for label, kw in (("ratio_cap=1.0", dict(ratio_cap=1.0)),
                      ("ratio_cap=2.0", dict(ratio_cap=2.0)),
                      (f"lossy eb={eb!r} ratio_cap=2.0", dict(ratio_cap=2.0, lossy_eb=eb))):
        # lossless, a slab whose codes do not fit the budget is sent raw and
        # never decoded: the decoder runs only where a slab compressed
        out, info = path_launches(
            f"grad {label}", ("lz_fused_mono", "lz_decode_mono", "bitshuffle", "bitunshuffle")
            if "lossy_eb" in kw else ("lz_fused_mono",), lambda: exchange(label, **kw))
        want_launches(label, info, "lossy_eb" in kw)
        if label == "ratio_cap=1.0":
            for n in names:
                x = stack[n].to(torch.float32)
                want = 0.0
                for k in range(2):
                    codes, scale = gc.quantize_u16(x[k])
                    want = want + gc.dequantize_u16(codes, scale)
                want = (want / 2).to(stack[n].dtype)
                small = stack[n][0].numel() < gc.MIN_COMPRESS_SIZE
                if small:
                    want = x.mean(0).to(stack[n].dtype)
                if not torch.equal(out[n], want):
                    fail(f"grad: {n}: the exchange differs from the per-pod quantize mean")
            print(f"[grad] exchange {label}: every leaf equal to the per-pod quantize mean "
                  f"(the norms: the plain mean)")
        if "lossy_eb" in kw:
            worst = 0.0
            for n, ws in info.items():
                shape = tuple(stack[n].shape[1:])
                for w in ws:
                    d = gc.decompress_leaf(w["w"], shape, gc.GRAD_LZ, 2.0, eb).reshape(-1)
                    used = w["w"]["used_lz"]
                    slab, _ = gc._slab_geometry(d.numel(), gc.GRAD_LZ)
                    x = w["x"].reshape(-1).to(torch.float32)
                    e = torch.nn.functional.pad((d - x).abs(), (0, used.numel() * slab - d.numel()))
                    e = e.reshape(used.numel(), slab)[used]
                    if e.numel():
                        worst = max(worst, float(e.max()))
            if not worst <= eb:
                fail(f"grad: lossy exchange error {worst} on container slabs exceeds eb {eb}")
            print(f"[grad] exchange {label}: max |g' - g| on slabs sent as containers {worst!r} "
                  f"<= eb {eb!r}")
        hold_plain(label, info, kw["ratio_cap"], kw.get("lossy_eb"))
        if label == "ratio_cap=2.0":
            exchanged = out
        del out, info
    print(f"[grad] {card} | peak memory of the exchanges {torch.cuda.max_memory_allocated()} bytes")

    tc = configs.TrainConfig(warmup_steps=1, total_steps=10)
    before = {n: p.detach().clone() for n, p in list(m.named_parameters())[:3]}
    opt = optim.init_opt_state(m)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, opt, metrics = optim.adamw_update(m, exchanged, opt, 1, tc)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    moved = [n for n, p in before.items() if not torch.equal(p, dict(m.named_parameters())[n])]
    if not (moved and all(bool(torch.isfinite(p).all()) for p in m.parameters())):
        fail("grad: adamw_update left the parameters unchanged or not finite")
    print(f"[grad] {card} | adamw_update on the exchanged (ratio_cap=2.0) gradients: {ms:.3f} ms, "
          f"grad_norm {float(metrics['grad_norm'])!r}, lr {float(metrics['lr'])!r}, f32 moments "
          f"{sum(v.numel() for v in opt['m'].values())} elements each")
    del m, stack, exchanged, opt
    torch.cuda.empty_cache()


def train_phase(inputs, card, err) -> None:
    """The training path on the card: llama3.2-1b whole in bf16 (the zoo's
    config, no cut), global batch 8 x seq 256, TrainConfig as train.build
    makes it (lr 3e-4, warm-up 1), through python -m repro_torch.launch.train's
    main.  (1) A run of 6 steps with --ckpt-every 3 saves step 3
    synchronously and is killed by a simulated crash (runtime/fault.FaultyFS)
    at its step-6 save; (2) a second run with --async-ckpt resumes from step
    3, trains steps 3-5 and saves step 6 asynchronously; (3) step 6 restored
    alone equals that run's final state bit for bit; (4) two groups'
    containers equal the plain PyTorch compressor's on the card; (5) a lossy
    save and restore of that state (lz_lossy_eb on its f32 leaves); (6) a
    straight run of 6 steps without checkpoints, whose losses the crashed
    run's (steps 0-5) and the resumed run's (3-5) equal, and whose final
    state the resumed run's equals, bit for bit, under
    torch.use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG=:4096:8);
    (7) two make_train_step(compressed=True) steps over a mesh of two cuda:0
    pods; (8) serve.main on the reduced config.  Every save launches the
    one-launch compressor once a group, every restore the one-launch decoder
    once a geometry group (counts reset before each call, read after).
    Printed: ms a step and tokens/s, peak memory, each save's and restore's
    seconds split into their parts, the writer's backpressure and stats,
    the checkpoint's ratio and stored bytes, the largest group.

    A crashed --steps 6 run, not a --steps 3 run, makes the checkpoint:
    train.build sets total_steps from --steps, and the cosine schedule over
    3 steps gives step 2 another learning rate than the one over 6."""
    import dataclasses
    import gc
    import shutil
    import tempfile
    import types
    import warnings
    import zlib

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs.base import CompressionConfig, ShapeConfig, TrainConfig
    from repro_torch.core import lzss
    from repro_torch.data.pipeline import DataConfig, Prefetcher
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib, serve, steps, train
    from repro_torch.optim import grad_compress as gc_lib
    from repro_torch.runtime import fault

    dev = torch.device("cuda")
    cfg = configs.get_config("llama3.2-1b")
    batch, seq = 8, 256
    raw_bytes = cfg.param_count(padded=True) * (2 + 4 + 4) + 4
    root = tempfile.mkdtemp(prefix="gpulz-train-")
    free = shutil.disk_usage(root).free
    # steps 3 and 6 (a state that does not compress stores at about 1.04
    # times its bytes) and the lossy step
    need = 3 * raw_bytes
    print(f"[train] {card} | checkpoints under {root} (keep=3, the launcher's default; "
          f"{free} bytes free, {need} needed: 3 x the {raw_bytes}-byte train state)")
    if free < need:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"train: {free} bytes free under {root}, the phase needs {need}")

    # ---------------------------------------------------- instrumentation
    split, counts, records, peaks = {}, {}, [], []
    patched = []

    def patch(owner, attr, new):
        patched.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def timed(owner, attr, key, sync=False, count=None):
        real = getattr(owner, attr)

        def wrapper(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                if sync:
                    torch.cuda.synchronize()
                split[key] = split.get(key, 0.0) + time.perf_counter() - t
                if count:
                    counts[count] = counts.get(count, 0) + 1

        patch(owner, attr, wrapper)

    timed(ckpt, "_host_bytes", "D2H of the leaves")
    crc = zlib.crc32

    def timed_crc(*a):
        t = time.perf_counter()
        out = crc(*a)
        split["CRC"] = split.get("CRC", 0.0) + time.perf_counter() - t
        return out

    patch(ckpt, "zlib", types.SimpleNamespace(crc32=timed_crc))
    timed(lzss, "compress_many_chunks", "compress dispatch", sync=True)
    timed(lzss, "compress_many", "compress_many", sync=True, count="groups")
    timed(lzss, "decompress_many_chunks", "decode dispatch", sync=True)
    timed(lzss, "decompress_many", "decompress_many", sync=True, count="groups")
    timed(ckpt, "_from_raw", "H2D of the leaves", sync=True)

    class TimedFS(fault.FaultyFS):
        """The host seam with each write timed (on whichever thread)."""

        def __init__(self, faults=()):
            super().__init__(faults)
            self.write_s, self.written = 0.0, 0

        def write_bytes(self, path, data):
            t = time.perf_counter()
            super().write_bytes(path, data)
            self.write_s += time.perf_counter() - t
            self.written += len(data)

    crash_at = []  # a FaultSpec planted in the next manager's seam

    def make_fs():
        return TimedFS(crash_at[:1])

    patch(ckpt, "HostFS", make_fs)
    real_save, real_load = ckpt.CheckpointManager.save, ckpt.CheckpointManager._load_step
    real_wait = ckpt.CheckpointManager.wait_until_finished

    def save(self, state, step):
        split.clear()
        counts.clear()
        ops.reset_launch_counts()
        w0 = self.fs.write_s
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = dict(kind="save", step=step, mode="async" if self.async_writes else "sync",
                   lossy=self.lz_lossy_eb is not None)
        try:
            return real_save(self, state, step)
        except BaseException as exc:
            rec["raised"] = type(exc).__name__
            raise
        finally:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            rec.update(s=time.perf_counter() - t0, split=dict(split), groups=counts.get("groups", 0),
                       launches={k: v for k, v in ops.launch_counts().items() if v},
                       writes_s=self.fs.write_s - w0, io_wait_s=self.last_save_io_wait_s,
                       mgr=self, peak=torch.cuda.max_memory_allocated())
            records.append(rec)

    def load(self, template, step, shardings=None):
        split.clear()
        counts.clear()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            return real_load(self, template, step, shardings)
        finally:
            torch.cuda.synchronize()
            records.append(dict(kind="restore", step=step, s=time.perf_counter() - t0,
                                split=dict(split), groups=counts.get("groups", 0),
                                launches={k: v for k, v in ops.launch_counts().items() if v},
                                lossy=self.lz_lossy_eb is not None,
                                peak=torch.cuda.max_memory_allocated()))
            peaks.append(records[-1]["peak"])

    def wait(self):
        t0 = time.perf_counter()
        real_wait(self)
        if self.writer is not None:
            records.append(dict(kind="wait", s=time.perf_counter() - t0,
                                writes_s=self.fs.write_s, written=self.fs.written,
                                stats=self.writer_stats()))

    patch(ckpt.CheckpointManager, "save", save)
    patch(ckpt.CheckpointManager, "_load_step", load)
    patch(ckpt.CheckpointManager, "wait_until_finished", wait)

    run, run_peaks = {}, []
    real_make = steps.make_train_step

    def make_train_step(*a, **k):
        fn, st_sh, b_sh = real_make(*a, **k)

        def step(state, b):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(state, b)
            torch.cuda.synchronize()
            run["ms"].append((time.perf_counter() - t) * 1e3)
            run["losses"].append(float(out[1]["loss"]))
            run["state"] = out[0]
            return out

        return step, st_sh, b_sh

    patch(steps, "make_train_step", make_train_step)

    def train_run(label, *flags):
        run.update(ms=[], losses=[], state=None)
        argv = ["--steps", "6", "--batch", str(batch), "--seq", str(seq), "--log-every", "1",
                "--device", str(dev)] + list(flags)
        print(f"[train] {label}: python -m repro_torch.launch.train {' '.join(argv)}")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            torch.cuda.reset_peak_memory_stats()
            try:
                train.main(argv)
            except fault.SimulatedCrash as exc:
                print(f"[train] {label}: killed by {exc}")
            finally:
                torch.use_deterministic_algorithms(False)
                # the run's peak, its saves' and restores' included (each
                # of those resets the count and adds its own to peaks)
                peaks.append(torch.cuda.max_memory_allocated())
        named = sorted({str(w.message).split("\n")[0] for w in caught
                        if "deterministic" in str(w.message)})
        for msg in named:
            print(f"[train] {label}: no deterministic CUDA path: {msg}")
        run_peaks.append(peaks[-1])
        out = dict(ms=run["ms"], losses=run["losses"], state=run.pop("state"), nondet=named)
        gc.collect()
        return out

    def leaves_of(state):
        """(name, leaf) in the checkpoint's order, each stacked leaf made
        only when reached (all at once would double the state)."""
        names, leaves, _ = ckpt._leaf_paths(state)
        for name, leaf in zip(names, leaves):
            yield name, ckpt._leaf_array(leaf)

    def same_state(a, b) -> list:
        """Names of the leaves where two train states differ in any bit."""
        bad = []
        for (name, x), (_, y) in zip(leaves_of(a), leaves_of(b)):
            if x.dtype == torch.bfloat16:
                x, y = x.view(torch.int16), y.view(torch.int16)
            if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
                bad.append(name)
        return bad

    def show(rec):
        parts = ", ".join(f"{k} {v:.3f}" for k, v in rec["split"].items())
        extra = ""
        if rec["kind"] == "save":
            extra = (f"; disk writes {rec['writes_s']:.3f} s on the {'writer thread' if rec['mode'] == 'async' else 'caller'}, "
                     f"last_save_io_wait_s {rec['io_wait_s']!r}")
        extra += f"; peak memory {rec['peak']} bytes"
        print(f"[train] {card} | {rec['kind']} of step {rec['step']}"
              f"{' (' + rec['mode'] + ')' if rec['kind'] == 'save' else ''}"
              f"{' lossy' if rec.get('lossy') else ''}: {rec['s']:.3f} s; {parts} s{extra}; "
              f"{rec['groups']} groups, launches {rec['launches']}")

    def want_one_launch(rec):
        key = "lz_fused_mono" if rec["kind"] == "save" else "lz_decode_mono"
        if rec["launches"] != {key: rec["groups"]} or not rec["groups"]:
            fail(f"train: {rec['kind']} of step {rec['step']} launched {rec['launches']} over "
                 f"{rec['groups']} groups; want {key} once a group and nothing else")

    try:
        d = f"{root}/run"
        # (1) the run that saves step 3 and dies at its step-6 save
        crash_at[:] = [fault.FaultSpec(op="makedirs", path_substr="step_00000006", mode="crash")]
        first = train_run("crashed run", "--ckpt-every", "3", "--ckpt-dir", d)
        crash_at[:] = []
        saves = [r for r in records if r["kind"] == "save"]
        if len(first["losses"]) != 6 or [r["step"] for r in saves] != [3, 6] or saves[1].get(
                "raised") != "SimulatedCrash":
            fail(f"train: the crashed run took {len(first['losses'])} steps and saved "
                 f"{[(r['step'], r.get('raised')) for r in saves]}")
        show(saves[0])
        want_one_launch(saves[0])
        del first["state"]
        gc.collect()
        torch.cuda.empty_cache()

        # (2) the resumed run
        records.clear()
        second = train_run("resumed run", "--async-ckpt", "--ckpt-dir", d)
        rest = [r for r in records if r["kind"] == "restore"]
        sv = [r for r in records if r["kind"] == "save"]
        waits = [r for r in records if r["kind"] == "wait"]
        if [r["step"] for r in rest] != [3] or [r["step"] for r in sv] != [6] or len(
                second["losses"]) != 3:
            fail(f"train: the resumed run restored {[r['step'] for r in rest]}, saved "
                 f"{[r['step'] for r in sv]} and took {len(second['losses'])} steps")
        for r in rest + sv:
            show(r)
            want_one_launch(r)
        ws = waits[-1]
        print(f"[train] {card} | async save of step 6: wait_until_finished {ws['s']:.3f} s after "
              f"save() returned; disk writes {ws['writes_s']:.3f} s for {ws['written']} bytes on "
              f"the writer thread ({ws['written'] / max(ws['writes_s'], 1e-9) / 1e9:.3f} GB/s); "
              f"writer_stats() {ws['stats']}")
        state = second["state"]
        mgr = sv[0]["mgr"]
        st6 = mgr.stats(6)
        print(f"[train] {card} | step 6: stats() ratio {st6['ratio']!r}, stored "
              f"{st6['stored_bytes']} of {st6['orig_bytes']} bytes")
        names, leaves, _ = ckpt._leaf_paths(state)
        groups = {}
        for name, leaf in leaves_of(state):
            n = leaf.numel() * leaf.element_size()
            if n < 1024:
                continue
            s = ckpt._symbol_size(leaf.element_size())
            nc = -(-(-(-n // s)) // mgr.lz_chunk)
            groups.setdefault((s, 1 << max(0, nc - 1).bit_length()), []).append((name, n, nc))
        (gs, gb), big = max(groups.items(), key=lambda kv: sum(n for _, n, _ in kv[1]))
        print(f"[train] {card} | largest group: S={gs}, {len(big)} leaves, "
              f"{sum(n for _, n, _ in big)} bytes, B x nc = {len(big)} x {gb} = {len(big) * gb} "
              f"chunks of {mgr.lz_chunk} symbols ({[n for n, _, _ in big]})")

        # (3) the round trip alone
        records.clear()
        template = steps.abstract_train_state(cfg, None)
        back, step = mgr.restore(template, 6, shardings=dev)
        show(records[-1])
        want_one_launch(records[-1])
        bad = same_state(state, back)
        if step != 6 or bad:
            fail(f"train: step 6 restored differs from the state saved in {bad[:5]}")
        print(f"[train] save + restore of step 6: all {len(names)} leaves bit for bit")
        del back
        gc.collect()
        torch.cuda.empty_cache()

        # (4) two groups' containers against the plain compressor on the card
        by_name = dict(zip(names, leaves))
        for s_, b_ in ((4, 8), (2, 16384)):  # the f32 norms' moments; wq and wo
            if (s_, b_) not in groups:
                fail(f"train: no group S={s_} bucket {b_} in {sorted(groups)}")
            members = [n for n, _, _ in groups[(s_, b_)]]
            plain = lzss.compress_many(
                [ckpt._leaf_array(by_name[n]) for n in members],
                dataclasses.replace(mgr._lz_config(s_), backend="torch"), device=dev)
            for j, n in enumerate(members):
                disk = np.fromfile(f"{d}/step_00000006/{n.replace('/', '.')}.gplz", np.uint8)
                if not np.array_equal(disk, plain[j].data):
                    fail(f"train: {n}'s container differs from the plain path's")
            print(f"[train] group S={s_} bucket {b_} ({members}): containers equal to the plain "
                  f"PyTorch compressor's on the card")

        # (5) a lossy save and restore of the same state
        top = max(float(x.abs().max()) for _, x in leaves_of(state) if x.dtype == torch.float32)
        eb = float(np.float32(top * 2.0**-10))
        print(f"[train] lossy: one eb for every f32 leaf (the moments), {eb!r} = 2^-10 x the "
              f"largest |x| over them ({top!r}): the largest leaf spans +-512 steps of 2 eb, "
              f"under the quantizer's range, while leaves far below eb (v) code as zeros")
        records.clear()
        lm = ckpt.CheckpointManager(f"{root}/lossy", keep=1, lz_lossy_eb=eb, device=dev)
        lm.save(state, 6)
        back, _ = lm.restore(template, 6, shardings=dev)
        for r in records:
            show(r)
        made = {k for r in records for k in r["launches"]}
        if not {"bitshuffle", "lz_fused_mono", "lz_decode_mono", "bitunshuffle"} <= made:
            fail(f"train: the lossy save and restore launched only {made}")
        worst, nonfinite = 0.0, 0
        for (name, x), (_, y) in zip(leaves_of(state), leaves_of(back)):
            if x.dtype == torch.float32:
                fin = torch.isfinite(x)
                nonfinite += int((~fin).sum())
                if not torch.equal(x[~fin].view(torch.int32), y[~fin].view(torch.int32)):
                    fail(f"train: {name}'s non-finite elements changed")
                worst = max(worst, float((x[fin] - y[fin]).abs().max()))
            elif not torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                                 y.view(torch.int16) if y.dtype == torch.bfloat16 else y):
                fail(f"train: lossless leaf {name} changed in the lossy checkpoint")
        if not worst <= eb:
            fail(f"train: lossy restore error {worst} exceeds eb {eb}")
        ls = lm.stats(6)
        print(f"[train] {card} | lossy: max |x' - x| {worst!r} <= eb {eb!r}; {nonfinite} non-finite "
              f"elements; ratio {ls['ratio']!r}, stored {ls['stored_bytes']} bytes")
        del back
        gc.collect()
        torch.cuda.empty_cache()

        # (6) the straight run, and the comparisons
        straight = train_run("straight run")
        ms = sorted(straight["ms"][1:])
        med = ms[len(ms) // 2]
        print(f"[train] {card} | train step (straight run, host clock around synchronize): "
              f"{straight['ms'][0]:.1f} ms the first, median of the next 5 {med:.3f} ms "
              f"({batch * seq / med * 1e3:.1f} tokens/s); losses {straight['losses']}")
        if first["losses"] != straight["losses"] or second["losses"] != straight["losses"][3:]:
            named = first["nondet"] + second["nondet"] + straight["nondet"]
            msg = (f"losses differ: crashed {first['losses']}, resumed {second['losses']}, "
                   f"straight {straight['losses']}")
            if not named:
                fail(f"train: {msg}, and no op without a deterministic path was named")
            print(f"[train] {msg}; ops named above")
        bad = same_state(straight["state"], state)
        if bad:
            named = second["nondet"] + straight["nondet"]
            if not named:
                fail(f"train: the resumed run's final state differs in {bad[:5]}")
            print(f"[train] the resumed state differs in {len(bad)} leaves; ops named above")
        else:
            print(f"[train] resumed run == straight run bit for bit: losses of steps 0-5 (crashed "
                  f"run), 3-5 (resumed run) and all {len(names)} leaves of the final state")
        del straight, state, mgr
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[train] {card} | peak memory of the runs, saves and restores {max(peaks)} "
              f"bytes; the runs alone (after their last save or restore): {run_peaks}")

        # (7) two compressed steps over a mesh of two cuda:0 pods
        tc = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=8,
                         compression=CompressionConfig(grad_cross_pod=True))
        pods = mesh_lib.make_host_mesh(data=1, model=1, pod=2, device=dev)
        run.update(ms=[], losses=[], state=None)
        fn, _, _ = steps.make_train_step(cfg, tc, pods, ShapeConfig("cli", seq, batch, "train"),
                                         compressed=True)
        st = steps.init_train_state(cfg, tc, 0, device=dev)
        big_leaves = sum(p.numel() >= gc_lib.MIN_COMPRESS_SIZE for p in st["params"].parameters())
        pre = Prefetcher(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                    seed=0), 0, device=dev)
        ops.reset_launch_counts()
        for _ in range(2):
            st, m = fn(st, pre.next())
        made = {k: v for k, v in ops.launch_counts().items() if v}
        if not big_leaves or made.get("lz_fused_mono") != 2 * 2 * big_leaves or not all(
                np.isfinite(v) for v in run["losses"]):
            fail(f"train: compressed steps launched {made} (want lz_fused_mono "
                 f"{4 * big_leaves}) with losses {run['losses']}")
        print(f"[train] {card} | 2 compressed steps over a mesh of two cuda:0 pods: "
              f"{run['ms'][0]:.1f} / {run['ms'][1]:.1f} ms, losses {run['losses']}; launches "
              f"{made} ({big_leaves} leaves of >= {gc_lib.MIN_COMPRESS_SIZE} elements a pod)")
        del st, fn, run["state"]
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for owner, attr, real in reversed(patched):
            setattr(owner, attr, real)
        shutil.rmtree(root, ignore_errors=True)

    # (8) the serving entry point on the reduced config
    t0 = time.perf_counter()
    serve.main(["--new-tokens", "8", "--device", str(dev)])
    print(f"[train] {card} | python -m repro_torch.launch.serve --new-tokens 8: "
          f"{time.perf_counter() - t0:.3f} s")


RAW_KERNELS = ("lz_kernel1", "lz_global_offsets", "lz_scatter", "lz_decode", "lz_fused_mono",
               "lz_decode_mono", "lz_match")
# Launched by the container path with the one-launch pair as the default:
# the compressor and, for the raw inner stage of lossy-fz at eb=0, the
# decoder; the split decoder decodes the entropy-coded sections.
CONTAINER_KERNELS = ("lz_fused_mono", "lz_decode_mono", "lz_decode", "byte_histogram",
                     "huffman_gap_decode", "bitshuffle", "bitunshuffle")
SUB = 512  # gap-array sub-block: decoded bytes per entry point


def count_calls(owner, attr) -> list:
    """Wrap ``owner.attr`` so that each call adds one to the returned
    one-element list."""
    fn, calls = getattr(owner, attr), [0]

    def counted(*a, **k):
        calls[0] += 1
        return fn(*a, **k)

    setattr(owner, attr, counted)
    return calls


def max_diff(a, b) -> int:
    import torch

    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if not a.numel():
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def lossy_error(data, out, eb: float):
    """None if ``out`` reconstructs the f32 bytes ``data`` as the lossy-fz
    format promises (finite elements within eb, the others bit-exact, all
    bit-exact at eb=0), else what is wrong."""
    import numpy as np

    x, y = data.view(np.float32), out.view(np.float32)
    if x.shape != y.shape:
        return f"decoded {y.size} elements for {x.size}"
    fin = np.isfinite(x)
    if eb == 0.0 or not fin.all():
        keep = np.ones_like(fin) if eb == 0.0 else ~fin
        if not np.array_equal(x[keep].view(np.uint32), y[keep].view(np.uint32)):
            return "elements that must be bit-exact differ"
    if eb and fin.any():
        err = float(np.abs(y[fin] - x[fin]).max())
        if not err <= np.float32(eb):
            return f"max |x' - x| = {err!r} exceeds eb = {eb}"
    return None


def hold_container_kernels(hurr_quant, err) -> dict:
    """Phase 3 for the container-stage kernels: each CUDA kernel against its
    plain version on the same CUDA tensors.  Returns the main-path-shaped
    inputs the timing phase uses."""
    import torch

    from repro_torch import core
    from repro_torch.core import entropy, format as fmt, pipeline as pl
    from repro_torch.kernels import lz_bitshuffle, lz_entropy

    dev = torch.device("cuda")
    cfg = core.LZSSConfig()
    raw = torch.from_numpy(hurr_quant).to(dev)
    sym = pl.pack_symbols(raw, cfg.symbol_size).reshape(-1, cfg.chunk_symbols)
    buf, total = pl.compress_chunks(sym, cfg, raw.numel())
    buf = buf[:total].contiguous()  # the raw container of 128 MiB of hurr-quant
    head = fmt.parse_header(buf[: fmt.HEADER_BYTES].cpu().numpy())
    sec = fmt.HEADER_BYTES + 8 * head.n_chunks
    f_tot, p_tot = head.flag_bytes, head.payload_bytes
    n = buf.numel()
    for start, length in ((0, n), (3, n - 10), (sec, f_tot), (sec + f_tot, p_tot),
                          (12345, 1), (7, 0)):
        got = lz_entropy.byte_histogram_cuda(buf, start, length)
        lib = torch.bincount(buf[start : start + length], minlength=256)
        err["byte_histogram"] = max(
            err["byte_histogram"], max_diff(got, lz_entropy.byte_histogram_plain(buf, start, length)),
            max_diff(got, lib),
        )
    print(f"[kernels] byte_histogram over 6 ranges of a {n}-byte container: "
          f"max |kernel - plain| {err['byte_histogram']}")

    def gap_case(section, label):
        k = section.numel()
        counts = lz_entropy.byte_histogram_cuda(section, 0, k).cpu().numpy()
        lengths = entropy.container_code_lengths(counts)
        stream, nbits, gaps = entropy.encode_section(section, 0, k, lengths, cap=k)
        tabs = entropy.canonical_tables(lengths, dev)
        nsub = -(-k // SUB)
        g = gaps[:nsub]
        args = (stream[: (nbits + 7) // 8].contiguous(), g >> 3, (g & 7).to(torch.int32),
                tabs["first"], tabs["count"], tabs["base"], tabs["order"])
        got = lz_entropy.huffman_gap_decode_cuda(*args, sub=SUB)
        e = max_diff(got, lz_entropy.huffman_gap_decode_plain(*args, sub=SUB))
        err["huffman_gap_decode"] = max(err["huffman_gap_decode"], e)
        if not torch.equal(got.reshape(-1)[:k], section):
            fail(f"gap decode of the {label} section does not invert its encode")
        print(f"[kernels] huffman_gap_decode, {label}: {k} bytes, {nsub} sub-blocks "
              f"(last holds {k - (nsub - 1) * SUB}), {nbits} bits, max lengths "
              f"{int(lengths.max())}: max |kernel - plain| {e}")
        return args, nbits, int(lengths.max())

    payload = buf[sec + f_tot : sec + f_tot + p_tot]
    gap_main = gap_case(payload, "container payload (skewed code)")
    gap_flags = gap_case(buf[sec : sec + f_tot], "container flags (skewed code)")
    flat = torch.arange(256, device=dev, dtype=torch.int32).repeat(p_tot // 256 + 1)[:p_tot]
    gap_escape = gap_case(flat.to(torch.uint8), "flat histogram of the payload's size (stored escape)")
    flat = torch.arange(256, device=dev, dtype=torch.int32).repeat(4096 + 1)[: (1 << 20) + 37]
    gap_case(flat.to(torch.uint8), "flat histogram (stored escape)")
    gap_case(torch.full((5000,), 9, dtype=torch.uint8, device=dev), "one symbol")

    units, shuffled = hold_bitshuffle(err)
    return dict(hist=(buf, sec + f_tot, p_tot), hist_flags=(buf, sec, f_tot),
                gap=gap_main[:2], gap_flags=gap_flags,
                gap_escape=gap_escape, units=units, shuffled=shuffled)


def hold_bitshuffle(err):
    """Phase 3 for the bitshuffle pair: both kernels against their plain
    versions on the pair's edge inputs, on views that are not 16-byte
    aligned and into larger out= buffers.  Returns the 65,536-block random
    units and their shuffle, the timing phase's inputs."""
    import numpy as np
    import torch

    from repro_torch.data import bitshuffle_edges as edges
    from repro_torch.kernels import lz_bitshuffle

    dev = torch.device("cuda")

    def hold(units, label, src=None, out=None, uout=None):
        """``units`` through both kernels (the inverse reads ``src``, a view
        holding the shuffled bytes, when given); returns the shuffle."""
        got = lz_bitshuffle.bitshuffle_cuda(units, out=out)
        want = lz_bitshuffle.bitshuffle_plain(units)
        err["bitshuffle"] = max(err["bitshuffle"], max_diff(got, want))
        src = want if src is None else src
        back = lz_bitshuffle.bitunshuffle_cuda(src, out=uout)
        err["bitunshuffle"] = max(err["bitunshuffle"],
                                  max_diff(back, lz_bitshuffle.bitunshuffle_plain(src)))
        if not torch.equal(back, units):
            fail(f"bitunshuffle does not invert bitshuffle on {label}")
        return got

    def tensor(units):
        return torch.from_numpy(units.view(np.int16).copy()).to(dev)

    cases = 0
    for pattern in edges.PATTERNS:
        for nb in edges.BLOCK_COUNTS:
            hold(tensor(edges.edge_units(pattern, nb, seed=nb)), f"{pattern} x {nb} blocks")
            cases += 1
    got = hold(tensor(edges.one_hot_units()), "the one-hot map")
    if not np.array_equal(got.cpu().numpy(), edges.one_hot_expected()):
        fail("bitshuffle of the one-hot map breaks the wire layout's rule")
    gen = torch.Generator(dev).manual_seed(0)
    for nb in (65537, 65536):
        units = torch.randint(-(1 << 15), 1 << 15, (nb * 512,), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int16)
        shuffled = hold(units, f"{nb} random blocks")
    # views at a storage offset (not 16-byte aligned) and out= buffers
    small = tensor(edges.edge_units("random", 4097, seed=5))
    n = small.numel() * 2
    ubuf = torch.zeros(small.numel() + 1, dtype=torch.int16, device=dev)
    ubuf[1:] = small
    hold(ubuf[1:], "an int16 view at a 1-unit offset")
    want = lz_bitshuffle.bitshuffle_plain(small)
    for off in (1, 2, 8):
        sbuf = torch.zeros(n + off, dtype=torch.uint8, device=dev)
        sbuf[off:] = want
        obuf = torch.zeros(n + off + 64, dtype=torch.uint8, device=dev)
        oubuf = torch.zeros(small.numel() + 2, dtype=torch.int16, device=dev)
        hold(small, f"uint8 views at a {off}-byte offset", src=sbuf[off:], out=obuf[off:],
             uout=oubuf[1:])
        if obuf[:off].any() or obuf[off + n :].any() or oubuf[0] or oubuf[-1]:
            fail(f"a bitshuffle kernel wrote outside its out= view at offset {off}")
    big = torch.zeros(shuffled.numel() + 4096, dtype=torch.uint8, device=dev)
    ubig = torch.zeros(units.numel() + 512, dtype=torch.int16, device=dev)
    got = hold(units, "65536 blocks into larger out= buffers", out=big, uout=ubig)
    if got.data_ptr() != big.data_ptr() or big[shuffled.numel() :].any() or ubig[units.numel() :].any():
        fail("out= of the bitshuffle pair: not the prefix, or the tail written")
    print(f"[kernels] bitshuffle / bitunshuffle on {cases} edge cases, the one-hot map, 65536 and "
          f"65537 blocks, misaligned views (1 unit; 1, 2, 8 bytes) and out= buffers: "
          f"max |kernel - plain| {err['bitshuffle']} / {err['bitunshuffle']}")
    return units, shuffled


def hold_scatter_edges(err) -> None:
    """Phase 3 for Kernel III and the histogram on their edge inputs
    (repro_torch/data/scatter_edges.py): Kernel III on every kind at every
    geometry, both shared-memory layouts; the histogram on every pattern at
    every (start, length) of the ranges and on 64 MiB of one value."""
    import numpy as np
    import torch

    from repro_torch.core import format as fmt
    from repro_torch.data import scatter_edges as edges
    from repro_torch.kernels import lz_entropy, lz_scatter

    dev = torch.device("cuda")
    layouts = set()
    for c, s in edges.GEOMETRIES:
        nc = edges.chunks_for(c)
        kw = dict(symbol_size=s, min_match=edges.min_match(s),
                  cap=fmt.max_compressed_bytes(nc * c * s, s, c),
                  sec_flags=fmt.HEADER_BYTES + 8 * nc)
        layouts.add(lz_scatter.scatter_occupancy(chunk_symbols=c, symbol_size=s)["layout"])
        for i, kind in enumerate(edges.KINDS):
            x = edges.scatter_inputs(kind, 2, nc, c, s, seed=17 * c + 5 * s + i)
            fo, po = edges.section_offsets(x["n_tokens"], x["payload_sizes"])
            args = [torch.from_numpy(x[k]).to(dev) for k in
                    ("symbols", "lengths", "offsets", "emitted", "local_off")]
            args += [torch.from_numpy(fo).to(dev), torch.from_numpy(po).to(dev)]
            err["lz_scatter"] = max(err["lz_scatter"], max_diff(
                lz_scatter.scatter_cuda(*args, **kw), lz_scatter.scatter_plain(*args, **kw)))
    if layouts != {"staged", "direct"}:
        fail(f"Kernel III's edges ran the layouts {layouts}, not both")
    for pattern in edges.HIST_PATTERNS:
        buf = torch.from_numpy(edges.histogram_bytes(pattern, 64, seed=3)).to(dev)
        for start, length in edges.RANGES:
            err["byte_histogram"] = max(err["byte_histogram"], max_diff(
                lz_entropy.byte_histogram_cuda(buf, start, length),
                lz_entropy.byte_histogram_plain(buf, start, length)))
    big = torch.from_numpy(edges.histogram_bytes("one-value", edges.BIG_BYTES)).to(dev)
    for start in (0, 3):
        n = big.numel() - start - 5
        want = torch.from_numpy(np.bincount([0x7F], weights=[n], minlength=256)
                                .astype(np.int32)).to(dev)
        err["byte_histogram"] = max(err["byte_histogram"], max_diff(
            lz_entropy.byte_histogram_cuda(big, start, n), want))
    print(f"[kernels] Kernel III on its edges ({len(edges.KINDS)} kinds x "
          f"{len(edges.GEOMETRIES)} geometries, C in "
          f"{sorted({c for c, _ in edges.GEOMETRIES})}, both layouts): max |kernel - plain| "
          f"{err['lz_scatter']}; byte_histogram on {len(edges.HIST_PATTERNS)} patterns x "
          f"{len(edges.RANGES)} ranges and 64 MiB of one value: {err['byte_histogram']}")


def hold_offsets_edges(err) -> None:
    """Phase 3 for Kernel II on its edge inputs
    (repro_torch/data/offsets_edges.py): every kind at every nc and row
    count through the wrapper and through the C entry point; input views
    at 4, 8 and 12 bytes past a 16-byte boundary through the wrapper, and
    all four arrays as such views through the C entry point."""
    import torch

    from repro_torch.data import offsets_edges as edges
    from repro_torch.kernels import _build, lz_scatter

    dev = torch.device("cuda")
    lib = _build.library("lz_scatter")
    stream = torch.cuda.current_stream().cuda_stream

    def hold(nt, ps, out=None):
        want = lz_scatter.global_offsets_plain(nt, ps)
        if out is None:
            got = lz_scatter.global_offsets_cuda(nt, ps)
        else:
            got = out
            _build.check(lib, lib.lz_global_offsets_launch(
                nt.data_ptr(), ps.data_ptr(), *nt.shape, *(t.data_ptr() for t in out), stream),
                "Kernel II (lz_global_offsets_launch)")
        err["lz_global_offsets"] = max(err["lz_global_offsets"],
                                       *(max_diff(a, b) for a, b in zip(got, want)))
        return want

    for kind, rows, nc in edges.edge_cases():
        nt, ps = (torch.from_numpy(a).to(dev) for a in edges.offsets_inputs(kind, rows, nc))
        want = hold(nt, ps)
        hold(nt, ps, out=tuple(torch.full_like(t, -7) for t in want))
    views = 0
    for shift in edges.VIEW_BYTES:
        for kind, rows, nc in (("random", 3, 1025), ("ragged", 8, 33), ("last", 1, 16385),
                               ("random", 1, 32769), ("literals", 8, 262144)):
            nt, ps = (torch.from_numpy(a).to(dev) for a in edges.offsets_inputs(kind, rows, nc))
            want = lz_scatter.global_offsets_plain(nt, ps)
            vt, vp = edges.view_at(nt, shift), edges.view_at(ps, shift)
            for a, b in ((vt, vp), (vt, ps), (nt, vp)):
                hold(a, b)
            hold(vt, vp, out=tuple(edges.view_at(torch.full_like(t, -7), shift) for t in want))
            views += 4
    print(f"[kernels] Kernel II on its edges ({len(edges.KINDS)} kinds x {len(edges.NCS)} nc "
          f"from {min(edges.NCS)} to {max(edges.NCS)} x rows {edges.ROWS}, through the wrapper "
          f"and the C entry; {views} calls on views at {edges.VIEW_BYTES} bytes past 16): max "
          f"|kernel - plain| {err['lz_global_offsets']}")


def _plain_container(data, cfg):
    """The container of ``data`` by the plain PyTorch path on the card."""
    import torch

    from repro_torch.core import entropy, lossy, pipeline as pl

    s, c = cfg.symbol_size, cfg.chunk_symbols
    nsym = -(-max(data.size, 1) // s)
    nc = -(-nsym // c)
    padded = torch.zeros(nc * c * s, dtype=torch.uint8, device="cuda")
    padded[: data.size] = torch.from_numpy(data).cuda()
    sym = pl.pack_symbols(padded, s).reshape(nc, c)
    hook = entropy.compress_entropy if cfg.backend == "deflate-full" else lossy.compress_lossy
    buf, total = hook(sym, cfg, data.size, impl="plain")
    return buf[:total].cpu().numpy()


def container_main_path(inputs, emit_calls):
    """Phase 5 for the container formats: the host API on deflate-full and
    lossy-fz at real sizes, launch counts set to 0 before and read after,
    and no call of the plain emit tail (``emit_calls`` counts them).
    Returns (host-clock times, launch counts)."""
    import numpy as np
    import torch

    from repro_torch import core
    from repro_torch.kernels import ops

    lossy_cfg = core.LZSSConfig(symbol_size=4, backend="lossy-fz", lossy_eb=1e-3,
                                lossy_inner="deflate-full")
    runs = [
        ("hurr-field lossy-fz eb=1e-3 inner=deflate-full", lossy_cfg, 1e-3),
        ("hurr-field lossy-fz eb=0", core.LZSSConfig(symbol_size=4, backend="lossy-fz",
                                                     lossy_eb=0.0), 0.0),
        ("hurr-quant deflate-full", core.LZSSConfig(backend="deflate-full"), None),
    ]
    field = inputs["hurr-field"]
    batch = [field[i * 8 * MIB : (i + 1) * 8 * MIB] for i in range(8)]
    for _, cfg, _ in runs:  # warm-up on 1 MiB
        core.decompress(core.compress(batch[0][:MIB], cfg).data)
    torch.cuda.synchronize()

    from repro_torch.kernels import lz_bitshuffle

    misaligned, seen, restore = [], [], []
    for attr in ("bitshuffle_cuda", "bitunshuffle_cuda"):
        fn = getattr(lz_bitshuffle, attr)

        def watched(x, out=None, _fn=fn, _attr=attr):
            seen.append(_attr)
            if x.data_ptr() % 16 or (out is not None and out.data_ptr() % 16):
                misaligned.append(_attr)
            return _fn(x, out)

        setattr(lz_bitshuffle, attr, watched)
        restore.append((attr, fn))
    ops.reset_launch_counts()
    emits = emit_calls[0]
    results, times = {}, {}
    for label, cfg, _ in runs:
        data = inputs[label.split()[0]]
        t0 = time.perf_counter()
        res = core.compress(data, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = core.decompress(res.data)
        torch.cuda.synchronize()
        results[label] = (res, back)
        times[label] = (t1 - t0, time.perf_counter() - t1)
    t0 = time.perf_counter()
    many = core.compress_many(batch, lossy_cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    many_back = core.decompress_many(many)
    torch.cuda.synchronize()
    blabel = "batch 8 x 8 MiB hurr-field lossy-fz eb=1e-3 inner=deflate-full"
    times[blabel] = (t1 - t0, time.perf_counter() - t1)
    launches = ops.launch_counts()
    for attr, fn in restore:
        setattr(lz_bitshuffle, attr, fn)
    print(f"[main] launches on the container path: {launches}")
    if misaligned or not seen:
        fail(f"the bitshuffle pair saw pointers that are not 16-byte aligned: {misaligned}")
    print(f"[main] bitshuffle pair on the container path: {len(seen)} calls, every input and "
          f"output 16-byte aligned (the kernels' vector path)")
    if any(launches[k] < 1 for k in CONTAINER_KERNELS) or any(
            launches[k] for k in ops.KERNELS if k not in CONTAINER_KERNELS):
        fail(f"the container path did not launch exactly {CONTAINER_KERNELS}: {launches}")
    if emit_calls[0] != emits:
        fail(f"the container path ran the plain emit tail {emit_calls[0] - emits} times")

    for label, cfg, eb in runs:
        res, back = results[label]
        data = inputs[label.split()[0]]
        bad = lossy_error(data, back, eb) if eb is not None else (
            None if np.array_equal(back, data) else "round trip is not exact")
        if bad:
            fail(f"{label}: {bad}")
        if not np.array_equal(_plain_container(data, cfg), res.data):
            fail(f"{label}: the kernels' container differs from the plain path's")
        print(f"[main] {label}, {data.size // MIB} MiB: ratio {res.ratio!r}, {res.total_bytes} "
              f"bytes, {'exact' if not eb else 'within eb'}, equal to the plain path")
    for i, (item, back) in enumerate(zip(batch, many_back)):
        bad = lossy_error(item, back, 1e-3)
        if bad:
            fail(f"batch buffer {i}: {bad}")
        if not np.array_equal(_plain_container(item, lossy_cfg), many[i].data):
            fail(f"batch buffer {i}: the kernels' container differs from the plain path's")
    print(f"[main] {blabel}: ratio {many.ratio!r}, within eb, equal to the plain path")
    return times, launches


def lossy_stage_breakdown(data, card) -> None:
    """The stages of one 128 MiB lossy-fz round trip (eb=1e-3, deflate-full
    inner), each on the host clock around a synchronize: the host API's
    steps driven one by one, and inside the two container hooks the
    library's stage functions wrapped by timers (the hook's rest is its
    own arithmetic: quantization and outliers, or dequantization)."""
    import numpy as np
    import torch

    from repro_torch import core
    from repro_torch.core import bitshuffle, deflate, entropy, format as fmt, lossy
    from repro_torch.core import pipeline as pl

    cfg = core.LZSSConfig(symbol_size=4, backend="lossy-fz", lossy_eb=1e-3,
                          lossy_inner="deflate-full")
    dev = torch.device("cuda")
    stages, saved = {}, []

    def run(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[label] = stages.get(label, 0.0) + (time.perf_counter() - t) * 1e3
        return out

    def timed(owner, attr, label):
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, lambda *a, **k: run(label, lambda: fn(*a, **k)))

    timed(bitshuffle, "shuffle", "  bitshuffle kernel")
    timed(pl, "lzss_many", "  inner LZSS: the one-launch compressor, header")
    timed(entropy, "byte_histogram", "  histogram kernel (x2)")
    timed(entropy, "container_code_lengths", "  host code lengths (x2)")
    timed(entropy, "encode_section", "  encode sections: cumsum + 3 index_add_ (x2)")
    timed(entropy, "decode_section", "  gap decode kernel + tables (x2)")
    timed(deflate, "gather_section", "  section gathers (x2)")
    timed(pl.FusedDecoder, "decode", "  LZSS decoder kernel")
    timed(bitshuffle, "unshuffle", "  unshuffle kernel")
    try:
        raw = run("h2d input", lambda: torch.from_numpy(data).to(dev))
        sym = run("pack symbols", lambda: raw.view(torch.int32).reshape(-1, cfg.chunk_symbols))
        inner_c = ("bitshuffle", "inner LZSS", "histogram", "host code", "encode")
        buf, total = run("compress_lossy (hook)", lambda: lossy.compress_lossy(sym, cfg, data.size))
        blob = run("d2h container", lambda: buf[:total].cpu().numpy())
        h, _, _ = run("validate_container (numpy, inner included)",
                      lambda: fmt.validate_container(blob))
        dblob = run("h2d container", lambda: torch.from_numpy(blob).to(dev))
        sym2 = run("decode_blob_lossy (hook)", lambda: lossy.decode_blob_lossy(dblob, h))
        out = run("unpack + d2h output", lambda: pl.unpack_symbols(
            sym2.reshape(-1), 4)[: data.size].cpu().numpy())
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    bad = lossy_error(data, out, 1e-3)
    if bad:
        fail(f"lossy stage breakdown: {bad}")
    inner = {k: v for k, v in stages.items() if k.startswith("  ")}
    in_compress = sum(v for k, v in inner.items() if k.strip().startswith(inner_c))
    stages["  rest of the hook: quantization, outliers, assembly"] = (
        stages["compress_lossy (hook)"] - in_compress)
    stages["  rest of the hook: header reads, dequantization, chain repair"] = (
        stages["decode_blob_lossy (hook)"] - (sum(inner.values()) - in_compress))
    order = ["h2d input", "pack symbols", "compress_lossy (hook)"]
    order += [k for k in stages if k.startswith("  ") and k.strip().startswith(inner_c)]
    order += ["  rest of the hook: quantization, outliers, assembly", "d2h container",
              "validate_container (numpy, inner included)", "h2d container",
              "decode_blob_lossy (hook)"]
    order += [k for k in stages if k.startswith("  ") and not k.strip().startswith(inner_c)
              and "rest" not in k]
    order += ["  rest of the hook: header reads, dequantization, chain repair",
              "unpack + d2h output"]
    for label in order:
        print(f"[time] {card} | lossy stage {label}: {stages[label]:.3f} ms, hurr-field "
              f"128 MiB, eb=1e-3, deflate-full inner")
    ratio = data.size / max(1, total)
    print(f"[time] {card} | lossy stages: ratio {ratio!r}, max |x' - x| "
          f"{float(np.abs(out.view(np.float32) - data.view(np.float32)).max())!r}")

    # The chain repair's last-outlier index, in the reference's form (a
    # cummax over the outlier mask) and the port's (a binary search in the
    # sorted outlier indices), on this container's outliers, CUDA events.
    n = h.n_elems
    oidx = dblob[h.sec_outliers : h.sec_outliers + 8 * h.n_outliers].clone().view(torch.int32)
    oidx = oidx[0::2].to(torch.int64)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[oidx] = True
    k = torch.arange(n, device=dev, dtype=torch.int64)

    def by_cummax():
        return torch.cummax(torch.where(mask, k, -1), 0).values

    def by_search():
        marks = torch.sort(oidx).values
        pos = torch.searchsorted(marks, k, right=True) - 1
        return torch.where(pos >= 0, marks[pos.clamp(min=0)], -1)

    t = {}
    for name, fn in (("cummax", by_cummax), ("search", by_search)):
        fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(3):
            fn()
        b.record()
        torch.cuda.synchronize()
        t[name] = a.elapsed_time(b) / 3
    if not torch.equal(by_cummax(), by_search()):
        fail("the chain repair's binary search differs from the cummax form")
    print(f"[time] {card} | chain repair, last-outlier index over {n} elements "
          f"({h.n_outliers} outliers): torch.cummax {t['cummax']:.4f} ms, sort + "
          f"searchsorted {t['search']:.4f} ms, equal")


def container_kernel_spec(stage_in) -> dict:
    """Phase 6 entries of the four container-stage kernels, at the shapes
    the main path gives them."""
    import torch

    from repro_torch.benchmarks.kernel_roofline import kernel_bytes_ops
    from repro_torch.kernels import lz_bitshuffle, lz_entropy

    buf, start, length = stage_in["hist"]
    gap_args, nbits = stage_in["gap"]
    nsub = gap_args[1].numel()
    units, shuffled = stage_in["units"], stage_in["shuffled"]
    n_units = units.numel()
    sh_out, un_out = torch.empty_like(shuffled), torch.empty_like(units)
    return {
        "byte_histogram": dict(
            kernel=lambda: lz_entropy.byte_histogram_cuda(buf, start, length),
            plain=lambda: lz_entropy.byte_histogram_plain(buf, start, length),
            library=lambda: torch.bincount(buf[start : start + length], minlength=256),
            cost=kernel_bytes_ops("byte_histogram", length=length),
            at=f"the {length}-byte payload section of the hurr-quant 128 MiB container",
            source="src/repro_torch/csrc/lz_entropy.cu",
            replaces="src/repro/kernels/lz_entropy.py:65"),
        "huffman_gap_decode": dict(
            kernel=lambda: lz_entropy.huffman_gap_decode_cuda(*gap_args, sub=SUB),
            plain=lambda: lz_entropy.huffman_gap_decode_plain(*gap_args, sub=SUB),
            plain_reps=1, library=None,
            cost=kernel_bytes_ops("huffman_gap_decode", nbits=nbits, nsub=nsub),
            at=f"the same payload section: {nsub} sub-blocks, {nbits} bits",
            source="src/repro_torch/csrc/lz_entropy.cu",
            replaces="src/repro/kernels/lz_entropy.py:118"),
        "bitshuffle": dict(
            kernel=lambda: lz_bitshuffle.bitshuffle_cuda(units, out=sh_out),
            plain=lambda: lz_bitshuffle.bitshuffle_plain(units),
            library=None, cost=kernel_bytes_ops("bitshuffle", n_units=n_units),
            at=f"{n_units} units ({n_units // 512} blocks: 128 MiB of f32 in quant mode)",
            source="src/repro_torch/csrc/lz_bitshuffle.cu",
            replaces="src/repro/kernels/lz_bitshuffle.py:32"),
        "bitunshuffle": dict(
            kernel=lambda: lz_bitshuffle.bitunshuffle_cuda(shuffled, out=un_out),
            plain=lambda: lz_bitshuffle.bitunshuffle_plain(shuffled),
            library=None, cost=kernel_bytes_ops("bitunshuffle", n_units=n_units),
            at=f"{n_units} units ({n_units // 512} blocks: 128 MiB of f32 in quant mode)",
            source="src/repro_torch/csrc/lz_bitshuffle.cu",
            replaces="src/repro/kernels/lz_bitshuffle.py:44"),
    }


if __name__ == "__main__":
    main()
