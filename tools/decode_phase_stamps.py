"""The LZSS decode chain's phases, timed by per-block clock stamps.

    python3 tools/decode_phase_stamps.py TREE [TREE ...]

For each TREE (the root of a checkout; unpack an earlier commit with ``git
archive`` into the git-ignored ``_scratch/``), copies its
``src/repro_torch/csrc`` into this checkout's git-ignored
``src/repro_torch/_build/decode_stamps/``, adds to the copy of
``decode_chunk.cuh`` a ``clock64`` stamp (after a ``__syncthreads``) at each
phase boundary of ``gplz::decode_chunk``, builds the split decoder
(``lz_decode.cu``) and the one-launch decoder (``lz_decode_mono.cu``) from
the copy with that tree's nvcc flags, and runs each six times on the
container of hurr-quant 128 MiB at ``LZSSConfig()`` (the first a warm-up),
checking every output against the input symbols.  It prints, per decoder,
the medians over the five timed launches of the mean cycles a block spends
in each phase:

  init    the chunk's rows set up (and, where the tree stages them, the
          sections copied to shared memory)
  tokens  each token's flag, read offset, length / offset / literal and
          write position (the block scans), literals written
  fill    every output position given its copy source
  rounds  the pointer-doubling rounds
  gather  each copied position's symbol read and the output written

with each phase's share of the block's time and the kernel's time by CUDA
events, instrumented and not.  Where a tree marks its phases with
``// -- <phase> --`` comment lines, the stamps go there; the parent's chain
(the pointer fill inside the token loop) is stamped at fixed lines of its
text, its fill timed between two added barriers.  The kernels in the
repository carry no instrumentation.  Needs a CUDA card and nvcc.
"""
import ctypes, importlib.util, pathlib, shutil, statistics, subprocess, sys
import torch

HERE = pathlib.Path(__file__).resolve().parents[1]
OUT = HERE / "src" / "repro_torch" / "_build" / "decode_stamps"
PHASES = ("init", "tokens", "fill", "rounds", "gather")
HEADER = r'''
__device__ long long* g_stamps;
extern "C" int set_stamps(void* p) { return cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)); }
#define GPLZ_T(k) do { __syncthreads(); if (threadIdx.x == 0) t_[k] = clock64(); } while (0)
#define GPLZ_END(fill) do { GPLZ_T(5); if (threadIdx.x == 0) { \
  long long* s_ = g_stamps + blockIdx.x * 8; s_[0] = t_[1] - t_[0]; \
  s_[1] = t_[2] - t_[1] - (fill); s_[2] = t_[3] - t_[2] + (fill); \
  s_[3] = t_[4] - t_[3]; s_[4] = t_[5] - t_[4]; s_[5] = 1; } } while (0)
'''


def instrument(src: str) -> str:
    src = src.replace("namespace gplz {", HEADER + "\nnamespace gplz {", 1)
    end = "\n}\n\n}  // namespace gplz"
    assert src.count(end) == 1, "decode_chunk must close the namespace"
    markers = [f"// -- {p} --" for p in PHASES]
    if all(src.count(m) == 1 for m in markers):
        for k, m in enumerate(markers):
            decl = "long long t_[8] = {0};\n  " if k == 0 else ""
            src = src.replace(m, decl + f"GPLZ_T({k});\n  " + m, 1)
        return src.replace(end, "\n  GPLZ_END(0);" + end, 1)
    # the parent's chain: init, the token tiles with the fill inside, rounds, gather
    anchors = [
        ("int32_t* __restrict__ o) {\n", "int32_t* __restrict__ o) {\n  long long t_[8] = {0}, fill_ = 0; GPLZ_T(0);\n"),
        ("  const int ps = C * S;\n", "  GPLZ_T(1);\n  const int ps = C * S;\n"),
        ("    if (ln > 0 && wpos < C) {\n", "    GPLZ_T(7);\n    if (ln > 0 && wpos < C) {\n"),
        ("        o[wpos] = static_cast<int32_t>(lit);\n      }\n    }\n",
         "        o[wpos] = static_cast<int32_t>(lit);\n      }\n    }\n"
         "    __syncthreads(); if (threadIdx.x == 0) fill_ += clock64() - t_[7];\n"),
        ("  for (int r = 0; r < rounds; ++r) {\n", "  GPLZ_T(2); t_[3] = t_[2];\n  for (int r = 0; r < rounds; ++r) {\n"),
        ("  // literal writes above and these reads are ordered by the barrier\n",
         "  GPLZ_T(4);\n  // literal writes above and these reads are ordered by the barrier\n"),
    ]
    for a, b in anchors:
        assert src.count(a) == 1, a
        src = src.replace(a, b, 1)
    return src.replace(end, "\n  GPLZ_END(fill_);" + end, 1)


def load_build(tree: pathlib.Path, k: int):
    spec = importlib.util.spec_from_file_location(f"stamps_build_{k}", tree / "src/repro_torch/kernels/_build.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def main():
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch import core
    from repro_torch.core import deflate, format as fmt, pipeline as pl
    from repro_torch.data import datasets
    from repro_torch.kernels import lz_decode_mono

    cfg = core.LZSSConfig()
    s, c = cfg.symbol_size, cfg.chunk_symbols
    raw = torch.from_numpy(datasets.load("hurr-quant", 128 << 20)).cuda()
    sym = pl.pack_symbols(raw, s).reshape(-1, c)
    nc = sym.shape[0]
    buf, total = pl.compress_chunks(sym, cfg)
    blob = buf[:total].contiguous()
    _, nt, ps = fmt.validate_container(blob.cpu().numpy())
    nt, ps = torch.from_numpy(nt).cuda(), torch.from_numpy(ps).cuda()
    fs, p64 = (nt.to(torch.int64) + 7) // 8, ps.to(torch.int64)
    sec = fmt.HEADER_BYTES + 8 * nc
    flags = deflate.gather_section(blob, sec, fs, torch.cumsum(fs, 0) - fs, c // 8).contiguous()
    pay = deflate.gather_section(blob, sec + int(fs.sum()), p64, torch.cumsum(p64, 0) - p64, c * s).contiguous()
    fofs, pofs = (t.contiguous() for t in lz_decode_mono.section_starts(nt[None], ps[None]))
    # a tree's one-launch decoder takes either these section starts or one
    # cumsum of the flag and then the payload sizes, with the flag offset
    cums = torch.cumsum(torch.cat([(nt + 7) >> 3, ps])[None], 1, dtype=torch.int64)
    out = torch.empty(nc, c, dtype=torch.int32, device="cuda")
    stamps = torch.zeros(nc * 8, dtype=torch.int64, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    want = sym.to(torch.int32)

    def args(name, sig):
        if name == "lz_decode":
            return (flags.data_ptr(), pay.data_ptr(), nt.data_ptr(), nc, c, s, out.data_ptr(), st)
        starts = (cums.data_ptr(), sec) if sig[7] is ctypes.c_longlong else (fofs.data_ptr(), pofs.data_ptr())
        return (blob.data_ptr(), total, 1, nc, nt.data_ptr(), ps.data_ptr(), *starts, c, s,
                out.data_ptr(), st)

    def event_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    OUT.mkdir(parents=True, exist_ok=True)
    for k, tree in enumerate(sys.argv[1:]):
        root = pathlib.Path(tree).resolve()
        build = load_build(root, k)
        plain_libs = build.build_all()
        work = OUT / f"tree{k}"
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(root / "src/repro_torch/csrc", work)
        (work / "decode_chunk.cuh").write_text(instrument((work / "decode_chunk.cuh").read_text()))
        procs = {n: subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-I", str(work), "-o", str(work / f"{n}.so"),
                                      str(work / f"{n}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for n in ("lz_decode", "lz_decode_mono")}
        for n, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                print(log)
                sys.exit(1)
        print(f"[stamps] tree {k} = {root}")
        for n in ("lz_decode", "lz_decode_mono"):
            lib = ctypes.CDLL(str(work / f"{n}.so"))
            fn = getattr(lib, f"{n}_launch")
            fn.argtypes = build.SIGNATURES[n][f"{n}_launch"]
            lib.set_stamps.argtypes = [ctypes.c_void_p]
            assert lib.set_stamps(stamps.data_ptr()) == 0
            plain_fn = getattr(plain_libs[n], f"{n}_launch")
            rows = []
            for rep in range(6):
                stamps.zero_()
                out.fill_(-1)
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                code = fn(*args(n, fn.argtypes))
                b.record()
                torch.cuda.synchronize()
                assert code == 0, code
                assert torch.equal(out, want), f"instrumented {n} of tree {k} does not decode"
                d = stamps.view(nc, 8)[:, :5].double()
                assert int(stamps.view(nc, 8)[:, 5].sum()) == nc
                rows.append([a.elapsed_time(b)] + d.mean(0).tolist())
            out.fill_(-1)
            t_plain = event_ms(lambda: plain_fn(*args(n, fn.argtypes)))
            torch.cuda.synchronize()
            assert torch.equal(out, want), f"{n} of tree {k} does not decode"
            med = [statistics.median(r[j] for r in rows[1:]) for j in range(6)]
            blk = sum(med[1:])
            print(f"[stamps] {n}: kernel {t_plain:.4f} ms, instrumented {med[0]:.4f} ms; mean cycles a "
                  f"block: " + ", ".join(f"{p} {v:.0f} ({v / blk:.1%})" for p, v in zip(PHASES, med[1:]))
                  + f"; block total {blk:.0f}")


if __name__ == "__main__":
    main()
