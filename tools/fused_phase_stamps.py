"""The one-launch compressor's phases, timed by globaltimer stamps.

    python3 tools/fused_phase_stamps.py TREE [TREE ...]

For each TREE (the root of a checkout), writes an instrumented copy of its
``csrc/lz_fused.cu`` (a stamp of every block's ``%globaltimer`` at the
kernel's start, around its two ``grid.sync()``s and at its end) into this
checkout's git-ignored ``src/repro_torch/_build/phase_stamps/``, builds it
with that tree's nvcc flags, runs it six times on hurr-quant 128 MiB at
``LZSSConfig()`` (the first a warm-up), checks its container against the
tree's own kernel, and prints per launch and as medians: phase A (last
block's end of A minus the first start), when the first block finished A,
each barrier's wait, phase B and phase C (last end minus first start).  The
kernel in the repository carries no instrumentation.  Needs a CUDA card.
"""
import ctypes, pathlib, subprocess, sys, statistics
import torch

OUT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "_build" / "phase_stamps"


def instrument(src: str) -> str:
    stamp = lambda k: (f"if (threadIdx.x == 0) {{ unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
                       f"g_stamps[blockIdx.x * 6 + {k}] = t_; }}")
    src = src.replace("namespace cg = cooperative_groups;",
                      "namespace cg = cooperative_groups;\n__device__ unsigned long long* g_stamps;\n"
                      "extern \"C\" int set_stamps(void* p) { return cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)); }", 1)
    a = "  cg::grid_group grid = cg::this_grid();"
    assert src.count(a) == 1
    src = src.replace(a, a + "\n  " + stamp(0))
    parts = src.split("  grid.sync();\n")
    assert len(parts) == 3, len(parts)
    src = parts[0] + "  " + stamp(1) + "\n  grid.sync();\n  " + stamp(2) + "\n" + parts[1] + \
        "  " + stamp(3) + "\n  grid.sync();\n  " + stamp(4) + "\n" + parts[2]
    # the kernel's end: the last zero_bytes of phase C closes two scopes
    for end in ("    zero_bytes(row + live, cap - live, tid, stride);\n  }\n}",
                "    warp_copy(section + pay_off[chunk], stage_pay + chunk * C * S, payload_sizes[chunk], lane);\n  }\n}"):
        if src.count(end) == 1:
            src = src.replace(end, end[:-1] + "  " + stamp(5) + "\n}")
            break
    else:
        raise SystemExit("kernel end not found")
    return src


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    for k, tree in enumerate(sys.argv[1:]):
        root = pathlib.Path(tree).resolve()
        sys.path.insert(0, str(root / "src"))
        for m in [m for m in sys.modules if m.startswith("repro_torch")]:
            del sys.modules[m]
        from repro_torch import core
        from repro_torch.core import format as fmt, pipeline as pl
        from repro_torch.data import datasets
        from repro_torch.kernels import _build, lz_fused
        sys.path.pop(0)
        csrc = root / "src/repro_torch/csrc"
        cu = OUT / f"lz_fused_stamps_{k}.cu"
        cu.write_text(instrument((csrc / "lz_fused.cu").read_text()))
        so = OUT / f"lz_fused_stamps_{k}.so"
        log = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so), str(cu)],
                             capture_output=True, text=True)
        if log.returncode:
            print(log.stdout, log.stderr); sys.exit(1)
        lib = ctypes.CDLL(str(so))
        fn = lib.lz_fused_mono_launch
        fn.argtypes = _build.SIGNATURES["lz_fused"]["lz_fused_mono_launch"]
        lib.set_stamps.argtypes = [ctypes.c_void_p]
        cfg = core.LZSSConfig()
        s, w, c = cfg.symbol_size, cfg.window, cfg.chunk_symbols
        raw = torch.from_numpy(datasets.load("hurr-quant", 128 << 20)).cuda()
        sym = pl.pack_symbols(raw, s).reshape(1, -1, c)
        nc = sym.shape[1]
        cap = fmt.max_compressed_bytes(nc * c * s, s, c)
        sec = fmt.HEADER_BYTES + 8 * nc
        stamps = torch.zeros(200_000 * 6, dtype=torch.int64, device="cuda")
        assert lib.set_stamps(stamps.data_ptr()) == 0
        x = sym.reshape(nc, c).contiguous()
        want = lz_fused.lz_fused_mono_cuda(sym, window=w, min_match=cfg.min_match, symbol_size=s, cap=cap, sec_flags=sec)
        res = []
        for rep in range(6):
            i32 = dict(dtype=torch.int32, device="cuda")
            ticket = torch.zeros(1 + 2 * -(-nc // 256), **i32)
            stage = torch.empty(nc * (c // 8 + c * s) + 16, dtype=torch.uint8, device="cuda")
            fo, po = torch.empty(nc, **i32), torch.empty(nc, **i32)
            blob = torch.empty(1, cap, dtype=torch.uint8, device="cuda")
            nt, ps, tot = torch.empty(1, nc, **i32), torch.empty(1, nc, **i32), torch.empty(1, 2, **i32)
            stamps.zero_()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            code = fn(x.data_ptr(), 1, nc, c, s, w, cfg.min_match, sec, cap, ticket.data_ptr(), stage.data_ptr(),
                      fo.data_ptr(), po.data_ptr(), blob.data_ptr(), nt.data_ptr(), ps.data_ptr(), tot.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
            b.record()
            torch.cuda.synchronize()
            assert code == 0, code
            assert torch.equal(blob, want[0]), "instrumented kernel differs"
            st = stamps.view(-1, 6)
            st = st[st[:, 0] > 0].cpu().double() / 1e6  # ms
            t0 = st[:, 0].min()
            A = (st[:, 1].max() - t0).item()
            a_first = (st[:, 1].min() - t0).item()
            sync1 = (st[:, 2].min() - st[:, 1].max()).item()
            B = (st[:, 3].max() - st[:, 2].min()).item()
            sync2 = (st[:, 4].min() - st[:, 3].max()).item()
            C = (st[:, 5].max() - st[:, 4].min()).item()
            res.append((a.elapsed_time(b), A, a_first, sync1, B, sync2, C, st.shape[0]))
        print(f"[stamps] tree {tree}: per run (event ms, A, first block done in A, sync1, B, sync2, C, blocks)")
        for r in res[1:]:
            print("[stamps]   " + ", ".join(f"{v:.4f}" for v in r[:-1]) + f", {r[-1]}")
        med = [statistics.median(r[j] for r in res[1:]) for j in range(7)]
        print(f"[stamps] median: event {med[0]:.4f} ms; A {med[1]:.4f} (first block done at {med[2]:.4f}); "
              f"sync1 {med[3]:.4f}; B {med[4]:.4f}; sync2 {med[5]:.4f}; C {med[6]:.4f}")


if __name__ == "__main__":
    main()
