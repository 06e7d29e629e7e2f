"""Kernel II (the global prefix sums) of several source trees, timed in turns
on one card.

    python3 tools/ab_offsets.py TREE0 TREE1 [TREE2 ...]

Each TREE is the root of a checkout (for an earlier commit, unpack
``git archive <commit>`` into the git-ignored ``_scratch/``).  Builds each
tree's CUDA libraries with that tree's own ``_build.py``, then:

  1. checks every tree's Kernel II (through the tree's own wrapper, and
     through its C entry point where the inputs start at one residue mod
     16, the outputs then given the same) against this checkout's plain
     version on the edge inputs of ``repro_torch/data/offsets_edges.py``
     (every kind at every nc and row count) and on views of them at 4, 8
     and 12 bytes past a 16-byte boundary;
  2. times Kernel II at nc = 32,768 (the hurr-quant 128 MiB input's Kernel I
     outputs, one row), 8 rows of 2,048 and one row of 262,144 (random
     sizes): alone (the C entry into preallocated outputs) and through the
     tree's wrapper, in the order 0..N-1, N-1..0, three times, beside
     ``torch.cumsum``
     of the same (2, rows, nc) sizes, a one-element ``x.add_(1)`` launched
     back to back (the launch floor) and a device-to-device copy moving as
     many bytes as the kernel's bound counts.  Launched back to back from
     Python, a small kernel's time is the host's time to issue it; so the
     kernel alone, the add and the copy are also timed as 20 launches
     captured in a CUDA graph and replayed ("graph"), which leaves the
     card's own time a launch, its gap to the next launch included.

CUDA events throughout; every line carries the card's name and power limit.
Needs a CUDA card and nvcc.
"""
import importlib.util
import pathlib
import statistics
import subprocess
import sys

import torch

trees = [pathlib.Path(t).resolve() for t in sys.argv[1:]]
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import core  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.data import datasets, offsets_edges as edges  # noqa: E402
from repro_torch.kernels import lz_match, lz_scatter  # noqa: E402

from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(f"[ab] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
dev = torch.device("cuda")
st = torch.cuda.current_stream().cuda_stream


def load(path, name, build=None):
    spec = importlib.util.spec_from_file_location(name, path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    if build is not None:
        m._build = build  # the wrapper launches the tree's own library
    return m


libs, wrappers = [], []
for k, t in enumerate(trees):
    b = load(t / "src/repro_torch/kernels/_build.py", f"build_{k}")
    libs.append(b.build_all()["lz_scatter"])
    wrappers.append(load(t / "src/repro_torch/kernels/lz_scatter.py", f"scatter_{k}", b))
    print(f"[ab] {card} | tree {k} = {t}")
    for ln in b.ptxas_report().get("lz_scatter", []):
        if "Used" in ln or "spill" in ln:
            print(f"[ab] {card} | lz_scatter: {ln}")
    if hasattr(wrappers[-1], "global_offsets_occupancy"):
        r, n = wrappers[-1].global_offsets_occupancy()
        print(f"[ab] {card} | global_offsets {r} registers a thread, {n} resident blocks per SM")


def launch(k, nt, ps, out, stream=None):
    rows, nc = nt.shape
    return libs[k].lz_global_offsets_launch(nt.data_ptr(), ps.data_ptr(), rows, nc,
                                            *(o.data_ptr() for o in out), stream or st)


# ------------------------------------------------------------- 1. edges
bad = cases = 0


def check(nt, ps, label):
    global bad, cases
    want = lz_scatter.global_offsets_plain(nt, ps)
    at = nt.data_ptr() % 16
    for k in range(len(trees)):
        via = wrappers[k].global_offsets_cuda(nt, ps)
        ok, code = all(torch.equal(v, w) for v, w in zip(via, want)), 0
        if ps.data_ptr() % 16 == at:  # the C entry takes its four arrays at one residue
            out = tuple(edges.view_at(torch.full_like(w, -7), at) for w in want)
            code = launch(k, nt, ps, out)
            torch.cuda.synchronize()
            ok = ok and all(torch.equal(a, w) for a, w in zip(out, want))
        if code or not ok:
            print(f"[ab] {card} | MISMATCH tree {k} Kernel II on {label} (code {code})")
            bad += 1
    cases += 1


for kind, rows, nc in edges.edge_cases():
    nt, ps = (torch.from_numpy(a).to(dev) for a in edges.offsets_inputs(kind, rows, nc))
    check(nt, ps, f"{kind} rows={rows} nc={nc}")
for shift in edges.VIEW_BYTES:
    for kind, rows, nc in (("random", 3, 1025), ("ragged", 8, 33), ("random", 1, 32769)):
        nt, ps = (torch.from_numpy(a).to(dev) for a in edges.offsets_inputs(kind, rows, nc))
        vt, vp = edges.view_at(nt, shift), edges.view_at(ps, shift)
        for a, b in ((vt, vp), (vt, ps), (nt, vp)):
            check(a, b, f"views at {shift} bytes, {kind} rows={rows} nc={nc}")
print(f"[ab] {card} | Kernel II edges ({cases} cases, {len(trees)} trees, C entry and wrapper): "
      f"{bad} mismatches")


# ------------------------------------------------------------- 2. times
def ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def ms_graph(fn, reps=20, replays=10):
    """Time a launch as ``reps`` launches of ``fn(stream)`` captured in a
    CUDA graph, replayed ``replays`` times."""
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(side.cuda_stream)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        cap = torch.cuda.current_stream().cuda_stream
        for _ in range(reps):
            fn(cap)
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * replays)


cfg = core.LZSSConfig()
raw = torch.from_numpy(datasets.load("hurr-quant", 128 << 20)).to(dev)
sym = pl.pack_symbols(raw, cfg.symbol_size).reshape(-1, cfg.chunk_symbols)
k1 = lz_match.lz_kernel1_cuda(sym, window=cfg.window, min_match=cfg.min_match,
                              symbol_size=cfg.symbol_size)
shapes = [("hurr-quant 128 MiB", k1["n_tokens"][None], k1["payload_sizes"][None])]
for rows, nc in ((8, 2048), (1, 262144)):
    nt, ps = (torch.from_numpy(a).to(dev) for a in edges.offsets_inputs("random", rows, nc))
    shapes.append((f"{rows} rows of {nc} (random sizes)", nt, ps))
one = torch.zeros(1, dtype=torch.int32, device=dev)
order = list(range(len(trees))) + list(reversed(range(len(trees))))
for label, nt, ps in shapes:
    rows, nc = nt.shape
    check(nt, ps, label)
    outs = [tuple(torch.empty_like(w) for w in lz_scatter.global_offsets_plain(nt, ps))
            for _ in trees]
    both = torch.stack([nt, ps])
    nbytes = 16 * rows * nc + 8 * rows
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    modes = ("alone", "alone graph", "wrapper")
    t = {m: {k: [] for k in range(len(trees))} for m in modes}
    lib_t, floor_t, copy_t, floor_g, copy_g = [], [], [], [], []
    for _ in range(3):
        for k in order:
            t["alone"][k].append(ms(lambda: launch(k, nt, ps, outs[k])))
            t["alone graph"][k].append(ms_graph(lambda s: launch(k, nt, ps, outs[k], s)))
            t["wrapper"][k].append(ms(lambda: wrappers[k].global_offsets_cuda(nt, ps)))
        lib_t.append(ms(lambda: torch.cumsum(both, 2)))
        floor_t.append(ms(lambda: one.add_(1)))
        copy_t.append(ms(lambda: dst.copy_(src)))
        floor_g.append(ms_graph(lambda s: one.add_(1)))
        copy_g.append(ms_graph(lambda s: dst.copy_(src)))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    for mode, tm in t.items():
        cells = [f"tree {k} {statistics.mean(v):.4f} ms (turns {min(v):.4f}-{max(v):.4f})"
                 for k, v in tm.items()]
        print(f"[ab] {card} | Kernel II {mode}, {label}: " + "; ".join(cells))
    print(f"[ab] {card} | beside Kernel II at {label}: torch.cumsum of the (2, {rows}, {nc}) "
          f"sizes {statistics.mean(lib_t):.4f} ms; x.add_(1) {statistics.mean(floor_t):.4f} ms "
          f"(graph {statistics.mean(floor_g):.4f}); D2D copy moving as many bytes "
          f"({src.numel()} read, as many written) {statistics.mean(copy_t):.4f} ms (graph "
          f"{statistics.mean(copy_g):.4f}); bound {bound:.5f} ms ({nbytes} bytes)")
