"""Kernel III and the byte histogram of several source trees, timed in turns
on one card.

    python3 tools/ab_scatter.py TREE0 TREE1 [TREE2 ...]

Each TREE is the root of a checkout (for an earlier commit, unpack
``git archive <commit>`` into the git-ignored ``_scratch/``).  Builds each
tree's CUDA libraries with that tree's own ``_build.py``, then:

  1. checks every tree's Kernel III and histogram (through the C entry
     points, and through each tree's own wrappers) against this checkout's
     plain versions on the edge inputs of ``repro_torch/data/scatter_edges.py``
     (every kind at every geometry, both layouts; every byte pattern at
     every (start, length) of the ranges, 64 MiB of one value) and on the
     hurr-quant 128 MiB container's two sections;
  2. times Kernel III at hurr-quant 128 MiB (nc = 32,768, C = 2048, S = 2):
     alone (the C entry into a preallocated blob) and through the tree's
     wrapper (its copies and its zeroed blob included), in the order
     0..N-1, N-1..0, three times, beside a device-to-device copy that moves
     as many bytes (read and written) as the kernel's bound counts;
  3. times the histogram on the container's payload section, its flag
     section and a payload-sized section of one value (0x7F), with the L2
     hot (launches back to back) and cold (a 128 MiB write before each
     launch, each launch timed alone), in turns, beside ``torch.bincount``,
     and prints the spread of each tree's times over the turns.

CUDA events throughout; every line carries the card's name and power limit.
Needs a CUDA card and nvcc.
"""
import importlib.util
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

trees = [pathlib.Path(t).resolve() for t in sys.argv[1:]]
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import core  # noqa: E402
from repro_torch.core import format as fmt, pipeline as pl  # noqa: E402
from repro_torch.data import datasets, scatter_edges as edges  # noqa: E402
from repro_torch.kernels import lz_entropy, lz_match, lz_scatter  # noqa: E402

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
    built = b.build_all()
    libs.append((built["lz_scatter"], built["lz_entropy"]))
    wrappers.append((load(t / "src/repro_torch/kernels/lz_scatter.py", f"scatter_{k}", b),
                     load(t / "src/repro_torch/kernels/lz_entropy.py", f"entropy_{k}", b)))
    print(f"[ab] tree {k} = {t}")
    for src in ("lz_scatter", "lz_entropy"):
        for ln in b.ptxas_report().get(src, []):
            if "Used" in ln:
                print(f"[ab]   {src}: {ln}")
    if hasattr(wrappers[-1][0], "scatter_occupancy"):
        print(f"[ab]   Kernel III at C=2048 S=2: "
              f"{wrappers[-1][0].scatter_occupancy(chunk_symbols=2048, symbol_size=2)}")
    if hasattr(wrappers[-1][1], "histogram_occupancy"):
        r, n = wrappers[-1][1].histogram_occupancy()
        print(f"[ab]   byte_histogram {r} registers a thread, {n} resident blocks per SM")


def scatter_launch(k, args, rows, nc, c, s, mm, sec, cap, blob):
    return libs[k][0].lz_scatter_launch(*[a.data_ptr() for a in args], rows, nc, c, s, mm, sec,
                                        cap, blob.data_ptr(), st)


def hist_launch(k, buf, start, length, out):
    return libs[k][1].lz_byte_histogram_launch(buf.data_ptr(), start, length, out.data_ptr(), st)


def kernel3_args(x, fo, po):
    t = {n: torch.as_tensor(x[n]).to(dev) for n in
         ("symbols", "lengths", "offsets", "emitted", "local_off")}
    return [t["symbols"], t["lengths"], t["offsets"], t["emitted"].to(torch.uint8),
            t["local_off"], torch.as_tensor(fo).to(dev), torch.as_tensor(po).to(dev)]


# ------------------------------------------------------------- 1. edges
bad = 0
for c, s in edges.GEOMETRIES:
    nc = edges.chunks_for(c)
    mm = edges.min_match(s)
    cap = fmt.max_compressed_bytes(nc * c * s, s, c)
    sec = fmt.HEADER_BYTES + 8 * nc
    for i, kind in enumerate(edges.KINDS):
        x = edges.scatter_inputs(kind, 2, nc, c, s, seed=17 * c + 5 * s + i)
        fo, po = edges.section_offsets(x["n_tokens"], x["payload_sizes"])
        args = kernel3_args(x, fo, po)
        want = lz_scatter.scatter_plain(*args[:3], args[3].bool(), *args[4:], symbol_size=s,
                                        min_match=mm, cap=cap, sec_flags=sec)
        for k in range(len(trees)):
            blob = torch.zeros(2, cap, dtype=torch.uint8, device=dev)
            code = scatter_launch(k, args, 2, nc, c, s, mm, sec, cap, blob)
            via = wrappers[k][0].scatter_cuda(*args[:3], args[3].bool(), *args[4:], symbol_size=s,
                                              min_match=mm, cap=cap, sec_flags=sec)
            if code or not (torch.equal(blob, want) and torch.equal(via, want)):
                print(f"[ab] MISMATCH tree {k} Kernel III on {kind} at C={c} S={s} (code {code})")
                bad += 1
print(f"[ab] Kernel III edges ({len(edges.GEOMETRIES)} geometries x {len(edges.KINDS)} kinds, "
      f"2 rows): {bad} mismatches")
bad = 0
cases = [(edges.histogram_bytes(p, 64, seed=3), r) for p in edges.HIST_PATTERNS
         for r in edges.RANGES]
big = edges.histogram_bytes("one-value", edges.BIG_BYTES)
cases += [(big, (0, big.size)), (big, (3, big.size - 20))]
for buf_np, (start, length) in cases:
    buf = torch.from_numpy(buf_np).to(dev)
    want = torch.from_numpy(np.bincount(buf_np[start : start + length], minlength=256)
                            .astype(np.int32)).to(dev)
    if buf_np.size < 4096 and not torch.equal(
            want, lz_entropy.byte_histogram_plain(buf, start, length)):
        print("[ab] the plain histogram differs from np.bincount")
        bad += 1
    for k in range(len(trees)):
        out = torch.zeros(256, dtype=torch.int32, device=dev)
        code = hist_launch(k, buf, start, length, out)
        via = wrappers[k][1].byte_histogram_cuda(buf, start, length)
        if code or not (torch.equal(out, want) and torch.equal(via, want)):
            print(f"[ab] MISMATCH tree {k} histogram on {buf_np.size} bytes [{start}, +{length})")
            bad += 1
print(f"[ab] histogram edges ({len(cases)} ranges, 64 MiB of one value among them): "
      f"{bad} mismatches")

# -------------------------------------------------- the main path's inputs
cfg = core.LZSSConfig()
s, w, c = cfg.symbol_size, cfg.window, cfg.chunk_symbols
raw = torch.from_numpy(datasets.load("hurr-quant", 128 << 20)).to(dev)
sym = pl.pack_symbols(raw, s).reshape(-1, c)
nc = sym.shape[0]
k1 = lz_match.lz_kernel1_cuda(sym, window=w, min_match=cfg.min_match, symbol_size=s)
fo, po, tot = lz_scatter.global_offsets_cuda(k1["n_tokens"][None], k1["payload_sizes"][None])
cap = fmt.max_compressed_bytes(nc * c * s, s, c)
sec = fmt.HEADER_BYTES + 8 * nc
wargs = [sym[None]] + [k1[n][None] for n in ("lengths", "offsets", "emitted", "local_off")]
wargs += [fo, po]
kw3 = dict(symbol_size=s, min_match=cfg.min_match, cap=cap, sec_flags=sec)
cargs = [a.contiguous() for a in wargs]
cargs[3] = cargs[3].view(torch.uint8)
want = lz_scatter.scatter_plain(*wargs, **kw3)
flag_total, pay_total = (int(v) for v in tot[0].tolist())
blobs = [torch.zeros(1, cap, dtype=torch.uint8, device=dev) for _ in trees]
for k in range(len(trees)):
    assert scatter_launch(k, cargs, 1, nc, c, s, cfg.min_match, sec, cap, blobs[k]) == 0
    torch.cuda.synchronize()
    if not (torch.equal(blobs[k], want) and torch.equal(wrappers[k][0].scatter_cuda(*wargs, **kw3),
                                                        want)):
        print(f"[ab] MISMATCH tree {k} Kernel III at hurr-quant 128 MiB")
container = want[0, : sec + flag_total + pay_total]
sections = {"payload": (sec + flag_total, pay_total), "flags": (sec, flag_total)}
one_value = torch.full((pay_total,), 0x7F, dtype=torch.uint8, device=dev)
for name, (start, length) in sections.items():
    ref = torch.bincount(container[start : start + length], minlength=256).to(torch.int32)
    for k in range(len(trees)):
        if not torch.equal(wrappers[k][1].byte_histogram_cuda(container, start, length), ref):
            print(f"[ab] MISMATCH tree {k} histogram on the {name} section")
print(f"[ab] timed inputs checked: hurr-quant 128 MiB, nc={nc} C={c} S={s}, container "
      f"{container.numel()} bytes (flags {flag_total}, payload {pay_total})")


def ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)


def ms_cold(fn, reps=10):
    """Each launch timed alone after a 128 MiB write, so that its inputs are
    not in the 50 MB L2."""
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
    return statistics.mean(a.elapsed_time(b) for a, b in evs)


order = list(range(len(trees))) + list(reversed(range(len(trees))))

# ------------------------------------------------------- 2. Kernel III
bound_bytes = 17 * nc * c + 8 * nc + cap
half = torch.empty(bound_bytes // 2, dtype=torch.uint8, device=dev)
half2 = torch.empty_like(half)
t_alone = {k: [] for k in range(len(trees))}
t_wrap = {k: [] for k in range(len(trees))}
copy = []
for _ in range(3):
    for k in order:
        t_alone[k].append(ms(lambda: scatter_launch(k, cargs, 1, nc, c, s, cfg.min_match, sec,
                                                    cap, blobs[k])))
        t_wrap[k].append(ms(lambda: wrappers[k][0].scatter_cuda(*wargs, **kw3)))
    copy.append(ms(lambda: half2.copy_(half)))
bound = bound_bytes / HBM_BYTES_PER_S * 1e3
for label, t in (("alone", t_alone), ("through the wrapper", t_wrap)):
    base = statistics.mean(t[0])
    print(f"[ab] {card} | Kernel III {label}, hurr-quant 128 MiB: " + "; ".join(
        f"tree {k} {statistics.mean(v):.4f} ms ({statistics.mean(v) / base:.3f}, "
        f"{bound / statistics.mean(v):.0%} of the bound)" for k, v in t.items())
        + f"; bound {bound:.4f} ms ({bound_bytes} bytes); D2D copy moving as many bytes "
        f"({half.numel()} read, as many written) {statistics.mean(copy):.4f} ms")

# ---------------------------------------------------------- 3. histogram
hist_inputs = {
    "payload section": (container, *sections["payload"]),
    "flag section": (container, *sections["flags"]),
    "one value (0x7F), payload-sized": (one_value, 0, pay_total),
}
outs = [torch.zeros(256, dtype=torch.int32, device=dev) for _ in trees]
for label, (buf, start, length) in hist_inputs.items():
    bound = (length + 4 * 256) / HBM_BYTES_PER_S * 1e3
    for mode, timer, turns in (("hot", ms, 12), ("cold", ms_cold, 12)):
        t = {k: [] for k in range(len(trees))}
        lib = []
        for _ in range(turns // 2):
            for k in order:
                t[k].append(timer(lambda: hist_launch(k, buf, start, length, outs[k])))
            lib.append(timer(lambda: torch.bincount(buf[start : start + length], minlength=256)))
        base = statistics.mean(t[0])
        print(f"[ab] {card} | byte_histogram {mode}, {label} ({length} bytes): " + "; ".join(
            f"tree {k} {statistics.mean(v):.4f} ms ({statistics.mean(v) / base:.3f}, "
            f"{bound / statistics.mean(v):.0%} of the bound; turns {min(v):.4f}-{max(v):.4f})"
            for k, v in t.items()) + f"; torch.bincount {statistics.mean(lib):.4f} ms; "
            f"bound {bound:.4f} ms")
        wt = {k: [] for k in range(len(trees))}
        for _ in range(2):
            for k in order:
                wt[k].append(timer(lambda: wrappers[k][1].byte_histogram_cuda(buf, start, length)))
        print(f"[ab] {card} | byte_histogram {mode} through the wrapper, {label}: " + "; ".join(
            f"tree {k} {statistics.mean(v):.4f} ms" for k, v in wt.items()))
