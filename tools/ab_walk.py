"""The walking kernels of several source trees, timed in turns on one card.

    python3 tools/ab_walk.py TREE0 TREE1 [TREE2 ...]

Each TREE is the root of a checkout (for an earlier commit, unpack
``git archive <commit>`` into a git-ignored directory of this checkout).
Builds each tree's CUDA libraries with that tree's own ``_build.py``;
checks every tree's match-only kernel against the plain matcher on the
walk's edge inputs (``repro_torch/data/walk_edges.py``) and the outputs of
every tree's ``lz_match``, ``lz_kernel1`` and ``lz_fused_mono`` against
TREE0's on hurr-quant 128 MiB at ``LZSSConfig()``, all-equal symbols and
two-symbol noise; then times the three kernels on those inputs in the order
0..N-1, N-1..0, three times (CUDA events) and prints each tree's mean and
its ratio to TREE0's.  Needs a CUDA card and nvcc.
"""
import importlib.util, pathlib, statistics, sys
import torch

trees = [pathlib.Path(t).resolve() for t in sys.argv[1:]]
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
from repro_torch import core
from repro_torch.core import format as fmt, pipeline as pl
from repro_torch.data import datasets, walk_edges
from repro_torch.kernels import lz_match as plain_match

libs = []
for k, t in enumerate(trees):
    spec = importlib.util.spec_from_file_location(f"build_{k}", t / "src/repro_torch/kernels/_build.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    libs.append(m.build_all())
    print(f"[ab] tree {k} = {t}")
    for ln in m.ptxas_report().get("lz_match", []) + m.ptxas_report().get("lz_fused", []):
        if "Used" in ln:
            print(f"[ab]   {ln}")
st = torch.cuda.current_stream().cuda_stream


def match(k, x, s, w):
    n, c = x.shape
    L, O = torch.empty(n, c, dtype=torch.int32, device="cuda"), torch.empty(n, c, dtype=torch.int32, device="cuda")
    assert libs[k]["lz_match"].lz_match_launch(x.data_ptr(), n, c, s, w, L.data_ptr(), O.data_ptr(), st) == 0
    return L, O


bad = 0
for kind in walk_edges.KINDS:
    for s, w, c, nc in ((1, 1, 2048, 8), (2, 128, 2048, 8), (4, 255, 2048, 8), (2, 255, 520, 4),
                        (4, 128, 38568, 2), (1, 255, 57856, 2)):
        x = torch.from_numpy(walk_edges.walk_edge_symbols(kind, nc, c, s, w)).cuda()
        want = plain_match.lz_match_plain(x, window=w, symbol_size=s)
        for k in range(len(trees)):
            got = match(k, x, s, w)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                print(f"[ab] MISMATCH tree {k} on {kind} S={s} W={w} C={c}")
                bad += 1
print(f"[ab] walk edges vs plain: {bad} mismatches")

cfg = core.LZSSConfig()
s, w, c, mm = cfg.symbol_size, cfg.window, cfg.chunk_symbols, cfg.min_match
raw = torch.from_numpy(datasets.load("hurr-quant", 128 << 20)).cuda()
hq = pl.pack_symbols(raw, s).reshape(-1, c).contiguous()
nc = hq.shape[0]
inputs = {
    "hurr-quant": hq,
    "all-equal": torch.zeros_like(hq),
    "two-symbol noise": torch.randint(0, 2, hq.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(0), dtype=torch.int32),
}
cap = fmt.max_compressed_bytes(nc * c * s, s, c)
sec = fmt.HEADER_BYTES + 8 * nc
i32 = dict(dtype=torch.int32, device="cuda")
L, O, LO = (torch.empty(nc, c, **i32) for _ in range(3))
E = torch.empty(nc, c, dtype=torch.uint8, device="cuda")
PS, NT = torch.empty(nc, **i32), torch.empty(nc, **i32)
ticket = torch.zeros(1 + 2 * -(-nc // 256), **i32)
stage = torch.empty(nc * (c // 8 + c * s) + 16, dtype=torch.uint8, device="cuda")
fo, po = torch.empty(nc, **i32), torch.empty(nc, **i32)
blob = torch.empty(1, cap, dtype=torch.uint8, device="cuda")
nt1, ps1, tot = torch.empty(1, nc, **i32), torch.empty(1, nc, **i32), torch.empty(1, 2, **i32)


def run(k, name, x):
    lib = libs[k]
    if name == "lz_match":
        return lib["lz_match"].lz_match_launch(x.data_ptr(), nc, c, s, w, L.data_ptr(), O.data_ptr(), st)
    if name == "lz_kernel1":
        return lib["lz_match"].lz_kernel1_launch(x.data_ptr(), nc, c, s, w, mm, L.data_ptr(), O.data_ptr(), E.data_ptr(), LO.data_ptr(), PS.data_ptr(), NT.data_ptr(), st)
    ticket.zero_()
    return lib["lz_fused"].lz_fused_mono_launch(x.data_ptr(), 1, nc, c, s, w, mm, sec, cap, ticket.data_ptr(), stage.data_ptr(), fo.data_ptr(), po.data_ptr(), blob.data_ptr(), nt1.data_ptr(), ps1.data_ptr(), tot.data_ptr(), st)


def outputs(k, name, x):
    assert run(k, name, x) == 0
    torch.cuda.synchronize()
    if name == "lz_match":
        return [L.clone(), O.clone()]
    if name == "lz_kernel1":
        return [L.clone(), O.clone(), E.clone(), LO.clone(), PS.clone(), NT.clone()]
    return [blob.clone(), nt1.clone(), ps1.clone(), tot.clone()]


def ms(k, name, x, reps):
    run(k, name, x)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        run(k, name, x)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


names = ("lz_match", "lz_kernel1", "lz_fused_mono")
for label, x in inputs.items():
    for name in names:
        ref = outputs(0, name, x)
        for k in range(1, len(trees)):
            if not all(torch.equal(p, q) for p, q in zip(ref, outputs(k, name, x))):
                print(f"[ab] MISMATCH tree {k} vs tree 0: {label} {name}")
print("[ab] outputs compared with tree 0")
order = list(range(len(trees))) + list(reversed(range(len(trees))))
for label, x in inputs.items():
    for name in names:
        t = {k: [] for k in range(len(trees))}
        for _ in range(3):
            for k in order:
                t[k].append(ms(k, name, x, 5 if label != "all-equal" else 20))
        base = statistics.mean(t[0])
        print(f"[ab] {label} {name}: " + "; ".join(
            f"tree {k} {statistics.mean(v):.4f} ms ({statistics.mean(v) / base:.3f})" for k, v in t.items()))
