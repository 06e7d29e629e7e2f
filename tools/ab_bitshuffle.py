"""The bitshuffle pair of several source trees, timed in turns on one card.

    python3 tools/ab_bitshuffle.py TREE0 TREE1 [TREE2 ...]

Each TREE is the root of a checkout (for an earlier commit, unpack
``git archive <commit>`` into the git-ignored ``_scratch/``).  Builds each
tree's CUDA libraries with that tree's own ``_build.py``, then:

  1. checks every tree's ``bitshuffle`` and ``bitunshuffle`` (through the C
     entry points) against this checkout's plain versions on the edge inputs
     of ``repro_torch/data/bitshuffle_edges.py`` (every pattern at every
     block count, the one-hot map, 65,536 and 65,537 random blocks);
  2. times both kernels (CUDA events, launched directly into preallocated
     outputs, so no wrapper work is timed) in the order 0..N-1, N-1..0,
     three times, at 65,536 blocks: on the quant-mode units of hurr-field
     128 MiB at eb=1e-3 (what ``lossy-fz`` shuffles) and on random units;
     prints each tree's mean and its ratio to TREE0's, and beside them a
     device-to-device copy of the same bytes (``dst.copy_(src)``), the
     card's practical ceiling for a permutation of them.

Needs a CUDA card and nvcc.
"""
import importlib.util, pathlib, statistics, subprocess, sys
import ctypes
import numpy as np
import torch

trees = [pathlib.Path(t).resolve() for t in sys.argv[1:]]
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
from repro_torch import core
from repro_torch.core import bitshuffle, lossy
from repro_torch.data import bitshuffle_edges as edges, datasets
from repro_torch.kernels import lz_bitshuffle

card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(f"[ab] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
libs = []
for k, t in enumerate(trees):
    spec = importlib.util.spec_from_file_location(f"build_{k}", t / "src/repro_torch/kernels/_build.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    libs.append(m.build_all()["lz_bitshuffle"])
    print(f"[ab] tree {k} = {t}")
    for ln in m.ptxas_report().get("lz_bitshuffle", []):
        if "Used" in ln:
            print(f"[ab]   lz_bitshuffle: {ln}")
    if "lz_bitshuffle_occupancy" in m.SIGNATURES["lz_bitshuffle"]:
        occ = (ctypes.c_int * 4)()
        assert libs[-1].lz_bitshuffle_occupancy(ctypes.cast(occ, ctypes.c_void_p)) == 0
        print(f"[ab]   bitshuffle {occ[0]} registers, {occ[1]} CTAs per SM; "
              f"bitunshuffle {occ[2]} registers, {occ[3]} CTAs per SM")
dev = torch.device("cuda")
st = torch.cuda.current_stream().cuda_stream


def launch(k, unshuffle, src, nb, dst):
    lib = libs[k]
    fn = lib.lz_bitunshuffle_launch if unshuffle else lib.lz_bitshuffle_launch
    return fn(src.data_ptr(), nb, dst.data_ptr(), st)


def pair(k, units):
    """(shuffled, back) of tree k's kernels on ``units``."""
    nb = units.numel() // 512
    sh = torch.full((nb * 1024,), 0xAB, dtype=torch.uint8, device=dev)
    back = torch.full_like(units, 0x5A5A)
    assert launch(k, False, units, nb, sh) == 0
    assert launch(k, True, sh, nb, back) == 0
    torch.cuda.synchronize()
    return sh, back


cases = [(p, n) for p in edges.PATTERNS for n in edges.BLOCK_COUNTS]
cases += [("random", 65536), ("random", 65537), ("one-hot", edges.ONE_HOT_BLOCKS)]
bad = 0
for pattern, nb in cases:
    u = edges.one_hot_units() if pattern == "one-hot" else edges.edge_units(pattern, nb, seed=nb)
    units = torch.from_numpy(u.view(np.int16).copy()).to(dev)
    want = lz_bitshuffle.bitshuffle_plain(units)
    for k in range(len(trees)):
        sh, back = pair(k, units)
        if not (torch.equal(sh, want) and torch.equal(back, units)
                and torch.equal(back, lz_bitshuffle.bitunshuffle_plain(want))):
            print(f"[ab] MISMATCH tree {k} on {pattern} x {nb} blocks")
            bad += 1
print(f"[ab] bitshuffle edges vs plain: {bad} mismatches")

# the quant-mode units lossy-fz shuffles for hurr-field 128 MiB at eb=1e-3
captured = []
shuffle = bitshuffle.shuffle
bitshuffle.shuffle = lambda units, *a, **kw: captured.append(units.clone()) or shuffle(units, *a, **kw)
try:
    cfg = core.LZSSConfig(symbol_size=4, backend="lossy-fz", lossy_eb=1e-3, lossy_inner="deflate-full")
    raw = torch.from_numpy(datasets.load("hurr-field", 128 << 20)).to(dev)
    lossy.compress_lossy(raw.view(torch.int32).reshape(-1, cfg.chunk_symbols), cfg, raw.numel())
finally:
    bitshuffle.shuffle = shuffle
real = captured[0]
gen = torch.Generator(dev).manual_seed(0)
rand = torch.randint(-(1 << 15), 1 << 15, real.shape, generator=gen, device=dev,
                     dtype=torch.int32).to(torch.int16)
nb = real.numel() // 512
for label, units in (("hurr-field quant units", real), ("random units", rand)):
    for k in range(len(trees)):
        sh, back = pair(k, units)
        if not (torch.equal(sh, lz_bitshuffle.bitshuffle_plain(units)) and torch.equal(back, units)):
            print(f"[ab] MISMATCH tree {k} on the {label}")
print(f"[ab] timed inputs checked: {nb} blocks")


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


order = list(range(len(trees))) + list(reversed(range(len(trees))))
src8 = torch.empty(nb * 1024, dtype=torch.uint8, device=dev)
dst8 = torch.empty_like(src8)
for label, units in (("hurr-field quant units", real), ("random units", rand)):
    sh = torch.empty(nb * 1024, dtype=torch.uint8, device=dev)
    back = torch.empty_like(units)
    assert launch(0, False, units, nb, sh) == 0
    for name, src, dst, unshuf in (("bitshuffle", units, sh, False), ("bitunshuffle", sh, back, True)):
        t = {k: [] for k in range(len(trees))}
        copy = []
        for _ in range(3):
            for k in order:
                t[k].append(ms(lambda: launch(k, unshuf, src, nb, dst)))
            copy.append(ms(lambda: dst8.copy_(src8)))
        base = statistics.mean(t[0])
        print(f"[ab] {card} | {name} on {label}, {nb} blocks: " + "; ".join(
            f"tree {k} {statistics.mean(v):.4f} ms ({statistics.mean(v) / base:.3f})"
            for k, v in t.items()) + f"; D2D copy of {src8.numel()} bytes "
            f"{statistics.mean(copy):.4f} ms")
