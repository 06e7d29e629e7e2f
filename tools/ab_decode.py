"""The three decoder kernels of several source trees, timed in turns on one card.

    python3 tools/ab_decode.py TREE0 TREE1 [TREE2 ...]

Each TREE is the root of a checkout (for an earlier commit, unpack
``git archive <commit>`` into the git-ignored ``_scratch/``).  Builds each
tree's CUDA libraries with that tree's own ``_build.py``, then:

  1. checks every tree's split decoder (``lz_decode_launch``), one-launch
     decoder (``lz_decode_mono_launch``) and gap decoder
     (``lz_gap_decode_launch``) against this checkout's plain versions on
     the edge inputs of ``repro_torch/data/decode_edges.py`` (at C=8 and
     2048 with S in {1, 2, 4}, and the largest chunks accepted: C=38,568 at
     S=4, 57,856 at S=1), and every tree's decoders against TREE0's on
     random (corrupt) sections;
  2. times the three kernels (CUDA events, launched directly with the same
     preallocated outputs, so no wrapper work is timed) in the order
     0..N-1, N-1..0, three times, on the container of hurr-quant 128 MiB at
     ``LZSSConfig()`` (its sections for the split decoder, the blob for the
     one-launch one, its payload section for the gap decoder), on 32,768
     all-literal and long-chain chunks, and on the container's flag section
     and a stored-escape section of the payload's size for the gap decoder;
     prints each tree's mean and its ratio to TREE0's.

Needs a CUDA card and nvcc.
"""
import ctypes, importlib.util, pathlib, statistics, sys
import numpy as np
import torch

trees = [pathlib.Path(t).resolve() for t in sys.argv[1:]]
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
from repro_torch import core
from repro_torch.core import deflate, entropy, format as fmt, pipeline as pl
from repro_torch.data import datasets, decode_edges
from repro_torch.kernels import lz_decode, lz_decode_mono, lz_entropy

libs, mono_sigs = [], []
for k, t in enumerate(trees):
    spec = importlib.util.spec_from_file_location(f"build_{k}", t / "src/repro_torch/kernels/_build.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    libs.append(m.build_all())
    mono_sigs.append(m.SIGNATURES["lz_decode_mono"]["lz_decode_mono_launch"])
    print(f"[ab] tree {k} = {t}")
    for name in ("lz_decode", "lz_decode_mono", "lz_entropy"):
        for ln in m.ptxas_report().get(name, []):
            if "Used" in ln:
                print(f"[ab]   {name}: {ln}")
dev = torch.device("cuda")
st = torch.cuda.current_stream().cuda_stream


def sections(blob, nt, ps, s, c):
    fs, p64 = (nt.to(torch.int64) + 7) // 8, ps.to(torch.int64)
    sec = fmt.HEADER_BYTES + 8 * nt.numel()
    flags = deflate.gather_section(blob, sec, fs, torch.cumsum(fs, 0) - fs, c // 8).contiguous()
    pay = deflate.gather_section(blob, sec + int(fs.sum()), p64, torch.cumsum(p64, 0) - p64, c * s)
    return flags, pay.contiguous()


class Split:
    """The split decoder's arguments and output for one container."""

    def __init__(self, blob, nt, ps, s, c):
        self.flags, self.pay = sections(blob, nt, ps, s, c)
        self.nt, self.s, self.c = nt.to(torch.int32).contiguous(), s, c
        self.out = torch.empty(nt.numel(), c, dtype=torch.int32, device=dev)

    def run(self, k):
        return libs[k]["lz_decode"].lz_decode_launch(
            self.flags.data_ptr(), self.pay.data_ptr(), self.nt.data_ptr(), self.nt.numel(),
            self.c, self.s, self.out.data_ptr(), st)

    def plain(self):
        return lz_decode.lz_decode_plain(self.flags, self.pay, self.nt, symbol_size=self.s)


class Mono:
    """The one-launch decoder's arguments and output for one container."""

    def __init__(self, blob, nt, ps, s, c):
        self.blob = blob.reshape(1, -1).contiguous()
        self.nt, self.ps = nt.to(torch.int32).reshape(1, -1), ps.to(torch.int32).reshape(1, -1)
        self.fofs, self.pofs = (x.contiguous() for x in lz_decode_mono.section_starts(self.nt, self.ps))
        # a tree's launcher takes either the section starts or one cumsum of
        # the flag and then the payload sizes, with the flag section's offset
        self.cums = torch.cumsum(torch.cat([(self.nt + 7) >> 3, self.ps], 1), 1, dtype=torch.int64)
        self.sec = fmt.HEADER_BYTES + 8 * nt.numel()
        self.s, self.c = s, c
        self.out = torch.empty(nt.numel(), c, dtype=torch.int32, device=dev)

    def run(self, k):
        starts = ((self.cums.data_ptr(), self.sec) if mono_sigs[k][7] is ctypes.c_longlong
                  else (self.fofs.data_ptr(), self.pofs.data_ptr()))
        return libs[k]["lz_decode_mono"].lz_decode_mono_launch(
            self.blob.data_ptr(), self.blob.shape[1], 1, self.nt.shape[1], self.nt.data_ptr(),
            self.ps.data_ptr(), *starts, self.c, self.s, self.out.data_ptr(), st)

    def plain(self):
        return lz_decode_mono.lz_decode_mono_plain(self.blob, self.nt, self.ps, symbol_size=self.s,
                                                   chunk_symbols=self.c).reshape(self.out.shape)


class Gap:
    """The gap decoder's arguments and output for one coded section."""

    def __init__(self, args):
        self.args = [a.contiguous() for a in args]
        self.out = torch.empty(self.args[1].numel(), decode_edges.SUB, dtype=torch.uint8, device=dev)

    def run(self, k):
        b, ws, rm, f, cnt, ba, od = self.args
        return libs[k]["lz_entropy"].lz_gap_decode_launch(
            b.data_ptr(), b.numel(), ws.data_ptr(), rm.data_ptr(), ws.numel(), f.data_ptr(),
            cnt.data_ptr(), ba.data_ptr(), od.data_ptr(), decode_edges.SUB, self.out.data_ptr(), st)

    def plain(self):
        return lz_entropy.huffman_gap_decode_plain(*self.args, sub=decode_edges.SUB)


def output(case, k):
    case.out.fill_(-1 if case.out.dtype == torch.int32 else 0xAB)
    assert case.run(k) == 0
    torch.cuda.synchronize()
    return case.out.clone()


def coded(section):
    """The gap decoder's arguments for one section on the card."""
    n = section.numel()
    counts = lz_entropy.byte_histogram_plain(section, 0, n).cpu().numpy()
    lengths = entropy.container_code_lengths(counts)
    stream, nbits, gaps = entropy.encode_section(section, 0, n, lengths, cap=n)
    tabs = entropy.canonical_tables(lengths, dev)
    g = gaps[: -(-n // decode_edges.SUB)]
    return Gap((stream[: (nbits + 7) // 8], g >> 3, (g & 7).to(torch.int32), tabs["first"],
                tabs["count"], tabs["base"], tabs["order"]))


def container(kind, nc, c, s):
    sym, blob, nt, ps = decode_edges.lz_edge_container(kind, nc, c, s, device=dev)
    return (torch.from_numpy(sym).to(dev), torch.from_numpy(blob).to(dev),
            torch.from_numpy(nt).to(dev), torch.from_numpy(ps).to(dev))


bad = 0
for kind in decode_edges.LZ_KINDS:
    for s, c, nc in ((1, 8, 4), (2, 8, 4), (4, 8, 4), (1, 2048, 8), (2, 2048, 8), (4, 2048, 8),
                     (4, 38568, 2), (1, 57856, 2)):
        sym, blob, nt, ps = container(kind, nc, c, s)
        for case in (Split(blob, nt, ps, s, c), Mono(blob, nt, ps, s, c)):
            want = case.plain()
            for k in range(len(trees)):
                got = output(case, k)
                if not (torch.equal(got, want) and torch.equal(got, sym)):
                    print(f"[ab] MISMATCH tree {k} {type(case).__name__} on {kind} S={s} C={c}")
                    bad += 1
for kind in decode_edges.GAP_KINDS:
    inp = decode_edges.gap_edge_inputs(kind, device=dev)
    case = Gap([inp[x] for x in ("blob", "wstarts", "rems", "first", "count", "base", "order")])
    want = case.plain()
    for k in range(len(trees)):
        if not torch.equal(output(case, k), want):
            print(f"[ab] MISMATCH tree {k} gap decoder on {kind}")
            bad += 1
gen = torch.Generator(dev).manual_seed(0)
for s, c in ((2, 2048), (1, 57856)):
    nc = 64 if c == 2048 else 2
    rnd = lambda n: torch.randint(0, 256, (nc, n), device=dev, generator=gen, dtype=torch.int32)
    flags, pay = rnd(c // 8).to(torch.uint8), rnd(c * s).to(torch.uint8)
    nt = torch.randint(0, c + 1, (nc,), device=dev, generator=gen, dtype=torch.int32)
    case = Split.__new__(Split)
    case.flags, case.pay, case.nt, case.s, case.c = flags, pay, nt, s, c
    case.out = torch.empty(nc, c, dtype=torch.int32, device=dev)
    ref = output(case, 0)
    for k in range(1, len(trees)):
        if not torch.equal(output(case, k), ref):
            print(f"[ab] MISMATCH tree {k} vs tree 0: split decoder on random sections S={s} C={c}")
            bad += 1
print(f"[ab] decode edges vs plain and random sections vs tree 0: {bad} mismatches")

cfg = core.LZSSConfig()
s, c = cfg.symbol_size, cfg.chunk_symbols
raw = torch.from_numpy(datasets.load("hurr-quant", 128 << 20)).to(dev)
sym = pl.pack_symbols(raw, s).reshape(-1, c)
nc = sym.shape[0]
buf, total = pl.compress_chunks(sym, cfg)
blob = buf[:total].contiguous()
_, nt, ps = fmt.validate_container(blob.cpu().numpy())
nt, ps = torch.from_numpy(nt).to(dev), torch.from_numpy(ps).to(dev)
sec = fmt.HEADER_BYTES + 8 * nc
f_tot = int(((nt.to(torch.int64) + 7) // 8).sum())
p_tot = int(ps.sum())
cases = {"hurr-quant": (sym, Split(blob, nt, ps, s, c), Mono(blob, nt, ps, s, c))}
for kind, label in (("literals", "all-literal chunks"), ("chain", "long-chain chunks")):
    x, b2, n2, p2 = container(kind, nc, c, s)
    cases[label] = (x, Split(b2, n2, p2, s, c), Mono(b2, n2, p2, s, c))
flat = torch.arange(256, device=dev, dtype=torch.int32).repeat(p_tot // 256 + 1)[:p_tot].to(torch.uint8)
gap_sections = {"payload section": blob[sec + f_tot : sec + f_tot + p_tot],
                "flag section": blob[sec : sec + f_tot], "stored escape (payload's size)": flat}
gaps = {label: coded(x) for label, x in gap_sections.items()}
for k in range(len(trees)):
    for label, (x, sp, mo) in cases.items():
        for case in (sp, mo):
            if not torch.equal(output(case, k), x):
                print(f"[ab] MISMATCH tree {k}: {label} {type(case).__name__} does not decode")
    for label, g in gaps.items():
        x = gap_sections[label]
        if not torch.equal(output(g, k).reshape(-1)[: x.numel()], x):
            print(f"[ab] MISMATCH tree {k}: gap decoder on the {label} does not decode")
print("[ab] outputs at the timed sizes checked against their inputs")


def ms(case, k, reps):
    case.run(k)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        case.run(k)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


order = list(range(len(trees))) + list(reversed(range(len(trees))))
timed = [(f"{label} {name}", case) for label, (_, *pair) in cases.items()
         for name, case in zip(("lz_decode", "lz_decode_mono"), pair)]
timed += [(f"huffman_gap_decode {label}", g) for label, g in gaps.items()]
for label, case in timed:
    t = {k: [] for k in range(len(trees))}
    for _ in range(3):
        for k in order:
            t[k].append(ms(case, k, 10))
    base = statistics.mean(t[0])
    print(f"[ab] {label}: " + "; ".join(
        f"tree {k} {statistics.mean(v):.4f} ms ({statistics.mean(v) / base:.3f})" for k, v in t.items()))
