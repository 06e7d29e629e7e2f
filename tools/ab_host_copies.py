"""The host side of the read path's two big copies, timed four ways on one
card: where the field lands after its device-to-host copy, and where the
container sits before its host-to-device copy.

    python3 tools/ab_host_copies.py [--repeats 20] [--d2h-sizes 65536,50000000,100000000]
                                    [--out chiprun_out/ab_host_copies.json]

Each copy is blocking and timed on the host clock from before the call to
its return, as a caller of ``lzss.decompress`` waits for it:

  ``fresh``         a new pageable buffer each time: ``d.cpu()`` for the
                    D2H; ``np.array(blob)`` and then the H2D from it
  ``reused``        one pageable buffer, touched once before timing
  ``pinned``        one page-locked block, allocated once before timing
  ``pinned_cache``  a page-locked block taken from torch's caching host
                    allocator each time and dropped after it
                    (``torch.empty(n, pin_memory=True)``)

The D2H sizes are 64 KiB, 50 MB and 100 MB unless ``--d2h-sizes`` names
others (a write's containers run from about 15 MB for an ISABEL code field
to 16-248 MB for a TPC-H lineitem int32 column), the H2D sizes 15 MB and
20 MB (a read cell's field and container).  The ways take turns within each
repeat.  For the H2D the host copy into the buffer (``stage``) and the
copy to the card (``h2d``) are timed apart.  Then one allocation of a
64 MiB and a 128 MiB page-locked block (after the host cache is emptied),
and the machine's free host memory.  Needs a CUDA card.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

D2H_SIZES = (64 << 10, 50_000_000, 100_000_000)
H2D_SIZES = (15_000_000, 20_000_000)
ALLOC_SIZES = (64 << 20, 128 << 20)
WAYS = ("fresh", "reused", "pinned", "pinned_cache")


def card_line() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=30)
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout else "unknown"


def meminfo() -> dict:
    """MemTotal, MemAvailable and the locked-memory counters, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key in ("MemTotal", "MemAvailable", "MemFree", "Mlocked", "Unevictable"):
                out[key] = int(rest.split()[0]) * 1024
    return out


def host_allocs() -> int | None:
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return None if stats is None else stats().get("num_host_alloc")


def summary(seconds: list, nbytes: int) -> dict:
    q1, med, q3 = statistics.quantiles(seconds, n=4)
    return {"ms_median": med * 1e3, "ms_q1": q1 * 1e3, "ms_q3": q3 * 1e3,
            "GBps_median": nbytes / med / 1e9, "ms_per_GB_median": med * 1e3 / (nbytes / 1e9)}


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def d2h(n: int, repeats: int, dev) -> dict:
    d = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev)
    reused = torch.empty(n, dtype=torch.uint8)
    reused.copy_(d)  # its pages touched once
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    ways = {
        "fresh": lambda: d.cpu(),
        "reused": lambda: reused.copy_(d),
        "pinned": lambda: pinned.copy_(d),
        "pinned_cache": lambda: torch.empty(n, dtype=torch.uint8, pin_memory=True).copy_(d),
    }
    for fn in ways.values():  # warm: the cache's block, the driver's staging
        fn()
    times = {w: [] for w in WAYS}
    for r in range(repeats):
        order = WAYS if r % 2 == 0 else WAYS[::-1]
        for w in order:
            times[w].append(timed(ways[w]))
    for w in ("reused", "pinned"):  # the bytes landed
        assert torch.equal(ways[w]().to(dev), d), w
    return {w: summary(times[w], n) for w in WAYS}


def h2d(n: int, repeats: int, dev) -> dict:
    blob = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)  # as a caller holds it
    reused = np.empty(n, np.uint8)
    reused[:] = 0
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy()

    def staged(make):
        def run():
            t0 = time.perf_counter()
            buf = make()
            t1 = time.perf_counter()
            out = torch.from_numpy(buf).to(dev)
            t2 = time.perf_counter()
            return t1 - t0, t2 - t1, out
        return run

    def into(buf):
        np.copyto(buf, blob)
        return buf

    def from_cache():
        t = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return into(t.numpy())

    ways = {
        "fresh": staged(lambda: np.array(blob, np.uint8)),
        "reused": staged(lambda: into(reused)),
        "pinned": staged(lambda: into(pinned)),
        "pinned_cache": staged(from_cache),
    }
    for fn in ways.values():
        fn()
    times = {w: ([], [], []) for w in WAYS}
    for r in range(repeats):
        order = WAYS if r % 2 == 0 else WAYS[::-1]
        for w in order:
            t0 = time.perf_counter()
            stage, copy, out = ways[w]()
            total = time.perf_counter() - t0
            del out
            for lst, v in zip(times[w], (stage, copy, total)):
                lst.append(v)
    _, _, out = ways["pinned_cache"]()
    assert np.array_equal(out.cpu().numpy(), blob)
    return {w: {k: summary(v, n) for k, v in zip(("stage", "h2d", "total"), times[w])}
            for w in WAYS}


def pinned_allocation(repeats: int = 3) -> dict:
    empty = getattr(torch._C, "_host_emptyCache", None)
    out = {}
    for n in ALLOC_SIZES:
        secs = []
        for _ in range(repeats):
            if empty is not None:
                empty()
            before = host_allocs()
            t0 = time.perf_counter()
            t = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            secs.append(time.perf_counter() - t0)
            rose = None if before is None else host_allocs() - before
            del t
        out[n] = {"ms": [s * 1e3 for s in secs], "num_host_alloc_rise": rose,
                  "emptied_between": empty is not None}
    if empty is not None:
        empty()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--d2h-sizes", default=",".join(map(str, D2H_SIZES)),
                    help="comma-separated byte counts of the D2H copies")
    ap.add_argument("--out", default="chiprun_out/ab_host_copies.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    probe = torch.empty(16, dtype=torch.uint8, pin_memory=True)
    rec = {
        "card": card_line(),
        "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "host_memory_stats": host_allocs() is not None,
        "from_numpy_of_pinned_is_pinned": torch.from_numpy(probe.numpy()).is_pinned(),
        "meminfo_before": meminfo(),
        "d2h": {n: d2h(n, args.repeats, dev) for n in map(int, args.d2h_sizes.split(","))},
        "h2d": {n: h2d(n, args.repeats, dev) for n in H2D_SIZES},
        "alloc": pinned_allocation(),
        "meminfo_after": meminfo(),
    }
    print(f"card: {rec['card']}; torch {rec['torch']} CUDA {rec['cuda']}; "
          f"host_memory_stats {rec['host_memory_stats']}; "
          f"from_numpy(pinned.numpy()).is_pinned() {rec['from_numpy_of_pinned_is_pinned']}")
    for n, ways in rec["d2h"].items():
        print(f"D2H {n:>11} B  " + "  ".join(
            f"{w} {s['ms_median']:.3f} ms ({s['ms_per_GB_median']:.1f} ms/GB, "
            f"q {s['ms_q1']:.3f}-{s['ms_q3']:.3f})" for w, s in ways.items()))
    for n, ways in rec["h2d"].items():
        print(f"H2D {n:>11} B  " + "  ".join(
            f"{w} stage {s['stage']['ms_median']:.3f} + h2d {s['h2d']['ms_median']:.3f} "
            f"= {s['total']['ms_median']:.3f} ms ({s['total']['ms_per_GB_median']:.1f} ms/GB)"
            for w, s in ways.items()))
    for n, a in rec["alloc"].items():
        print(f"pinned alloc {n} B: {', '.join(f'{m:.3f}' for m in a['ms'])} ms "
              f"(num_host_alloc +{a['num_host_alloc_rise']}, emptied {a['emptied_between']})")
    for k in ("meminfo_before", "meminfo_after"):
        print(k, {m: f"{v / 2**30:.2f} GiB" for m, v in rec[k].items()})
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
