"""What the port's tracer costs when it is on: cells of the benchmark run
untraced (no profiler) with ``repro_torch.runtime.trace`` off and on in
turns, in one process on one card.

    python3 tools/trace_cost.py --seconds 20 --seeds 11 12 13 [--workload CELL ...]

First it times each kind of site alone (microseconds a site, 20,000 in a
row): a span and a count with tracing off, a host span and a count on, and
a span timed on the stream (two CUDA events) on.  Then, for each cell,
seed and setting, it prints the direction's rate (the window's field bytes
over its calls' wall time, as ``bench/e2e`` takes it) and the 95th
percentile of the window's calls (nearest rank); then each cell's medians,
on over off.  The order alternates with the seed.  Needs a CUDA card.
"""

import argparse
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, manifest  # noqa: E402
from bench.e2e.p95_call_ms import p95_ms  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402


def site_costs(n: int = 20_000) -> None:
    """Microseconds a site of each kind, ``n`` in a row."""
    import torch

    dev = torch.device("cuda")

    def per_site(body) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        return (time.perf_counter() - t0) / n * 1e6

    def host_span():
        with trace.span("lzss.pack"):
            pass

    def stream_span():
        with trace.span("lzss.d2h", dev):
            pass

    def counted():
        trace.count("host_syncs", 1)

    off = {"span": per_site(host_span), "count": per_site(counted)}
    trace.reset()
    trace.enable()
    try:
        on = {"span": per_site(host_span), "count": per_site(counted),
              "stream span": per_site(stream_span)}
        torch.cuda.synchronize()
    finally:
        trace.disable()
        trace.reset()
    print("us a site, off: " + ", ".join(f"{k} {v:.3f}" for k, v in off.items())
          + "; on: " + ", ".join(f"{k} {v:.3f}" for k, v in on.items()), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workload", nargs="*")
    args = ap.parse_args()
    man = manifest.load()
    cells = args.workload or [w["name"] for w in man["workloads"]]
    made = []

    class Recorded(harness.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    harness.Run = Recorded
    print(f"card: {harness._card_line()}", flush=True)
    site_costs()
    for cell in cells:
        got = {False: [], True: []}
        for k, seed in enumerate(args.seeds):
            for on in ((False, True) if k % 2 == 0 else (True, False)):
                trace.reset()
                if on:
                    trace.enable()
                try:
                    result, _ = harness.run_cell(man, cell, seed=seed, seconds=args.seconds,
                                                 trace=False)
                finally:
                    trace.disable()
                run = made.pop()
                rate = run.field_bytes() / run.call_seconds() / 1e9
                got[on].append((rate, p95_ms(run)))
                print(f"{cell} seed {seed} tracing {'on ' if on else 'off'}: {rate:.4f} GB/s, "
                      f"p95 {p95_ms(run):.3f} ms, {len(run.calls)} calls, "
                      f"correct {result['correct']}", flush=True)
        med = {on: [statistics.median(v[i] for v in got[on]) for i in (0, 1)] for on in got}
        print(f"{cell} medians: off {med[False][0]:.4f} GB/s p95 {med[False][1]:.3f} ms; "
              f"on {med[True][0]:.4f} GB/s p95 {med[True][1]:.3f} ms; rate on/off "
              f"{med[True][0] / med[False][0]:.4f}, p95 on/off {med[True][1] / med[False][1]:.4f}",
              flush=True)


if __name__ == "__main__":
    main()
