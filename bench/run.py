"""Run one cell of the port's benchmark and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the program (``src/repro_torch``).  The last line of standard output is
the result as one JSON object; the numbers the check compared, each beside
its limit, are the last lines of standard error.
"""

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux ``/proc``), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    STARTED = time.perf_counter() - _process_age()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    # import the benchmark as the package ``bench`` and the program from src/,
    # never a module of bench/ under a bare name
    sys.path[:] = [root, os.path.join(root, "src")] + [p for p in sys.path[1:] if p != here]
    # kernel caches at fixed paths inside the checkout, so that only a
    # checkout's first run builds (the program's own nvcc builds already
    # live in src/repro_torch/_build)
    cache = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    from bench import harness

    sys.exit(harness.main(started=STARTED))
