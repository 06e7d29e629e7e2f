"""Benchmark harness entry point — one module per paper table/figure.

The port's twin of the reference's ``benchmarks/run.py``: the same suites
under the same names, run by the port's twins on the card (``--device
cpu`` runs the plain versions).

Usage:  PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] [--only tableN]
Output: CSV rows ``name,us_per_call,derived`` (+ `#` table headers).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller datasets (CI-sized)")
    ap.add_argument("--only", default="",
                    help="substring filter: table1|table2|fig8|fig9|table3")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args(argv)
    nbytes = 1 << 19 if args.quick else 1 << 21
    dev = args.device

    from repro_torch.benchmarks import (fig8_ratio, fig9_throughput, table1_ratio,
                                        table2_throughput, table3_usecase)

    suites = {
        "table1": lambda: table1_ratio.run(nbytes=nbytes, device=dev),
        "table2": lambda: table2_throughput.run(nbytes=nbytes, device=dev),
        "fig8": lambda: fig8_ratio.run_paper_table(nbytes=nbytes, device=dev),
        "fig9": lambda: fig9_throughput.run(nbytes=min(nbytes, 1 << 20), device=dev),
        "table3": lambda: table3_usecase.run(nbytes=nbytes, device=dev),
    }
    for name, fn in suites.items():
        if args.only and args.only not in name:
            continue
        print(f"## {name}", file=sys.stderr)
        fn()


if __name__ == "__main__":
    main()
