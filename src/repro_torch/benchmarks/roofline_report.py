"""Aggregate the dry run's records into the roofline tables.

The port's twin of the reference's ``benchmarks/roofline_report.py``: the
same table and summary, over the records ``repro_torch.launch.dryrun``
writes (default ``results/torch_dryrun``).  It reads the reference's
records too: both packages write one schema.  The port's terms are
reckoned from the H100 data sheet's constants (``launch/roofline.py``),
not measured.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report [--dir results/torch_dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load_records(d: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_table(recs, mesh="16x16", compressed=False):
    rows = [r for r in recs
            if r["mesh"] == mesh and r.get("compressed_grads", False) == compressed]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant |"
        " 6ND/counted | roofline_frac | args GB/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        rl = r["roofline"]
        arg = r["memory"].get("argument_size_in_bytes", 0) / 1e9
        out.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3e} | "
            f"{rl['memory_s']:.3e} | {rl['collective_s']:.3e} | "
            f"{rl['dominant']} | {rl['useful_flops_ratio']:.2f} | "
            f"{rl['roofline_fraction']:.3f} | {arg:.2f} |"
        )
    return "\n".join(out)


def dominant_summary(recs, mesh="16x16"):
    rows = [r for r in recs if r["mesh"] == mesh
            and not r.get("compressed_grads", False)]
    worst = sorted(rows, key=lambda r: r["roofline"]["roofline_fraction"])[:5]
    coll = sorted(rows, key=lambda r: -r["roofline"]["collective_s"])[:5]
    lines = ["worst roofline fraction:"]
    for r in worst:
        lines.append(f"  {r['arch']} x {r['shape']}: "
                     f"{r['roofline']['roofline_fraction']:.3f} "
                     f"({r['roofline']['dominant']})")
    lines.append("most collective-bound:")
    for r in coll:
        lines.append(f"  {r['arch']} x {r['shape']}: "
                     f"coll={r['roofline']['collective_s']:.3e}s")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/torch_dryrun")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    print(fmt_table(recs, args.mesh))
    print()
    print(dominant_summary(recs, args.mesh))


if __name__ == "__main__":
    main()
