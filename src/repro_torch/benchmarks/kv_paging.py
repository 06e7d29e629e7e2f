"""Paged-KV capacity tier: decode throughput vs. resident-block budget.

The port's twin of the reference's ``benchmarks/kv_paging.py``.  Sweeps
``ServingEngine(kv_offload=True)`` across resident budgets between the
per-layer peak (the smallest budget that can be exact) and the full
all-layers working set (no eviction pressure), against the dense-cache
engine as baseline.  Every paged point must stay bit-identical to the dense
tokens: the sweep *asserts* exactness, so the record is a correctness
record as much as a perf one.

It runs the reduced config of ``--arch`` by the reference's design (a
dispatch-structure sweep: eviction/restore rounds, batched dispatch
counts, prefetch hit rates); serving at full width is ``chip_smoke.py``'s
``serving_phase``.  Times are host-clock seconds of ``generate`` after an
identical warm-up run; on the card each round's codec is the one-launch
pair.  The record goes to ``BENCH_torch_kv.json`` (never the tracked
``BENCH_kv.json``).

    PYTHONPATH=src python -m repro_torch.benchmarks.kv_paging [--device cpu]
"""

from __future__ import annotations

import json
import time

import numpy as np

from repro_torch import configs
from repro_torch.benchmarks.common import emit, platform_fields
from repro_torch.models import common, model as model_lib
from repro_torch.serving.engine import ServingEngine


def _timed_generate(eng, prompts, new_tokens):
    """(result, seconds) after an identical warm-up run."""
    eng.generate(prompts, max_new_tokens=new_tokens)
    if eng.device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = eng.generate(prompts, max_new_tokens=new_tokens)
    return r, time.perf_counter() - t0


def paging_sweep(budgets=None, batch: int = 4, max_len: int = 64,
                 block_tokens: int = 8, prompt_tokens: int = 8,
                 new_tokens: int = 48, arch: str = "llama3.2-1b",
                 kv_backend: str = "auto", kv_prefetch: bool = True,
                 out_json: str = "BENCH_torch_kv.json", device=None) -> dict:
    """Throughput-vs-budget sweep; writes the record."""
    dev = common.resolve_device(device)
    cfg = configs.reduced_config(configs.get_config(arch))
    params = model_lib.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(
        0, cfg.vocab_size, (batch, prompt_tokens)
    ).astype(np.int32)

    dense = ServingEngine(cfg, params, max_len=max_len, device=dev)
    r_dense, t_dense = _timed_generate(dense, prompts, new_tokens)
    dense_tps = batch * r_dense.steps / t_dense
    emit("kv_paging/dense", t_dense, f"{dense_tps:.1f}tok/s")

    horizon = min(prompt_tokens + new_tokens - 1, max_len - 1)
    blocks_per_seq = (horizon - 1) // block_tokens + 1
    peak = batch * blocks_per_seq            # min exact budget (layer-stream)
    working_set = cfg.num_layers * peak      # no-eviction budget
    if budgets is None:
        third = (working_set - peak) // 3
        budgets = sorted({peak, peak + third, peak + 2 * third, working_set})

    entries = []
    for budget in budgets:
        eng = ServingEngine(
            cfg, params, max_len=max_len, kv_compress=True, kv_offload=True,
            block_tokens=block_tokens, budget_blocks=budget,
            kv_backend=kv_backend, kv_prefetch=kv_prefetch, device=dev,
        )
        r, t = _timed_generate(eng, prompts, new_tokens)
        exact = bool(np.array_equal(r.tokens, r_dense.tokens))
        assert exact, (
            f"paged decode at budget={budget} diverged from the dense cache"
        )
        tps = batch * r.steps / t
        ps = eng.paging_stats()
        st = eng.kv_store.stats
        entry = {
            "budget_blocks": int(budget),
            "tokens_per_s": tps,
            "seconds": t,
            "exact": exact,
            "evictions": st.evictions,
            "restores": st.restores,
            "eviction_ratio": st.eviction_ratio,
            "eviction_dispatches": st.eviction_dispatches,
            "restore_dispatches": st.restore_dispatches,
            "demand_restores": ps["demand_restores"],
            "prefetch_issued": ps["prefetch_issued"],
            "prefetch_hits": ps["prefetch_hits"],
            "high_water": ps["high_water"],
        }
        entries.append(entry)
        emit(
            f"kv_paging/budget-{budget}", t,
            f"{tps:.1f}tok/s|ev={st.evictions}|rs={st.restores}",
        )

    record = {
        "benchmark": "kv_paging_sweep",
        "arch": arch,
        **platform_fields(dev),
        "batch": batch,
        "max_len": max_len,
        "block_tokens": block_tokens,
        "prompt_tokens": prompt_tokens,
        "new_tokens": new_tokens,
        "kv_backend": kv_backend,
        "kv_prefetch": kv_prefetch,
        "working_set_blocks": working_set,
        "peak_layer_blocks": peak,
        "dense": {"tokens_per_s": dense_tps, "seconds": t_dense},
        "budgets": entries,
    }
    with open(out_json, "w") as f:
        json.dump(record, f, indent=2)
    print(f"# wrote {out_json}")
    return record


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--block-tokens", type=int, default=8)
    ap.add_argument("--prompt-tokens", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--kv-backend", default="auto",
                    help="eviction-codec registry key (e.g. deflate-full)")
    ap.add_argument("--no-prefetch", action="store_true")
    ap.add_argument("--budgets", type=int, nargs="*", default=None,
                    help="resident-block budgets to sweep (default: four "
                         "points from the per-layer peak to the working set)")
    ap.add_argument("--out-json", default="BENCH_torch_kv.json",
                    help="sweep artifact path")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args()
    paging_sweep(
        budgets=args.budgets, batch=args.batch, max_len=args.max_len,
        block_tokens=args.block_tokens, prompt_tokens=args.prompt_tokens,
        new_tokens=args.new_tokens, arch=args.arch,
        kv_backend=args.kv_backend, kv_prefetch=not args.no_prefetch,
        out_json=args.out_json, device=args.device,
    )
