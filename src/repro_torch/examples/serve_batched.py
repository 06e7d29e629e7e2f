"""Batched serving with the paged-KV capacity tier, on the card.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]

The port's twin of the reference's ``examples/serve_batched.py``.  Runs
greedy generation for a batch of prompts twice: once through the
dense-cache serving engine, once through the paged capacity tier
(`kv_offload=True`) under a resident-block budget smaller than the full
working set: cold blocks are evicted through the GPULZ block store (the
paper's multi-byte S=2 path on bf16 data), their device slots actually
freed, and restored on access (mostly by prefetch).  The two token
streams must be bit-identical; the paging stats show the capacity tier
was really exercised.
"""

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import lzss
from repro_torch.launch import steps
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    dev = lzss.resolve_device(ap.parse_args(argv).device)
    cfg = configs.reduced_config(configs.get_config("llama3.2-1b"))
    params = steps.init_train_state(cfg, TrainConfig(), 0, device=dev)["params"]

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)

    dense = ServingEngine(cfg, params, max_len=96, device=dev)
    ref = dense.generate(prompts, max_new_tokens=24)
    print("dense tokens:", ref.tokens.shape)

    # horizon 35 -> 5 blocks/seq * 4 seqs = 20 resident blocks per layer at
    # peak; the full working set is num_layers * 20.  A budget of 24 holds
    # barely more than one layer's blocks, so decode must continuously
    # evict (compress + free slot) and restore (decompress into a fresh
    # slot) while staying exact.
    paged = ServingEngine(
        cfg, params, max_len=96, kv_compress=True, kv_offload=True,
        block_tokens=8, budget_blocks=24, device=dev,
    )
    out = paged.generate(prompts, max_new_tokens=24)
    assert np.array_equal(out.tokens, ref.tokens), "paged decode diverged"
    print("paged tokens bit-identical to dense:", out.tokens.shape)
    print("sequence 0:", out.tokens[0].tolist())

    s = paged.kv_store.stats
    ps = paged.paging_stats()
    assert s.evictions > 0 and s.restores > 0, "the capacity tier was not exercised"
    print(f"kv eviction: {s.evictions} blocks in "
          f"{s.eviction_dispatches} batched dispatches, "
          f"{s.evicted_bytes_raw} -> {s.evicted_bytes_stored} bytes "
          f"(ratio {s.eviction_ratio:.2f})")
    print(f"kv restore: {s.restores} blocks in "
          f"{s.restore_dispatches} batched dispatches "
          f"({ps['prefetch_hits']}/{ps['prefetch_issued']} prefetch hits, "
          f"{ps['demand_restores']} demand)")
    print(f"resident high-water: {ps['high_water']} "
          f"<= budget {ps['budget_blocks']} "
          f"(working set {ps['working_set_blocks']})")
    return out, paged


if __name__ == "__main__":
    main()
