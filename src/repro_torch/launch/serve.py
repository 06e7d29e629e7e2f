"""Batched serving driver (the port's engine over decode_step).

Runs on the card (``--device cuda``, the default) or, when asked, on the
CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --reduced --batch 4 --prompt-len 16 --new-tokens 32 --kv-compress
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import steps
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--kv-compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced_config(cfg)
    params = steps.init_train_state(cfg, TrainConfig(), args.seed,
                                    device=args.device)["params"]
    engine = ServingEngine(cfg, params, max_len=args.max_len,
                           kv_compress=args.kv_compress, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)
    ).astype(np.int32)
    t0 = time.time()
    result = engine.generate(prompts, max_new_tokens=args.new_tokens)
    dt = time.time() - t0
    print(f"generated {result.tokens.shape} in {dt:.2f}s "
          f"({result.steps * args.batch / dt:.1f} tok/s)")
    print("first sequence:", result.tokens[0][: args.prompt_len + 8].tolist())
    if args.kv_compress and engine.kv_store.stats.evictions:
        print("kv eviction ratio:", engine.kv_store.stats.eviction_ratio)


if __name__ == "__main__":
    main()
