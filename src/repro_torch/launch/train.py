"""End-to-end training driver (the PyTorch port).

Production loop shape: resumable (checkpoint manager + pure-function-of-step
data), guarded (straggler watchdog + restart supervisor), compressed
checkpoints, optional compressed cross-pod gradient exchange.

It runs on the card (``--device cuda``, the default; the port runs a model
on one device) or, when asked, on the CPU with the plain PyTorch path of
every kernel.  The step time is read on the host clock after the loss is
read back, which waits for the step to finish on the device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 10 \
      --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import CompressionConfig, ShapeConfig, TrainConfig
from repro_torch.core import lzss
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.launch import mesh as mesh_lib, steps
from repro_torch.runtime.fault import StepGuard


def build(args):
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced_config(cfg)
    if args.d_model:
        cfg = dataclasses.replace(
            cfg,
            d_model=args.d_model,
            d_ff=args.d_ff or (4 * args.d_model),
            num_layers=args.layers or cfg.num_layers,
        )
    n_dev = 1  # the port runs a model on one device
    model_par = 1 if args.reduced else min(n_dev, 2)
    mesh = mesh_lib.make_host_mesh(
        data=max(1, n_dev // model_par), model=model_par,
        device=lzss.resolve_device(args.device),
    )
    traincfg = TrainConfig(
        total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        learning_rate=args.lr,
        microbatches=args.microbatches,
        compression=CompressionConfig(grad_cross_pod=False),
    )
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    return cfg, traincfg, mesh, shape


def train_loop(args):
    cfg, traincfg, mesh, shape = build(args)
    jfn, st_sh, b_sh = steps.make_train_step(cfg, traincfg, mesh, shape)
    dev = st_sh["step"].device
    mgr = CheckpointManager(
        args.ckpt_dir, compress=True,
        async_writes=bool(args.async_ckpt), device=dev,
    ) if args.ckpt_dir else None
    guard = StepGuard(heartbeat_path=args.heartbeat)

    state = None
    start_step = 0
    if mgr is not None and mgr.steps():
        template = steps.abstract_train_state(cfg, traincfg)
        state, start_step = mgr.restore_latest(template, st_sh)
        if state is not None:
            print(f"[train] resumed from step {start_step}")
    if state is None:
        state = steps.init_train_state(cfg, traincfg, traincfg.seed, device=dev)
        start_step = 0

    dc = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=traincfg.seed,
    )
    prefetch = Prefetcher(dc, start_step, device=dev)
    losses = []
    io_wait = 0.0  # ckpt I/O block time since the last observe
    for step in range(start_step, traincfg.total_steps):
        batch = prefetch.next()
        t0 = time.time()
        state, metrics = jfn(state, batch)
        loss = float(metrics["loss"])  # waits for the step on the device
        dt = time.time() - t0
        # io_wait is the previous save's stall: the async writer's enqueue
        # backpressure (or the full write time in sync mode), accounted by
        # StepGuard as its own straggler axis, never the compute EWMA
        slow = guard.observe(step, dt, io_wait_s=io_wait)
        io_wait = 0.0
        losses.append(loss)
        if step % args.log_every == 0 or step == traincfg.total_steps - 1:
            tok_s = shape.global_batch * shape.seq_len / dt
            print(
                f"step {step:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):7.3f} "
                f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms "
                f"({tok_s:,.0f} tok/s){' [straggler]' if slow else ''}"
            )
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            ts = time.time()
            mgr.save(state, step + 1)
            io_wait = (
                mgr.last_save_io_wait_s if args.async_ckpt
                else time.time() - ts
            )
        if guard.should_restart:
            raise RuntimeError("straggler watchdog tripped")
    if mgr is not None:
        mgr.save(state, traincfg.total_steps)
        mgr.wait_until_finished()  # drain async writes before reporting
        print("[train] final checkpoint:", mgr.stats(traincfg.total_steps))
        if args.async_ckpt:
            ws = mgr.writer_stats()
            print(
                f"[train] async writer: {ws.get('writes', 0)} writes, "
                f"{ws.get('commits', 0)} commits, "
                f"{ws.get('blocked_s', 0.0)*1e3:.1f} ms backpressure; "
                f"io stalls {guard.stats.io_stalls}"
            )
    print(
        f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{len(losses)} steps"
    )
    return np.array(losses)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--async-ckpt", action="store_true",
                    help="double-buffered background checkpoint writes "
                         "(runtime/async_io.py); save() stops stalling the "
                         "step on host I/O")
    ap.add_argument("--heartbeat", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    return train_loop(args)


if __name__ == "__main__":
    main()
