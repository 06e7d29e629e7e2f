"""End-to-end training driver: a 150M-param llama-style model for a few
hundred steps on synthetic data, with GPULZ-compressed checkpoints and
straggler-guarded steps, on the card.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm [--steps 200] [--device cpu]

The port's twin of the reference's ``examples/train_tiny_lm.py``, through
``repro_torch.launch.train.train_loop``: llama3.2-1b's config at 8 layers x
d_model 768 x ffn 2048 (its 128,256-token vocabulary kept, so 150,418,176
parameters with the KV heads' padding; the reference's "~100M" counts a
32k vocabulary).  Pass --tiny for a quick smoke run of the reduced config,
30 steps.
"""

import argparse
import os
import tempfile

from repro_torch.launch import train as train_cli


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_tiny_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args, _ = ap.parse_known_args(argv)

    class A:
        arch = "llama3.2-1b"
        reduced = bool(args.tiny)
        d_model = 0 if args.tiny else 768
        d_ff = 0 if args.tiny else 2048
        layers = 0 if args.tiny else 8
        steps = 30 if args.tiny else args.steps
        batch = 4
        seq = 256
        lr = 3e-4
        microbatches = 1
        ckpt_dir = args.ckpt_dir
        ckpt_every = 50
        async_ckpt = False
        heartbeat = os.path.join(tempfile.gettempdir(), "repro_torch_tiny_lm_heartbeat.json")
        log_every = 10
        device = args.device

    losses = train_cli.train_loop(A)
    assert losses[-1] < losses[0], "loss must decrease"
    print("OK: loss decreased; checkpoints at", A.ckpt_dir)
    return losses


if __name__ == "__main__":
    main()
