"""Checkpoint compression end-to-end: train state -> GPULZ shards -> restore.

    PYTHONPATH=src python -m repro_torch.examples.compress_checkpoint [--device cpu]

The port's twin of the reference's ``examples/compress_checkpoint.py``: the
reduced llama3.2-1b's train state saved through ``CheckpointManager``
(compressed shards) and restored through ``restore_latest`` onto a meta
template of the port's train state, bit for bit.
"""

import argparse
import tempfile

import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.core import lzss
from repro_torch.launch import steps
from repro_torch.models import convert


def _leaves(tree) -> list:
    """The tensors of a train state in the reference's layout, in order."""
    if isinstance(tree, dict) and not convert.is_train_state(tree):
        return [t for v in tree.values() for t in _leaves(v)]
    if convert.is_train_state(tree):
        return _leaves(convert.train_state_tree(tree))
    return [tree]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    dev = lzss.resolve_device(ap.parse_args(argv).device)
    cfg = configs.reduced_config(configs.get_config("llama3.2-1b"))
    tc = TrainConfig()
    state = steps.init_train_state(cfg, tc, 0, device=dev)

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, compress=True, device=dev)
        mgr.save(state, 100)
        st = mgr.stats(100)
        print(f"checkpoint: {st['orig_bytes']/1e6:.2f} MB -> "
              f"{st['stored_bytes']/1e6:.2f} MB (ratio {st['ratio']:.2f})")
        # zero-initialized Adam moments dominate the win; bf16 params less so
        restored, step = mgr.restore_latest(steps.abstract_train_state(cfg, tc))
        ok = all(
            torch.equal(a.cpu(), b.cpu())
            for a, b in zip(_leaves(state), _leaves(restored))
        )
        print(f"restored step {step}, bit-exact: {ok}")
        assert ok and step == 100, "the restored state differs from the saved one"
    return st


if __name__ == "__main__":
    main()
