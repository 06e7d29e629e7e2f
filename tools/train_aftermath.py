"""Does chip_smoke's train_phase change the model times measured after it?

    python3 tools/train_aftermath.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Builds the kernels, then runs ``models_phase`` (llama3.2-1b's prefill and
decode-step times among its lines), ``train_phase``, ``models_phase`` again
and, after a ``gc.collect()``, once more, all in one process, with each
phase's seconds.  Every timed line carries the card's name and power limit.
"""
import gc
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # as chip_smoke's main

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    card = cs.card_line()
    _build.build_all()
    for label, phase in (("models before", cs.models_phase), ("train", cs.train_phase),
                         ("models after", cs.models_phase), ("gc", None),
                         ("models after gc.collect()", cs.models_phase)):
        if phase is None:
            gc.collect()
            continue
        t = time.perf_counter()
        phase({}, card, {})
        print(f"[aftermath] {card} | {label}: {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
