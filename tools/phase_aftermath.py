"""Do chip_smoke's serving and gradient phases change the host-bound
times measured after them?

    python3 tools/phase_aftermath.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Builds the kernels, then times what the host sets as much as the card:
the wrappers of Kernel II, the byte histogram, the gap decoder and the
bitshuffle pair (at the shapes chip_smoke's per-kernel table uses:
hurr-quant 128 MiB and its container, 65,536 bitshuffle blocks; CUDA
events around 10 launches after a warm-up, five times each), a dense
decode step of llama3.2-1b whole (4 sequences, 544 slots; CUDA events,
mean of 8), and 2,000 small CPU tensor ops (host clock).  It takes them
before ``serving_phase``, after it, after ``grad_phase``, and after a
``gc.collect()``, with the interpreter's live object count, the process's
peak resident memory and its thread count beside each.  Every line carries
the card's name and power limit.
"""
import gc
import pathlib
import resource
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.kernels import _build, lz_match, lz_scatter, ops  # noqa: E402


def ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    card = cs.card_line()
    print(card, flush=True)
    _build.build_all()
    data = datasets.load("hurr-quant", 128 << 20)
    err = dict.fromkeys(ops.KERNELS, 0)
    spec = cs.container_kernel_spec(cs.hold_container_kernels(data, err))
    cfg = core.LZSSConfig()
    sym = pl.pack_symbols(torch.from_numpy(data).cuda(), 2).reshape(-1, cfg.chunk_symbols)
    k1 = lz_match.lz_kernel1_cuda(sym, window=cfg.window, min_match=cfg.min_match,
                                  symbol_size=2)
    args2 = (k1["n_tokens"][None], k1["payload_sizes"][None])
    rows = {"lz_global_offsets": lambda: lz_scatter.global_offsets_cuda(*args2)}
    rows.update({k: v["kernel"] for k, v in spec.items()})
    from repro_torch import configs
    from repro_torch.models import model, transformer as tf

    lcfg = configs.get_config("llama3.2-1b")
    m = model.init_params(lcfg, 0, device="cuda")
    caches = tf.init_cache(lcfg, 4, 544, device="cuda")
    toks = torch.zeros(4, dtype=torch.int32, device="cuda")
    small = torch.ones(16)

    def host_ops():
        t = time.perf_counter()
        x = small
        for _ in range(2000):
            x = x + 1.0
        return (time.perf_counter() - t) * 1e3

    def measure(tag):
        for name, fn in rows.items():
            print(f"[aftermath] {card} | {tag} {name}: "
                  + ", ".join(f"{ms(fn, 10):.4f}" for _ in range(5)) + " ms", flush=True)
        step = ms(lambda: tf.decode_step(m, lcfg, caches, toks, 100), 8)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        print(f"[aftermath] {card} | {tag} llama3.2-1b dense decode step {step:.3f} ms; "
              f"2000 CPU tensor adds {host_ops():.3f} ms; {len(gc.get_objects())} live objects, "
              f"peak resident {rss} bytes, {threading.active_count()} threads", flush=True)

    measure("before the phases")
    t = time.perf_counter()
    cs.serving_phase({}, card, err)
    measure("after serving_phase")
    cs.grad_phase({}, card, err)
    print(f"[aftermath] the two phases took {time.perf_counter() - t:.1f} s")
    measure("after grad_phase")
    gc.collect()
    measure("after gc.collect()")


if __name__ == "__main__":
    main()
