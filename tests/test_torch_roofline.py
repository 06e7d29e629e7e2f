"""The port's roofline module (repro_torch.launch.roofline) on the CPU.

* ``Roofline``'s terms, ``dominant`` and fractions on numbers built from the
  port's H100 constants, as ``tests/test_roofline.py`` holds the reference's
  on its TPU constants (tolerance 1e-9 on values of order 1).
* ``model_flops_for`` equal to the reference's for llama3-8b and
  deepseek-v2-236b on three shapes (exactly: the same integer arithmetic).
* ``collective_bytes`` of the port's events for the five collectives of
  ``tests/test_roofline.py``'s HLO equal to the reference's parse of that
  text, key by key.
* ``CountingMode``'s rules on single ops (exact counts), and the same
  counts on ``meta`` and on CPU tensors for a reduced model's prefill.
"""

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline, steps
from repro_torch.models import model

from _torch_threads import _one_thread  # noqa: F401

HLO = """
ENTRY main {
  %p = bf16[32,1024]{1,0} parameter(0)
  %ag = bf16[512,1024]{1,0} all-gather(bf16[32,1024]{1,0} %p), dimensions={0}
  %ar.1 = f32[16,4096]{1,0} all-reduce(f32[16,4096]{1,0} %x), to_apply=%add
  %ars = f32[8,8]{1,0} all-reduce-start(f32[8,8]{1,0} %y), to_apply=%add
  %ard = f32[8,8]{1,0} all-reduce-done(f32[8,8]{1,0} %ars)
  %a2a = bf16[4,256]{1,0} all-to-all(bf16[4,256]{1,0} %z), dimensions={0}
  %cp = u8[1000]{0} collective-permute(u8[1000]{0} %w), source_target_pairs={{0,1}}
}
"""
# the same program as the port's events: (kind, operand bytes)
EVENTS = [
    ("all-gather", 32 * 1024 * 2),
    ("all-reduce", 16 * 4096 * 4),
    ("all-reduce-start", 8 * 8 * 4),
    ("all-reduce-done", 8 * 8 * 4),
    ("all-to-all", 4 * 256 * 2),
    ("collective-permute", 1000),
]


def test_constants_are_the_h100_data_sheet():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.INT32_OPS == 67e12 / 4
    assert roofline.LINK_BW == roofline.NET_BW == 50e9
    assert roofline.NVLINK_BW == 450e9


def test_collective_bytes_equal_reference_parse():
    ours = roofline.collective_bytes(EVENTS)
    ref = jroofline.collective_bytes(HLO)
    assert ours == ref
    assert ours["all-reduce"] == 16 * 4096 * 4 + 8 * 8 * 4  # -done not counted
    assert ours["count"] == 5


def test_collective_bytes_rejects_unknown_kinds():
    with pytest.raises(ValueError):
        roofline.collective_bytes([("broadcast", 4)])


def test_roofline_terms_and_dominant():
    rl = roofline.Roofline(
        arch="a", shape="s", mesh="16x16", chips=256,
        flops_per_device=roofline.PEAK_FLOPS,  # exactly 1 s compute
        bytes_per_device=roofline.HBM_BW * 2,  # 2 s memory
        coll_bytes_per_device=roofline.LINK_BW * 0.5,
        model_flops=roofline.PEAK_FLOPS * 256,  # == chips x peak x 1 s
        coll_breakdown={},
    )
    assert abs(rl.compute_s - 1.0) < 1e-9
    assert abs(rl.memory_s - 2.0) < 1e-9
    assert abs(rl.collective_s - 0.5) < 1e-9
    assert rl.dominant == "memory"
    assert abs(rl.bound_s - 2.0) < 1e-9
    assert abs(rl.roofline_fraction - 0.5) < 1e-9  # bound by 2 s memory
    assert abs(rl.useful_flops_ratio - 1.0) < 1e-9
    row = rl.row()
    assert set(row) == {"arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
                        "dominant", "model_flops", "useful_flops_ratio", "roofline_fraction"}


def test_roofline_collective_dominant_and_zero_guards():
    rl = roofline.Roofline("a", "s", "m", 1, 0.0, 0.0, roofline.LINK_BW, 0.0, {})
    assert rl.dominant == "collective"
    assert rl.useful_flops_ratio == 0.0
    empty = roofline.Roofline("a", "s", "m", 1, 0.0, 0.0, 0.0, 1.0, {})
    assert empty.roofline_fraction == 0.0


def test_from_compiled_reads_the_reference_keys():
    rl = roofline.from_compiled("a", "s", "16x16", 4, {"flops": 8.0, "bytes accessed": 16.0},
                                EVENTS, 2.0)
    assert (rl.flops_per_device, rl.bytes_per_device) == (8.0, 16.0)
    assert rl.coll_bytes_per_device == jroofline.collective_bytes(HLO)["total"]


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_model_flops_equal_reference(arch, shape):
    ours = roofline.model_flops_for(configs.get_config(arch), configs.get_shape(shape))
    ref = jroofline.model_flops_for(jconfigs.get_config(arch), jconfigs.get_shape(shape))
    assert ours == ref


def _count(fn, *args):
    with roofline.CountingMode() as mode:
        fn(*args)
    return mode.flops, mode.bytes


def _t(*shape, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(0).standard_normal(shape)).to(dtype)


def test_counting_rules_on_single_ops():
    a, b = _t(8, 16), _t(16, 4)
    assert _count(torch.mm, a, b) == (2 * 8 * 4 * 16, 4 * (8 * 16 + 16 * 4 + 8 * 4))
    x, y = _t(3, 8, 16), _t(3, 16, 4)
    assert _count(torch.bmm, x, y)[0] == 2 * 3 * 8 * 4 * 16
    bias = _t(4)
    assert _count(torch.addmm, bias, a, b)[0] == 2 * 8 * 4 * 16
    # elementwise: one flop an output element; bytes in + out
    assert _count(torch.add, a, a) == (128, 3 * 128 * 4)
    assert _count(torch.exp, a) == (128, 2 * 128 * 4)
    # a reduction: one flop an input element
    assert _count(lambda t: torch.sum(t, dim=1), a) == (128, 128 * 4 + 8 * 4)
    assert _count(lambda t: torch.amax(t, dim=0), a)[0] == 128
    # views are free; a cast is one flop an element; a copy none
    assert _count(lambda t: t.view(16, 8).t()[:5].unsqueeze(0), a) == (0, 0)
    assert _count(lambda t: t.to(torch.bfloat16), a) == (128, 128 * 4 + 128 * 2)
    assert _count(lambda t: t.clone(), a) == (0, 2 * 128 * 4)
    assert _count(lambda t: torch.cat([t, t]), a) == (0, 4 * 128 * 4)
    assert _count(lambda: torch.empty(100)) == (0, 0)
    assert _count(lambda: torch.zeros(100))[0] == 0
    # in place: the operand read and written
    z = _t(8, 16)
    assert _count(lambda: z.add_(1.0)) == (128, 2 * 128 * 4)


def test_counting_in_place_copy():
    """dst.copy_(src) reads src and writes dst; between two dtypes it is a
    cast, one flop an element, as the same cast through ``.to`` is."""
    src = _t(8, 16)
    dst = torch.empty(8, 16, dtype=torch.bfloat16)
    assert _count(lambda: dst.copy_(src)) == (128, 128 * 4 + 128 * 2)
    assert _count(lambda: dst.copy_(src)) == _count(lambda t: t.to(torch.bfloat16), src)
    same = torch.empty(8, 16)
    assert _count(lambda: same.copy_(src)) == (0, 2 * 128 * 4)
    # a broadcast source is read once, at its own size
    assert _count(lambda: same.copy_(src[0])) == (0, 16 * 4 + 128 * 4)


def test_counting_convolution():
    x, w = _t(2, 6, 32), _t(6, 1, 4)  # depthwise, as mamba2's conv
    flops, _ = _count(lambda: torch.nn.functional.conv1d(x, w, groups=6, padding=3))
    assert flops == 2 * (2 * 6 * 35) * 1 * 4
    x2, w2 = _t(2, 6, 32), _t(5, 6, 3)
    flops, _ = _count(lambda: torch.nn.functional.conv1d(x2, w2))
    assert flops == 2 * (2 * 5 * 30) * 6 * 3


def test_counting_by_op_and_count_helper():
    a, b = _t(8, 16), _t(16, 4)
    out, counts = roofline.count(torch.mm, a, b)
    assert out.shape == (8, 4) and counts == {"flops": 1024, "bytes": 4 * (128 + 64 + 32)}
    with roofline.CountingMode() as mode:
        torch.mm(a, b)
        torch.mm(a, b)
    assert mode.by_op["mm"] == (2, 2048, 2 * 4 * (128 + 64 + 32))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b", "mamba2-2.7b"])
def test_meta_trace_counts_equal_cpu_run(arch):
    """The trace on meta counts what the same step counts on real tensors
    (the chip check holds the card to it the same way)."""
    cfg = configs.reduced_config(configs.get_config(arch))
    shape = ShapeConfig("p", 64, 2, "prefill")
    _, meta = roofline.count(steps.prefill_step, model.abstract_params(cfg),
                             model.input_specs(cfg, shape), cfg=cfg)
    params = model.init_params(cfg, 0, device="cpu")
    batch = model.make_batch(cfg, shape, seed=1, device="cpu")
    logits, real = roofline.count(steps.prefill_step, params, batch, cfg=cfg)
    assert real == meta
    assert bool(torch.isfinite(logits).all())
