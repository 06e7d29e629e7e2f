"""Roofline terms of a step, reckoned for one NVIDIA H100 (the PyTorch port).

The one home of the port's H100 constants, from NVIDIA's H100 SXM5 80GB
HBM3 data sheet (dense rates, no sparsity, at the full 700 W limit):

    PEAK_FLOPS = 989e12      bf16 tensor-core FLOP/s
    HBM_BW     = 3.35e12     HBM3 bytes/s
    INT32_OPS  = 67e12 / 4   int32 op/s of the CUDA cores: 132 SMs x 64
                             INT32 lanes x 1.98 GHz (the 67 TFLOP/s fp32
                             figure counts 128 FP32 lanes and 2 flops an
                             FMA; int32 has half the lanes, one op an
                             instruction)
    NVLINK_BW  = 450e9       NVLink 4 bytes/s a direction, inside a node of
                             8 GPUs (900 GB/s bidirectional)
    NET_BW     = 50e9        bytes/s a GPU across nodes (one 400 Gb/s NDR
                             InfiniBand adapter a GPU)

Meshes map onto nodes of 8 GPUs along the last axis first.  On the 16x16
mesh ("data", "model") a model group of 16 spans two nodes and each data
group crosses nodes, and the 2x16x16 mesh adds a pod axis across nodes;
256 and 512 GPUs are 32 and 64 nodes.  A ring collective over an axis that
crosses nodes runs at the slowest link it holds, so every axis of both
production meshes takes ``NET_BW`` (``LINK_BW``); only a mesh of at most 8
positions would run at ``NVLINK_BW``.

Three terms per (arch x shape x mesh), all in seconds a step:
    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = coll_bytes_per_device / LINK_BW

The port emits no HLO.  Its counts come from ``CountingMode``, a
``TorchDispatchMode`` that sees every ATen op a step runs (on ``meta``
tensors for the dry run, on the card to check that the trace is the card's
program), and its collectives from the list ``launch/dryrun.py`` reckons
from the cell's shardings; ``collective_bytes`` sums that list under the
reference's keys.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
HBM_BW = 3.35e12  # bytes/s
INT32_OPS = 67e12 / 4  # int32 op/s, CUDA cores
NVLINK_BW = 450e9  # bytes/s a direction, inside a node of 8
NET_BW = 50e9  # bytes/s a GPU across nodes (400 Gb/s NDR)
LINK_BW = NET_BW  # every axis of the production meshes crosses nodes

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def collective_bytes(events) -> dict:
    """Per-device bytes by collective kind (+ 'total', 'count').

    ``events`` is an iterable of ``(kind, operand_bytes)``: ``kind`` one of
    the five collectives, optionally with the reference's ``-start`` /
    ``-done`` suffix.  As in the reference's HLO parse, a collective counts
    its operand bytes, and an async pair counts once (at its ``-start``).
    """
    out = {k: 0 for k in _COLLECTIVES}
    count = 0
    for kind, nbytes in events:
        if kind.endswith("-done"):
            continue
        op = kind[: -len("-start")] if kind.endswith("-start") else kind
        if op not in out:
            raise ValueError(f"unknown collective {kind!r}")
        out[op] += int(nbytes)
        count += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["count"] = count
    return out


# ------------------------------------------------------------ counting mode

# free besides the views (``OpOverload.is_view``): allocations, a view
# that is not tagged one, a host read of a scalar
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "_local_scalar_dense", "resize_", "set_",
}
_GEMMS = {"mm", "addmm", "bmm", "baddbmm"}
# ops that move or fill bytes and compute nothing (XLA's copy, concatenate,
# gather, scatter without a combiner, broadcast, iota, pad)
_MOVES = {
    "copy_", "_to_copy", "clone", "contiguous", "cat", "stack", "index",
    "index_select", "gather", "scatter", "embedding", "slice_scatter",
    "select_scatter", "diagonal_scatter", "as_strided_scatter", "fill_",
    "fill", "zero_", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "scalar_tensor", "arange", "constant_pad_nd", "repeat",
    "expand_copy", "_unsafe_index", "index_put", "index_put_", "_index_put_impl_",
    "flip", "roll", "split_with_sizes_copy",
    "unsqueeze_copy", "view_copy", "permute_copy", "transpose_copy", "lift_fresh_copy",
    "_unsafe_index_put", "new_zeros", "new_ones", "new_full",
}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gemm_flops(name, args, out) -> int:
    # out (.., m, n); the contracted k from the first matrix operand
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2 * out.numel() * a.shape[-1]


def _conv_flops(args, out) -> int:
    w, groups = args[1], (args[8] if len(args) > 8 else 1)
    k = 1
    for s in w.shape[2:]:
        k *= s
    transposed = len(args) > 6 and bool(args[6])
    cin = w.shape[0] if transposed else w.shape[1] * groups
    return 2 * out.numel() * (cin // groups) * k


def op_cost(func, args, kwargs, out) -> tuple:
    """(flops, bytes) of one ATen op, by the rules of ``CountingMode``."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _FREE:
        return 0, 0
    if name == "copy_":  # dst.copy_(src): the source read, the destination written
        dst, src = args[0], args[1]
        return (dst.numel() if src.dtype != dst.dtype else 0), _nbytes(src) + _nbytes(dst)
    ins = list(_tensors(args)) + list(_tensors(kwargs))
    outs = list(_tensors(out))
    nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
    if name in _GEMMS:
        return _gemm_flops(name, args, outs[0]), nbytes
    if name == "convolution":
        return _conv_flops(args, outs[0]), nbytes
    if torch.Tag.reduction in func.tags:
        return ins[0].numel() if ins else 0, nbytes
    if name == "_to_copy" and ins and outs and ins[0].dtype != outs[0].dtype:
        return outs[0].numel(), nbytes  # a dtype cast: XLA's convert
    if name in _MOVES:
        return 0, nbytes
    return sum(t.numel() for t in outs), nbytes


class CountingMode(TorchDispatchMode):
    """Counts the FLOPs and bytes of every ATen op run under it.

    The rules, after XLA's ``HloCostAnalysis`` (what the reference's dry
    run reads):

    * a GEMM (``mm``, ``addmm``, ``bmm``, ``baddbmm``) is 2·m·n·k flops,
      its bias add included; a convolution 2 · output elements · input
      channels a group · kernel elements;
    * a reduction (an op tagged ``reduction``: sum, mean, amax, ...) is one
      flop per *input* element;
    * a dtype cast (``_to_copy`` or ``copy_`` between two dtypes, XLA's
      convert) is one flop per *output* element;
    * an op that only moves or fills bytes (copies within a dtype, cat,
      index and gather, scatter, fills and factories, pads) is no flop;
    * every other op (the elementwise ops, softmax, norms, scans) is one
      flop per *output* element;
    * views, aliases, ``empty`` and host reads of a scalar are free: no
      flop and no byte.

    Bytes are each counted op's tensor inputs plus its outputs (an in-place
    op reads and writes its operand; ``dst.copy_(src)`` reads ``src`` and
    writes ``dst`` only).  Eager PyTorch runs op by op, so
    these are the bytes of the unfused program: there is no fusion to
    credit, unlike XLA's count.  ``by_op`` keeps (calls, flops, bytes) per
    op name.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops, nbytes = op_cost(func, args, kwargs, out)
        if flops or nbytes:
            self.flops += flops
            self.bytes += nbytes
            name = func.overloadpacket.__name__
            calls, f0, b0 = self.by_op.get(name, (0, 0, 0))
            self.by_op[name] = (calls + 1, f0 + flops, b0 + nbytes)
        return out

    def counts(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes}


def count(fn, *args, **kwargs):
    """(fn's result, {"flops", "bytes"}) with ``fn`` run under the mode."""
    with CountingMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.counts()


# ----------------------------------------------------------------- roofline


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float  # 6ND / 2ND analytic, global
    coll_breakdown: dict

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        counted_global = self.flops_per_device * self.chips
        return self.model_flops / counted_global if counted_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achieved-model-FLOPs fraction of peak if the step ran at its
        dominant-term time (the dry-run analogue of MFU)."""
        t = self.bound_s
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D inference (N active)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    # decode: one token per sequence (+ cache attention, excluded from 2ND)
    return 2.0 * n_active * shape.global_batch


def from_compiled(arch, shape_name, mesh_name, chips, cost, events, model_flops) -> Roofline:
    """A ``Roofline`` from per-device ``cost`` (``{"flops", "bytes
    accessed"}``, the reference's keys) and the collective ``events``."""
    coll = collective_bytes(events)
    return Roofline(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=float(cost.get("flops", 0.0)),
        bytes_per_device=float(cost.get("bytes accessed", 0.0)),
        coll_bytes_per_device=float(coll["total"]),
        model_flops=model_flops,
        coll_breakdown=coll,
    )
