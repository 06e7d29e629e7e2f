"""Dry run of every (arch x shape x mesh) cell on ``meta`` tensors (the PyTorch port).

The port's twin of the reference's ``launch/dryrun.py``: the same flags and
the same record schema, so that ``benchmarks/roofline_report.py`` reads the
records of both packages.  Where the reference lowers and compiles each cell
for a TPU mesh, this builds the params, the train state, the caches and the
inputs on ``meta`` (shapes and dtypes, nothing allocated) and runs the step
function under ``roofline.CountingMode``, which counts every ATen op the
step runs, backward and recomputation included.  ``compile_s`` is the
trace's seconds.  Nothing runs on a card; ``--device`` (default ``cuda``,
raising without a card, as every entry point of the port) names the device
the mesh's positions stand for.

Per device.  The port runs a model on one device, so a trace counts the
whole (global) step.  Each record's ``flops_per_device`` and
``bytes_per_device`` are that count / ``chips``, and the record says so in
``per_device``, a field the reference's records lack.  The trace runs every
layer (a Python loop, with nothing scanned), so there is no L=1 / L=2
extrapolation: ``direct_scanned_cost`` carries the same count as the
headline, under the reference's key.

Collectives (``collectives``, per device, operand bytes, as the reference
counts them) are reckoned from the cell's shardings (``steps.
train_state_shardings``, ``batch_shardings``, ``rules.zero_shardings``,
``fsdp_decision``), one rule a kind, an event only over an axis of more
than one position:

* all-gather: a parameter whose spec holds ``data`` (FSDP) is gathered over
  ``data`` from its shard, once a forward (prefill, decode) and, in a train
  step, once for the forward and once for the backward, a microbatch each;
  a parameter held whole on ``data`` whose optimizer state is sharded there
  (ZeRO) is gathered from its updated shard after the update;
* reduce-scatter: the gradient of either kind of parameter above, over
  ``data``, from the gradient's ``data``-unsharded piece, a microbatch each;
* all-reduce: the gradient of every other parameter, over ``data``; and on
  a mesh with a ``pod`` axis, every gradient's piece again over ``pod``;
* with ``--compressed-grads`` the ``pod`` all-reduce is replaced: a
  gradient piece of at least ``grad_compress.MIN_COMPRESS_SIZE`` elements
  all-gathers its fixed-size wire over ``pod``, ``n_slabs x
  _cap_bytes(slab, ratio_cap)`` bytes plus a flag a slab and a 4-byte scale
  (``optim/grad_compress.py``); a smaller piece is all-reduced as it is;
* all-to-all and collective-permute: none is reckoned.  Activation
  collectives of the ``model`` axis (tensor-parallel partial sums) are not
  reckoned either: the port's layers do not place them.

The codec's own work in the compressed exchange (quantize, compress,
decode) is not traced: its sizes depend on the data, and the trace runs
``train_step`` on ``meta``.  Such a record says so in ``codec_work``.

``memory`` holds ``argument_size_in_bytes`` and ``output_size_in_bytes``,
reckoned per device from the arguments' and outputs' shapes and specs
(each dim divided by its axes' positions, rounded up).  The keys XLA's
memory analysis adds are not reckoned and left out, as the reference's
``_mem_dict`` leaves out what XLA does not give.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--skip-existing]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.launch import mesh as mesh_lib, roofline, steps
from repro_torch.models import model as model_lib
from repro_torch.optim import grad_compress
from repro_torch.sharding import rules

PER_DEVICE = "global count / chips (the trace counts the whole step on one device)"
CODEC_NOT_COUNTED = "not counted (the exchange's wire is reckoned; its codec is not traced)"


@contextlib.contextmanager
def _mesh_context():
    """Restore the activation-sharding context the step builders set."""
    saved = (rules._BATCH_AXES, rules._DATA_SHARDS, rules._FSDP, rules._SEQ_PARALLEL)
    try:
        yield
    finally:
        rules._BATCH_AXES, rules._DATA_SHARDS, rules._FSDP, rules._SEQ_PARALLEL = saved


def _axis_positions(entry, mesh) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape.get(a, 1) for a in names)


def _has_axis(spec, axis) -> bool:
    return any(e == axis or (isinstance(e, tuple) and axis in e) for e in spec)


def _drop_axis(spec, axis) -> tuple:
    def one(e):
        if isinstance(e, tuple):
            rest = tuple(a for a in e if a != axis)
            return rest if len(rest) > 1 else (rest[0] if rest else None)
        return None if e == axis else e

    return tuple(one(e) for e in spec)


def local_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of one device's shard of ``t`` under ``spec`` on ``mesh``."""
    parts = list(spec) + [None] * (t.dim() - len(spec))
    n = 1
    for size, e in zip(t.shape, parts):
        n *= -(-size // _axis_positions(e, mesh))
    return n * t.element_size()


def _wire_bytes(n: int, ratio_cap: float) -> int:
    slab, n_slabs = grad_compress._slab_geometry(n, grad_compress.GRAD_LZ)
    return n_slabs * grad_compress._cap_bytes(slab, ratio_cap) + n_slabs + 4


def reckon_collectives(cfg, shape, mesh, traincfg, compressed: bool = False) -> list:
    """The cell's collectives, ``[(kind, operand bytes per device), ...]``,
    by the rules of the module docstring."""
    params = model_lib.abstract_params(cfg).state_dict()
    st_sh = steps.train_state_shardings(cfg, traincfg, mesh)
    p_sh, o_sh = st_sh["params"], st_sh["opt"]["m"]
    data, pod = mesh.shape.get("data", 1), mesh.shape.get("pod", 1)
    micro = traincfg.microbatches if shape.kind == "train" else 1
    events = []
    for name, p in params.items():
        spec = p_sh[name].spec
        fsdp = _has_axis(spec, "data")
        if data > 1 and fsdp:
            gathers = 2 * micro if shape.kind == "train" else 1
            events += [("all-gather", local_bytes(p, spec, mesh))] * gathers
        if shape.kind != "train" or not p.is_floating_point():
            continue
        zero = not fsdp and _has_axis(o_sh[name].spec, "data")
        if data > 1 and (fsdp or zero):
            events += [("reduce-scatter", local_bytes(p, _drop_axis(spec, "data"), mesh))] * micro
            piece = spec if fsdp else o_sh[name].spec
        else:
            if data > 1:
                events += [("all-reduce", local_bytes(p, spec, mesh))] * micro
            piece = spec
        if pod > 1:
            n = local_bytes(p, piece, mesh) // p.element_size()
            if compressed and n >= grad_compress.MIN_COMPRESS_SIZE:
                events.append(("all-gather", _wire_bytes(
                    n, traincfg.compression.grad_ratio_cap)))
            else:
                events.append(("all-reduce", local_bytes(p, piece, mesh)))
        if data > 1 and zero:
            events.append(("all-gather", local_bytes(p, o_sh[name].spec, mesh)))
    return events


def _tree_local_bytes(tree, placements, mesh) -> int:
    """Per-device bytes of a tree of tensors beside its tree of placements."""
    if isinstance(tree, torch.Tensor):
        return local_bytes(tree, placements.spec, mesh)
    if isinstance(tree, dict):
        return sum(_tree_local_bytes(v, placements[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_local_bytes(v, p, mesh) for v, p in zip(tree, placements))
    return 0


def _step_args(cfg, shape, mesh, traincfg, compressed):
    """(step function, its arguments on ``meta``, a function of the
    step's output giving the per-device (argument, output) bytes)."""
    batch = model_lib.input_specs(cfg, shape)
    if shape.kind == "train":
        # the compressed step's codec cannot run on meta: trace train_step
        # (the same model work) and reckon the exchange
        _, st_sh, b_sh = steps.make_train_step(cfg, traincfg, mesh, shape, compressed=compressed)
        fn = functools.partial(steps.train_step, cfg=cfg, traincfg=traincfg)
        state = steps.abstract_train_state(cfg, traincfg)
        o_sh = st_sh["opt"]["m"]
        state_bytes = (_param_bytes(state["params"], st_sh["params"], mesh)
                       + sum(local_bytes(t, o_sh[k].spec, mesh)
                             for moments in state["opt"].values() for k, t in moments.items())
                       + state["step"].element_size())
        args = state_bytes + sum(local_bytes(t, b_sh[k].spec, mesh) for k, t in batch.items())
        # the new state (placed as the old) and the replicated 0-d metrics
        return fn, (state, batch), lambda out: (args, state_bytes + sum(
            t.numel() * t.element_size() for t in out[1].values()))
    params = model_lib.abstract_params(cfg)
    p_bytes = _param_bytes(params, rules.params_shardings(model_lib.param_axes(cfg), mesh), mesh)
    if shape.kind == "prefill":
        fn, _, b_sh = steps.make_prefill_step(cfg, mesh, shape)
        args = p_bytes + sum(local_bytes(t, b_sh[k].spec, mesh) for k, t in batch.items())
        bs = rules.batch_spec(mesh, shape.global_batch)
        return fn, (params, batch), lambda logits: (args, local_bytes(logits, bs, mesh))
    fn, _, c_sh, t_sh = steps.make_decode_step(cfg, mesh, shape)
    caches = model_lib.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    # pos on the host: decode_step reads it as a Python int
    batch["pos"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
    tok = t_sh["tokens"].spec
    args = (p_bytes + _tree_local_bytes(caches, c_sh, mesh)
            + local_bytes(batch["tokens"], tok, mesh) + batch["pos"].element_size())
    return fn, (params, caches, batch), lambda out: (args, local_bytes(out[0], tok, mesh)
                                                     + _tree_local_bytes(out[1], c_sh, mesh))


def _param_bytes(params, p_sh, mesh) -> int:
    return sum(local_bytes(t, p_sh[k].spec, mesh) for k, t in params.state_dict().items())


def trace_cell(cfg, shape, mesh, traincfg, compressed=False) -> dict:
    """Trace one cell's step on meta: the global counts, the per-device
    memory and the trace's seconds."""
    with _mesh_context():
        fn, args, memory_of = _step_args(cfg, shape, mesh, traincfg, compressed)
        t0 = time.perf_counter()
        with roofline.CountingMode() as mode:
            out = fn(*args)
        seconds = time.perf_counter() - t0
        arg_bytes, out_bytes = memory_of(out)
    return {
        "flops": mode.flops, "bytes": mode.bytes, "trace_s": seconds,
        "memory": {"argument_size_in_bytes": int(arg_bytes),
                   "output_size_in_bytes": int(out_bytes)},
    }


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               compressed: bool = False, microbatches: int = 1,
               remat: str = "full", zero_opt: bool = True,
               fsdp: str = "on", seq_parallel: bool = False,
               kv_quant: bool = False, device=None, mesh=None, cfg=None):
    """Trace one cell on meta and reckon its record (nothing allocated).

    Returns ``(record, None)``, the reference's pair (there is no compiled
    object).  ``mesh`` overrides the production mesh and ``cfg`` the
    arch's config (tests use small host meshes and reduced configs).
    """
    if cfg is None:
        cfg = configs.get_config(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    shape = configs.get_shape(shape_name) if isinstance(shape_name, str) else shape_name
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device=device)
    chips = len(mesh)
    traincfg = TrainConfig(
        microbatches=microbatches,
        remat=remat,
        zero_opt_state=zero_opt,
        fsdp=fsdp,
        seq_parallel=seq_parallel,
        compression=CompressionConfig(grad_cross_pod=compressed),
    )
    trace = trace_cell(cfg, shape, mesh, traincfg, compressed)
    with _mesh_context():
        coll = roofline.collective_bytes(
            reckon_collectives(cfg, shape, mesh, traincfg, compressed))
    mesh_name = "x".join(str(s) for s in mesh.devices.shape)
    rl = roofline.Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=trace["flops"] / chips,
        bytes_per_device=trace["bytes"] / chips,
        coll_bytes_per_device=float(coll["total"]),
        model_flops=roofline.model_flops_for(cfg, shape),
        coll_breakdown=coll,
    )
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "chips": chips,
        "compressed_grads": compressed,
        "compile_s": round(trace["trace_s"], 2),
        "memory": trace["memory"],
        "flops_per_device": rl.flops_per_device,
        "bytes_per_device": rl.bytes_per_device,
        "collectives": rl.coll_breakdown,
        "roofline": rl.row(),
        "hlo_bytes": 0,  # no HLO: the port traces ATen ops
        "direct_scanned_cost": {
            "flops": rl.flops_per_device, "bytes": rl.bytes_per_device,
            "coll_total": coll["total"],
        },
        "per_device": PER_DEVICE,
    }
    if compressed:
        record["codec_work"] = CODEC_NOT_COUNTED
    return record, None


def run_cell(arch, shape_name, multi_pod, out_dir, compressed=False,
             skip_existing=False, **kw):
    mesh_name = _mesh_name(multi_pod)
    suffix = "__lzgrad" if compressed else ""
    for k, v in sorted(kw.items()):
        defaults = {"microbatches": 1, "remat": "full", "zero_opt": True,
                    "fsdp": "on", "seq_parallel": False, "kv_quant": False}
        if k in defaults and v != defaults[k]:
            suffix += f"__{k}-{v}"
    path = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    )
    if skip_existing and os.path.exists(path):
        print(f"[skip] {path}")
        return True
    if not configs.cell_is_runnable(arch, shape_name):
        print(f"[skip-by-design] {arch} x {shape_name} (full attention @500k)")
        return True
    try:
        record, _ = lower_cell(arch, shape_name, multi_pod,
                               compressed=compressed, **kw)
    except Exception as e:  # a boundary: report the cell and go on
        print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: {e}")
        traceback.print_exc()
        return False
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    r = record["roofline"]
    print(
        f"[ok] {arch:24s} {shape_name:12s} {mesh_name:8s} "
        f"trace={record['compile_s']:7.1f}s "
        f"comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
        f"coll={r['collective_s']:.3e}s dom={r['dominant']:10s} "
        f"frac={r['roofline_fraction']:.3f}"
    )
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--compressed-grads", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--fsdp", default="on", choices=["on", "off", "auto"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the device the mesh's positions stand for (default: the "
                         "card; the trace itself runs on meta)")
    args = ap.parse_args(argv)

    cells = (
        list(configs.all_cells())
        if args.all
        else [(args.arch, args.shape)]
    )
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for arch, shape_name in cells:
        for mp in meshes:
            ok = run_cell(
                arch, shape_name, mp, args.out,
                compressed=args.compressed_grads,
                skip_existing=args.skip_existing,
                microbatches=args.microbatches,
                remat=args.remat,
                fsdp=args.fsdp,
                seq_parallel=args.seq_parallel,
                kv_quant=args.kv_quant,
                device=args.device,
            )
            n_fail += 0 if ok else 1
    print(f"done; failures={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
