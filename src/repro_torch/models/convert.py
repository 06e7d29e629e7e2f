"""Weights across the two packages.

The reference's params are a nested dict of arrays with the layers stacked
``(L, ...)``; the port's are a ``Transformer`` whose ``state_dict`` key
``layers.3.attn.wq`` is ``params["layers"]["attn"]["wq"][3]``.  Names,
shapes and einsum layouts are the same, so converting unstacks (or stacks)
and copies; it never transposes or casts.

bf16 crosses as bits: a numpy array of the ``ml_dtypes`` ``bfloat16`` dtype
(what ``np.asarray`` of a JAX bf16 array gives; recognised by its name, so
``ml_dtypes`` is not imported) or a ``uint16`` array of the same bits.
``params_to_numpy`` gives bf16 tensors back as such ``uint16`` arrays;
``.view(ml_dtypes.bfloat16)`` makes them the reference's dtype again.

The train state crosses the same way.  The port's is ``{"params":
Transformer, "opt": {"m": {name: f32}, "v": {...}}, "step": 0-d int32}``
with the moments keyed by ``named_parameters()``; the reference's
(``launch/steps.py init_train_state``) holds ``opt.m`` and ``opt.v``
shaped like ``params``, layers stacked, and ``step`` an int32 scalar.
``train_state_tree`` gives the port's state in the reference's layout,
``train_state_to_numpy`` / ``train_state_from_numpy`` carry it across.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import common, transformer


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _to_tensor(arr, want: torch.dtype, key: str) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        if arr.dtype != want:
            raise TypeError(f"{key}: tensor of {arr.dtype}, the model holds {want}")
        return arr
    arr = np.asarray(arr)
    if want == torch.bfloat16 and arr.dtype.name in ("bfloat16", "uint16"):
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    if t.dtype != want:
        raise TypeError(f"{key}: array of {arr.dtype}, the model holds {want}")
    return t


def _unstack(tree, num_layers: int) -> dict:
    """A tree in the reference's layout -> ``{state_dict key: value}``: a
    stacked layer value ``layers/<path>`` becomes ``layers.<i>.<path>``,
    its row ``i`` (a view, for a tensor)."""
    flat = {k: v for k, v in _flatten(tree).items() if not k.startswith("layers.")}
    for k, v in _flatten(tree["layers"]).items():
        for i in range(num_layers):
            flat[f"layers.{i}.{k}"] = v[i]
    return flat


def params_from_numpy(tree, cfg, device="cuda") -> transformer.Transformer:
    """The reference's params tree (numpy arrays or tensors, layers stacked)
    -> the port's model on ``device``, holding the same values bit for bit."""
    dev = common.resolve_device(device)
    model = transformer.Transformer(cfg, None, torch.device("meta"))
    want = model.state_dict()
    flat = _unstack(tree, cfg.num_layers)
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"params tree does not fit {cfg.name}: missing {missing}, extra {extra}")
    state = {k: _to_tensor(flat[k], want[k].dtype, k).to(dev) for k in want}
    model.load_state_dict(state, assign=True)
    for p in model.parameters():
        p.requires_grad_(p.is_floating_point())
    return model


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _reference_layout(flat: dict, leaf, stack) -> dict:
    """``{state_dict key: tensor}`` -> the reference's nesting: each key
    ``layers.<i>.<path>`` joins ``layers/<path>``, ``stack`` of its tensors
    in layer order; every other tensor goes through ``leaf``."""
    tree, layers = {}, {}
    for key, t in flat.items():
        parts = key.split(".")
        if parts[0] == "layers":
            layers.setdefault(".".join(parts[2:]), []).append((int(parts[1]), t))
        else:
            tree[key] = leaf(t)
    tree["layers"] = {}
    for key, rows in layers.items():
        node = tree["layers"]
        *path, name = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[name] = stack([t for _, t in sorted(rows, key=lambda r: r[0])])
    return tree


def _stack_numpy(tensors) -> np.ndarray:
    return np.stack([_to_numpy(t) for t in tensors])


def params_to_numpy(model: transformer.Transformer) -> dict:
    """The inverse of ``params_from_numpy``: a nested dict of numpy arrays
    with the layers stacked ``(L, ...)`` (bf16 as ``uint16`` bits)."""
    return _reference_layout(model.state_dict(), _to_numpy, _stack_numpy)


def is_train_state(tree) -> bool:
    """Whether ``tree`` is the port's train state (its params a model)."""
    return isinstance(tree, dict) and isinstance(tree.get("params"), transformer.Transformer)


def train_state_tree(state, leaf=lambda t: t, stack=torch.stack) -> dict:
    """The port's train state in the reference's layout: ``params``,
    ``opt.m`` and ``opt.v`` nested with the layers stacked, ``step`` a 0-d
    int32 tensor.  ``leaf`` maps an unstacked tensor and ``stack`` a list
    of layer tensors (``torch.stack`` by default, which copies)."""
    step = state["step"]
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step, dtype=torch.int32)
    return {
        "params": _reference_layout(state["params"].state_dict(), leaf, stack),
        "opt": {k: _reference_layout(state["opt"][k], leaf, stack) for k in ("m", "v")},
        "step": leaf(step.to(torch.int32)),
    }


def train_state_to_numpy(state) -> dict:
    """The port's train state -> the reference's ``init_train_state`` tree
    of numpy arrays (bf16 as ``uint16`` bits, ``step`` an int32 scalar)."""
    return train_state_tree(state, _to_numpy, _stack_numpy)


def train_state_from_numpy(tree, cfg, device="cuda") -> dict:
    """The reference's train state (numpy arrays or tensors, layers stacked)
    -> the port's on ``device``, bit for bit.  A tensor leaf already on
    ``device`` is not copied: the layers become views of its rows."""
    params = params_from_numpy(tree["params"], cfg, device)
    dev = next(params.parameters()).device
    names = [n for n, _ in params.named_parameters()]
    opt = {}
    for k in ("m", "v"):
        flat = _unstack(tree["opt"][k], cfg.num_layers)
        if sorted(flat) != sorted(names):
            raise KeyError(f"opt.{k} does not fit {cfg.name}'s parameters")
        opt[k] = {n: _to_tensor(flat[n], torch.float32, f"opt.{k}.{n}").to(dev) for n in names}
    step = tree["step"]
    step = step if isinstance(step, torch.Tensor) else torch.from_numpy(np.array(step, np.int32))
    return {"params": params, "opt": opt, "step": step.to(device=dev, dtype=torch.int32)}
