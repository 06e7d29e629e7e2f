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
    arr = np.asarray(arr)
    if want == torch.bfloat16 and arr.dtype.name in ("bfloat16", "uint16"):
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    if t.dtype != want:
        raise TypeError(f"{key}: array of {arr.dtype}, the model holds {want}")
    return t


def params_from_numpy(tree, cfg, device="cuda") -> transformer.Transformer:
    """The reference's params tree (numpy arrays, layers stacked) -> the
    port's model on ``device``, holding the same values bit for bit."""
    dev = common.resolve_device(device)
    model = transformer.Transformer(cfg, None, torch.device("meta"))
    want = model.state_dict()
    flat = {k: v for k, v in _flatten(tree).items() if not k.startswith("layers.")}
    for k, v in _flatten(tree["layers"]).items():
        for i in range(cfg.num_layers):
            flat[f"layers.{i}.{k}"] = v[i]
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


def params_to_numpy(model: transformer.Transformer) -> dict:
    """The inverse of ``params_from_numpy``: a nested dict of numpy arrays
    with the layers stacked ``(L, ...)`` (bf16 as ``uint16`` bits)."""
    tree, layers = {}, {}
    for key, t in model.state_dict().items():
        parts = key.split(".")
        if parts[0] == "layers":
            layers.setdefault(".".join(parts[2:]), []).append((int(parts[1]), _to_numpy(t)))
        else:
            tree[key] = _to_numpy(t)
    tree["layers"] = {}
    for key, rows in layers.items():
        node = tree["layers"]
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.stack([a for _, a in sorted(rows, key=lambda r: r[0])])
    return tree
