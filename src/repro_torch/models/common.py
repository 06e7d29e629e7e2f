"""Shared model components: norms, RoPE, init, param-tree utilities.

Params live in ``nn.Module``s (``Params`` below) whose parameter names and
shapes are the reference's, so ``state_dict()["layers.3.attn.wq"]`` is the
reference's ``params["layers"]["attn"]["wq"][3]``.  Every module records the
*logical* axis names of its params ("embed", "heads", "ffn", "experts",
"vocab", ...); sharding/rules.py maps logical axes to mesh axes.

Random init draws from one explicit ``torch.Generator`` passed down the
constructors (the reference splits a PRNG key instead); nothing reads the
global seed.  On ``device="meta"`` nothing is drawn or allocated.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch builds models on a CUDA device by default and none "
            "is available; pass device='cpu'"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch models run on cuda, cpu or meta, not {dev}")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off in cuBLAS and cuDNN inside the block, restored after: f32
    matmuls on the card then round as f32, as on the CPU."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def generator(seed: int, device) -> torch.Generator | None:
    """A generator seeded with ``seed`` on ``device`` (None on meta)."""
    device = torch.device(device)
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


class Params(nn.Module):
    """A module of named params, each with its logical axes."""

    def __init__(self):
        super().__init__()
        self.axes = {}

    def param(self, name: str, value: torch.Tensor, axes: tuple) -> None:
        self.register_parameter(name, nn.Parameter(value, requires_grad=value.is_floating_point()))
        self.axes[name] = axes

    def param_axes(self) -> dict:
        """``{state_dict key: logical axes}`` of this module and below."""
        return {
            f"{prefix}.{name}" if prefix else name: axes
            for prefix, mod in self.named_modules()
            if isinstance(mod, Params)
            for name, axes in mod.axes.items()
        }


def rms_norm(x, scale, eps):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale


def qk_head_norm(x, eps):
    """Parameter-free per-head RMS norm (chameleon divergence fix)."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def apply_rope(x, positions, theta: float):
    """Rotate pairs (llama convention: split halves).

    x: (..., T, H, dh); positions: broadcastable to (..., T).
    """
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)  # (dh/2,)
    angles = positions[..., None].float() * freqs  # (..., T, dh/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(generator, shape, dtype, in_axis_size=None, scale=1.0, device=None):
    """f32 normals of std ``scale / sqrt(fan_in)`` from ``generator``, cast
    to ``dtype``; an empty tensor on the meta device."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = scale / max(fan_in, 1) ** 0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def tree_size_bytes(tree) -> int:
    """Bytes of every tensor in a module, dict or list (nested)."""
    if isinstance(tree, nn.Module):
        return sum(t.numel() * t.element_size() for t in tree.state_dict().values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size_bytes(v) for v in tree)
    return 0
