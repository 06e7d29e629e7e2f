"""AdamW + LR schedule + global-norm clipping over the port's models.

Params update in their own dtype (master-less AdamW with fp32 moments, the
common large-scale setup), in place, under ``torch.no_grad()``.  The
optimizer state is ``{"m": {name: f32 tensor}, "v": {...}}`` keyed by the
model's ``named_parameters()``, whose names are the reference's flattened
names (``models/convert.py``); gradients are a dict with the same keys.
"""

from __future__ import annotations

import math

import torch


def _step_f32(step, device=None):
    """An int or a 0-d tensor -> a 0-d f32 tensor."""
    return torch.as_tensor(step, device=device).to(torch.float32)


def lr_schedule(step, cfg):
    """Linear warmup -> cosine decay to 10%."""
    step = _step_f32(step)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.learning_rate * (0.1 + 0.45 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params):
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.named_parameters()}

    return {"m": zeros(), "v": zeros()}


def global_norm(tree):
    """sqrt of the sum of squares (in f32) of every tensor of a dict."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree.values()))


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params, grads, opt_state, step, cfg):
    """One AdamW step.  Returns (params, new_opt_state, metrics).

    ``params`` (a model) is updated in place and returned; ``grads`` maps
    its parameter names to gradients; ``step`` is an int or a 0-d tensor.
    """
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = lr_schedule(step, cfg)
    b1, b2, wd = cfg.beta1, cfg.beta2, cfg.weight_decay
    t = _step_f32(step) + 1.0
    c1 = 1.0 - b1**t
    c2 = 1.0 - b2**t
    new_m, new_v = {}, {}
    for name, p in params.named_parameters():
        g32 = grads[name].to(torch.float32)
        m = b1 * opt_state["m"][name] + (1 - b1) * g32
        v = b2 * opt_state["v"][name] + (1 - b2) * torch.square(g32)
        mh = m / c1.to(m.device)
        vh = v / c2.to(v.device)
        p32 = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + 1e-8) + wd * p32
        p.copy_((p32 - lr.to(p.device) * delta).to(p.dtype))
        new_m[name], new_v[name] = m, v
    return params, {"m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}
