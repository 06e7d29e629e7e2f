"""Step functions (train / prefill / decode) and their builders (the PyTorch port).

  * ``train_step``            — forward, backward and AdamW, with optional
                                microbatch accumulation (the reference's
                                ``lax.scan``, here a Python loop in the same
                                order: zeros + g_1 + ... + g_m, then / m).
  * ``train_step_compressed`` — the same, but each pod's gradients come
                                from its rows of the batch and the pods
                                exchange them GPULZ-compressed
                                (``optim.pod_exchange_compressed``) — the
                                paper's communication use case.  The
                                reference vmaps over pods; the port loops.
  * ``prefill_step`` / ``decode_step`` / ``paged_decode_step`` — serving.

The port runs a model on one device.  A train state is ``{"params":
Transformer, "opt": {"m": {name: f32}, "v": {...}}, "step": 0-d int32}``;
a step updates the params in place (the reference donates the state) and
returns the new state and its metrics, 0-d tensors on the device.  Where
the reference's builders return a jitted function and ``NamedSharding``s,
these return the plain function and ``sharding/rules.Placement``s.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.models import model as model_lib, transformer
from repro_torch.optim import adamw, grad_compress
from repro_torch.sharding import rules

# ------------------------------------------------------------- train state


def init_train_state(cfg, traincfg, seed: int = 0, device="cuda"):
    params = model_lib.init_params(cfg, seed, device=device)
    dev = next(params.parameters()).device
    return {
        "params": params,
        "opt": adamw.init_opt_state(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def abstract_train_state(cfg, traincfg):
    """The train state on ``meta``: shapes and dtypes, nothing allocated."""
    return init_train_state(cfg, traincfg, device="meta")


def train_state_shardings(cfg, traincfg, mesh):
    axes = model_lib.param_axes(cfg)
    p_sh = rules.params_shardings(axes, mesh)
    if traincfg.zero_opt_state:
        o_sh = rules.zero_shardings(axes, model_lib.abstract_params(cfg), mesh)
    else:
        o_sh = p_sh
    return {
        "params": p_sh,
        "opt": {"m": o_sh, "v": o_sh},
        "step": rules.Placement(rules.home_device(mesh), ()),
    }


def batch_shardings(cfg, shape, mesh):
    bs = rules.batch_spec(mesh, shape.global_batch)
    dev = rules.home_device(mesh)
    out = {}
    for k, s in model_lib.input_specs(cfg, shape).items():
        if k == "pos":
            out[k] = rules.Placement(dev, ())
        else:
            out[k] = rules.Placement(dev, rules._spec(*(list(bs) + [None] * (s.dim() - 1))))
    return out


# ------------------------------------------------------------------- train


def _loss_and_grads(params, cfg, traincfg, batch):
    """(loss, metrics, {name: gradient}) of one batch."""
    params.zero_grad(set_to_none=True)
    loss, metrics = transformer.loss_fn(params, cfg, batch, remat=traincfg.remat)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _grads_and_metrics(params, cfg, traincfg, batch):
    if traincfg.microbatches > 1:
        m = traincfg.microbatches
        g_acc = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
        l_acc = torch.zeros((), dtype=torch.float32, device=g_acc[next(iter(g_acc))].device)
        for i in range(m):
            mb = {k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i] for k, v in batch.items()}
            loss, _, g = _loss_and_grads(params, cfg, traincfg, mb)
            g_acc = {n: g_acc[n] + g[n] for n in g_acc}
            l_acc = l_acc + loss
        return {n: x / m for n, x in g_acc.items()}, {"loss": l_acc / m}
    _, metrics, grads = _loss_and_grads(params, cfg, traincfg, batch)
    return grads, metrics


def _step_output(state, new_p, new_opt, metrics, opt_metrics):
    return (
        {"params": new_p, "opt": new_opt, "step": state["step"] + 1},
        {**metrics, **opt_metrics},
    )


def train_step(state, batch, *, cfg, traincfg):
    grads, metrics = _grads_and_metrics(state["params"], cfg, traincfg, batch)
    new_p, new_opt, opt_metrics = adamw.adamw_update(
        state["params"], grads, state["opt"], state["step"], traincfg
    )
    return _step_output(state, new_p, new_opt, metrics, opt_metrics)


def _pod_devices(mesh) -> tuple:
    """One device a pod: the first of each slice along the pod axis."""
    return tuple(mesh.devices.reshape(mesh.shape["pod"], -1)[:, 0])


def train_step_compressed(state, batch, *, cfg, traincfg, mesh):
    """Train step with the GPULZ-compressed pod-axis gradient exchange.

    Each pod's gradients come from its contiguous rows of the batch (no
    cross-pod reduction in the backward pass); the only inter-pod traffic
    is the fixed-size compressed wire of ``pod_exchange_compressed``, one
    device a pod (the same device may stand for several).  The metrics are
    the pods' means.
    """
    n_pods = mesh.shape["pod"]
    # "auto" backend/decoder resolve per device inside the pipeline (on a
    # card: the one-launch fused-mono pair)
    lz_cfg = dataclasses.replace(
        grad_compress.GRAD_LZ,
        backend=traincfg.compression.lz_backend,
        decoder=traincfg.compression.lz_decoder,
    )
    per_pod, pod_metrics = [], []
    for k in range(n_pods):
        mb = {n: v.reshape(n_pods, v.shape[0] // n_pods, *v.shape[1:])[k]
              for n, v in batch.items()}
        g, met = _grads_and_metrics(state["params"], cfg, traincfg, mb)
        per_pod.append(g)
        pod_metrics.append(met)
    grad_stack = {n: torch.stack([g[n] for g in per_pod]) for n in per_pod[0]}
    del per_pod
    grads = grad_compress.pod_exchange_compressed(
        grad_stack, _pod_devices(mesh),
        compress=traincfg.compression.grad_cross_pod,
        cfg=lz_cfg,
        ratio_cap=traincfg.compression.grad_ratio_cap,
        # error-bounded lossy gradients (optimizer state stays lossless:
        # adamw_update below sees only the reconstructed gradients)
        lossy_eb=traincfg.compression.lossy_eb,
    )
    del grad_stack
    new_p, new_opt, opt_metrics = adamw.adamw_update(
        state["params"], grads, state["opt"], state["step"], traincfg
    )
    metrics = {k: torch.stack([m[k] for m in pod_metrics]).mean(0) for k in pod_metrics[0]}
    return _step_output(state, new_p, new_opt, metrics, opt_metrics)


# ------------------------------------------------------------------ serve


def prefill_step(params, batch, *, cfg, unroll=False, compute_specs=None):
    """Last-position logits.  ``unroll`` / ``compute_specs`` are the
    reference's layer-loop and FSDP-gather knobs: the port's forward is a
    Python loop over layers on one device, so they change nothing."""
    del unroll, compute_specs
    return transformer.prefill(params, cfg, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"))


def decode_step(params, caches, batch, *, cfg):
    logits, caches = transformer.decode_step(params, cfg, caches, batch["tokens"],
                                             int(batch["pos"]))
    return torch.argmax(logits, dim=-1).to(torch.int32), caches


def paged_decode_step(params, paged, batch, *, cfg):
    logits, paged = transformer.decode_step_paged(params, cfg, paged, batch["tokens"],
                                                  int(batch["pos"]))
    return torch.argmax(logits, dim=-1).to(torch.int32), paged


# ------------------------------------------------------------- builders


FSDP_AUTO_THRESHOLD = 25e9  # params; above this, weights must shard on data


def fsdp_decision(cfg, traincfg) -> bool:
    if traincfg.fsdp == "on":
        return True
    if traincfg.fsdp == "off":
        return False
    return cfg.param_count(padded=True) > FSDP_AUTO_THRESHOLD


def _set_mesh_context(mesh, batch_axes=None, fsdp=True, seq_parallel=False):
    """The activation-sharding context the reference installs with its
    mesh (read by the MoE's per-shard dispatch)."""
    if batch_axes is None:
        batch_axes = rules.batch_axes(mesh)
    shards = 1
    for a in batch_axes:
        if a in mesh.shape:
            shards *= mesh.shape[a]
    rules.set_activation_batch_axes(batch_axes, data_shards=shards)
    rules.set_fsdp(fsdp)
    rules.set_seq_parallel(seq_parallel)


def make_train_step(cfg, traincfg, mesh, shape, compressed: bool = False):
    """Returns (step_fn, state_shardings, batch_shardings)."""
    # the compressed step loops over the pod axis; inner activations then
    # use "data" only
    _set_mesh_context(
        mesh,
        batch_axes=("data",) if compressed else None,
        fsdp=fsdp_decision(cfg, traincfg),
        seq_parallel=traincfg.seq_parallel,
    )
    st_sh = train_state_shardings(cfg, traincfg, mesh)
    b_sh = batch_shardings(cfg, shape, mesh)
    if compressed:
        fn = functools.partial(train_step_compressed, cfg=cfg, traincfg=traincfg, mesh=mesh)
    else:
        fn = functools.partial(train_step, cfg=cfg, traincfg=traincfg)
    return fn, st_sh, b_sh


def cache_shardings(cfg, batch_size, mesh):
    """KV/state caches: batch on the data axis, heads on the model axis."""
    bs = rules.batch_spec(mesh, batch_size)
    b0 = bs if len(bs) else (None,)
    dev = rules.home_device(mesh)

    def one(leaf):
        nd = leaf.dim()
        if nd >= 3:  # (B, T, heads-ish, ...) or (B, H, N, P)
            return rules.Placement(dev, rules._spec(*(list(b0) + [None, "model"]
                                                      + [None] * (nd - 3))))
        if nd >= 1:
            return rules.Placement(dev, (None,) * nd)
        return rules.Placement(dev, ())

    return one


def _token_shardings(mesh, b):
    dev = rules.home_device(mesh)
    return {"tokens": rules.Placement(dev, rules.batch_spec(mesh, b)),
            "pos": rules.Placement(dev, ())}


def make_decode_step(cfg, mesh, shape):
    _set_mesh_context(mesh)
    b = shape.global_batch
    cache_sh = grad_compress._tree_map(cache_shardings(cfg, b, mesh),
                         model_lib.abstract_cache(cfg, b, shape.seq_len))
    p_sh = rules.params_shardings(model_lib.param_axes(cfg), mesh)
    fn = functools.partial(decode_step, cfg=cfg)
    return fn, p_sh, cache_sh, _token_shardings(mesh, b)


def make_paged_decode_step(cfg, mesh, shape, *, block_tokens, pool_blocks=None):
    """Decode over the paged (block-table) KV cache.  The pool's KV-head
    axis carries "model" (the dense cache's head split); block tables are
    host-authored int32 state and stay replicated."""
    _set_mesh_context(mesh)
    b = shape.global_batch
    ab = model_lib.abstract_paged_cache(cfg, b, shape.seq_len, block_tokens=block_tokens,
                                        pool_blocks=pool_blocks)
    dev = rules.home_device(mesh)
    pool_sh = rules.Placement(dev, (None, None, "model", None))
    repl = rules.Placement(dev, ())
    paged_sh = {
        "pool": {"k": pool_sh, "v": pool_sh},
        "tables": repl,
        "extra": grad_compress._tree_map(lambda _: repl, ab["extra"]),
    }
    p_sh = rules.params_shardings(model_lib.param_axes(cfg), mesh)
    fn = functools.partial(paged_decode_step, cfg=cfg)
    return fn, p_sh, paged_sh, _token_shardings(mesh, b)


def make_prefill_step(cfg, mesh, shape, unroll=False):
    _set_mesh_context(mesh)
    p_sh = rules.params_shardings(model_lib.param_axes(cfg), mesh)
    b_sh = batch_shardings(cfg, shape, mesh)
    fn = functools.partial(prefill_step, cfg=cfg, unroll=unroll)
    return fn, p_sh, b_sh
