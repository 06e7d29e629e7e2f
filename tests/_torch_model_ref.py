"""Shared helpers of the model tests that hold the port to the reference:
one config in both packages, reference params carried into port modules,
and the tolerance rule.  Not a test module (no ``test_`` prefix)."""

import dataclasses

import numpy as np
import torch

from repro import configs as jconfigs
from repro_torch.configs import base as tbase


def to_port_config(c):
    """The reference's ModelConfig as the port's, field for field."""
    d = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    for k, cls in (("moe", tbase.MoEConfig), ("mla", tbase.MLAConfig), ("ssm", tbase.SSMConfig)):
        if d[k] is not None:
            d[k] = cls(**dataclasses.asdict(d[k]))
    return tbase.ModelConfig(**d)


def pair(name, dtype="float32", no_drop=False, **updates):
    """(reference cfg, port cfg) of the reduced ``name``; ``no_drop`` sets
    the MoE capacity factor to the expert count (no token is dropped)."""
    cfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config(name)), dtype=dtype, **updates)
    if no_drop and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg, to_port_config(cfg)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def tensor(x) -> torch.Tensor:
    """A reference array (f32, int or bool) as a CPU tensor."""
    return torch.from_numpy(np.array(x))


def port_module(cls, cfg, tree):
    """A port module of class ``cls`` holding the reference's ``tree``."""
    mod = cls(cfg, None, torch.device("meta"))
    mod.load_state_dict({k: tensor(v) for k, v in flatten(tree).items()}, assign=True)
    return mod


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = (x.detach().float().numpy() if isinstance(x, torch.Tensor) else
                np.asarray(x, dtype=np.float32) for x in (got, ref))
    return float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))), 1e-30)
