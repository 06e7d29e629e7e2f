"""The checkpoint tests' golden step: a step directory written by the
reference package's manager (``tests/golden_ckpt/step_00000004``), and the
tree it holds, made from a seed with numpy.  Not a test module; imports no
JAX, so the card tests read it too."""

import os

import numpy as np
import torch

STEP = 4
DIRECTORY = os.path.join(os.path.dirname(__file__), "golden_ckpt")


def arrays() -> dict:
    """The tree's leaves as numpy (bf16 as its uint16 bits)."""
    rng = np.random.default_rng(11)
    w = np.repeat(rng.standard_normal((40, 8)), 5, axis=1).astype(np.float32)
    bits = (rng.standard_normal(600) * 0.1).astype(np.float32).view(np.uint32)
    return {"w": w, "e_bits": (bits >> 16).astype(np.uint16),
            "ids": np.arange(700, dtype=np.int32) % 17, "small": np.arange(8, dtype=np.int32),
            "step": np.int32(3)}


def torch_tree() -> dict:
    """The tree with the port's CPU tensors: lists, a tuple, None and a
    bf16 leaf, as the manager flattens them."""
    a = arrays()
    e = torch.from_numpy(a["e_bits"].view(np.int16)).view(torch.bfloat16)
    return {"blocks": [torch.from_numpy(a["w"]), {"e": e, "ids": torch.from_numpy(a["ids"])}],
            "head": (torch.from_numpy(a["small"]),), "none": None,
            "step": torch.tensor(int(a["step"]), dtype=torch.int32)}
