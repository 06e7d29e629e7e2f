"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks for a card in its fixture and skips without
one.  This file imports no JAX, so it runs where only PyTorch and the CUDA
toolkit are installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Outputs are integers: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core import format as fmt, pipeline as pl
from repro_torch.kernels import ops

GEOMETRIES = [(1, 32, 64), (2, 128, 128), (4, 255, 64), (4, 128, 2048), (2, 255, 32768)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the H100; see README)")
    return torch.device("cuda")


def _symbols(s, nc, c, seed):
    rng = np.random.default_rng(seed)
    n = nc * c * s
    raw = np.repeat(rng.integers(0, 5, n), rng.integers(1, 7, n)).astype(np.uint8)[:n]
    raw[: n // 5] = rng.integers(0, 256, n // 5)  # an incompressible stretch
    return pl.pack_symbols(torch.from_numpy(raw), s).reshape(nc, c)


@pytest.mark.gpu
@pytest.mark.parametrize("s,w,c", GEOMETRIES)
def test_kernel_path_equals_plain_path(cuda, s, w, c):
    nc = 3
    sym = _symbols(s, nc, c, seed=c).to(cuda)
    ops.reset_launch_counts()
    blob, total = pl.compress_chunks(sym, core.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c))
    plain, plain_total = pl.compress_chunks(
        sym, core.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c, backend="torch")
    )
    assert total == plain_total and torch.equal(blob, plain)
    _, nt, ps = fmt.validate_container(blob[:total].cpu().numpy())
    tables = (torch.from_numpy(nt).to(cuda), torch.from_numpy(ps).to(cuda))
    kw = dict(symbol_size=s, chunk_symbols=c, n_chunks=nc)
    got = pl.decompress_chunks(blob[:total], *tables, decoder="fused", **kw)
    want = pl.decompress_chunks(blob[:total], *tables, decoder="torch-parallel", **kw)
    assert torch.equal(got, want) and torch.equal(got, sym.to(torch.int32))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 1)


@pytest.mark.gpu
def test_host_api_defaults_to_the_card(cuda):
    data = np.random.default_rng(0).integers(0, 4, 100_000).astype(np.uint8)
    ops.reset_launch_counts()
    res = core.compress(data)
    assert np.array_equal(core.decompress(res.data), data)
    assert all(v == 1 for v in ops.launch_counts().values())
    assert np.array_equal(res.data, core.compress(data, device="cpu").data)
