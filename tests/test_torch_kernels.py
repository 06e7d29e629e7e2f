"""The port's kernel wrappers against the reference package.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held to the reference here: Kernel I to ``repro.kernels.ref.lz_kernel1``,
Kernel II to the interpret-mode Pallas ``lz_global_offsets_pallas`` and to
``deflate.global_offsets``, Kernel III to the sections of the reference's
``emit_xla`` container, and the decoder to the interpret-mode Pallas
``lz_decode_pallas`` and to ``decode.decode_parallel``.  (The reference's
Pallas Kernels I and III do not run on the installed jax.)  Outputs are
integers: the tolerance is exact equality.  The CUDA kernels themselves
are held to these plain versions on the card by tests/test_torch_gpu.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode as jdecode
from repro.core import deflate as jdeflate
from repro.core import format as jfmt
from repro.core import pipeline as jpipe
from repro.kernels import lz_decode as jlz_decode
from repro.kernels import lz_scatter as jlz_scatter
from repro.kernels import ref as jref
from repro_torch.core import autotune, deflate as tdeflate, pipeline as tpipe
from repro_torch.kernels import _build, ops

GEOMETRIES = [(1, 32, 64), (2, 128, 128), (4, 255, 64), (2, 64, 256)]


def _np(x):
    return (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).astype(np.int64)


def _symbols(s, nc, c, seed):
    rng = np.random.default_rng(seed)
    n = nc * c * s
    raw = np.repeat(rng.integers(0, 5, n), rng.integers(1, 7, n)).astype(np.uint8)[:n]
    raw[: n // 5] = rng.integers(0, 256, n // 5)  # an incompressible stretch
    return tpipe.pack_symbols(torch.from_numpy(raw), s).reshape(nc, c)


def _kernel1(sym, s, w, device="cpu"):
    cfg = tpipe.LZSSConfig(symbol_size=s, window=w, chunk_symbols=sym.shape[1])
    return ops.lz_kernel1(sym.to(device), window=w, min_match=cfg.min_match, symbol_size=s), cfg


@pytest.mark.parametrize("s,w,c", GEOMETRIES)
def test_kernel1_plain_equals_reference(s, w, c):
    sym = _symbols(s, 3, c, seed=c + s)
    got, cfg = _kernel1(sym, s, w)
    want = jref.lz_kernel1(jnp.asarray(sym.numpy()), window=w, min_match=cfg.min_match,
                           symbol_size=s)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(_np(got[k]), _np(want[k])), k


@pytest.mark.parametrize("nc", [1, 5, 300])
def test_kernel2_plain_equals_reference(nc):
    rng = np.random.default_rng(nc)
    nt = rng.integers(1, 2048, (2, nc)).astype(np.int32)
    ps = rng.integers(1, 4096, (2, nc)).astype(np.int32)
    fo, po, tot = ops.lz_global_offsets(torch.from_numpy(nt), torch.from_numpy(ps))
    for r in range(2):
        jfo, jpo, jft, jpt = jlz_scatter.lz_global_offsets_pallas(
            jnp.asarray(nt[r]), jnp.asarray(ps[r]), interpret=True
        )
        assert np.array_equal(_np(fo[r]), _np(jfo)[:nc])
        assert np.array_equal(_np(po[r]), _np(jpo)[:nc])
        assert _np(tot[r]).tolist() == [int(jft), int(jpt)]
        pay_off, pay_tot, flag_off, flag_tot = jdeflate.global_offsets(
            jnp.asarray(ps[r]), (jnp.asarray(nt[r]) + 7) // 8
        )
        assert np.array_equal(_np(fo[r]), _np(flag_off))
        assert np.array_equal(_np(po[r]), _np(pay_off) + int(flag_tot))


@pytest.mark.parametrize("s,w,c", GEOMETRIES)
def test_kernel3_plain_equals_reference_emit(s, w, c):
    nc = 4
    sym = _symbols(s, nc, c, seed=7 * c + s)
    k1, cfg = _kernel1(sym, s, w)
    fo, po, tot = ops.lz_global_offsets(k1["n_tokens"][None], k1["payload_sizes"][None])
    cap = jfmt.max_compressed_bytes(nc * c * s, s, c)
    sec = jfmt.HEADER_BYTES + 8 * nc
    blob = ops.lz_scatter(
        sym[None], k1["lengths"][None], k1["offsets"][None], k1["emitted"][None],
        k1["local_off"][None], fo, po, symbol_size=s, min_match=cfg.min_match,
        cap=cap, sec_flags=sec,
    )
    jcfg = jpipe.LZSSConfig(symbol_size=s, window=w, chunk_symbols=c)
    jk1 = jpipe.get_backend("xla").kernel1(jnp.asarray(sym.numpy()), jcfg)
    want, total = jpipe.emit_xla(jnp.asarray(sym.numpy()), jk1, jcfg)
    want = np.asarray(want)
    assert int(total) == sec + int(tot[0].sum())
    assert blob.shape == (1, cap)
    assert np.array_equal(blob[0, sec:].numpy(), want[sec:])  # header/tables: host work
    assert not blob[0, :sec].any()


def _sections(s, w, c, nc, seed):
    sym = _symbols(s, nc, c, seed)
    blob, total = tpipe.compress_chunks(sym, tpipe.LZSSConfig(symbol_size=s, window=w,
                                                              chunk_symbols=c))
    _, nt, ps = jfmt.validate_container(blob[:total].numpy())
    nt, ps = torch.from_numpy(nt), torch.from_numpy(ps)
    fs = (nt + 7) // 8
    sec = jfmt.HEADER_BYTES + 8 * nc
    flags = tdeflate.gather_section(blob, sec, fs, torch.cumsum(fs, 0) - fs, c // 8)
    pay = tdeflate.gather_section(blob, sec + int(fs.sum()), ps,
                                  torch.cumsum(ps, 0) - ps, c * s)
    return flags, pay, nt, sym


@pytest.mark.parametrize("s,w,c", GEOMETRIES)
def test_decoder_plain_equals_reference(s, w, c):
    flags, pay, nt, sym = _sections(s, w, c, 3, seed=c)
    got = ops.lz_decode(flags, pay, nt, symbol_size=s)
    args = [jnp.asarray(x.numpy().astype(np.int32)) for x in (flags, pay, nt)]
    assert np.array_equal(_np(got), _np(jlz_decode.lz_decode_pallas(*args, symbol_size=s,
                                                                    interpret=True)))
    assert np.array_equal(_np(got), _np(jdecode.decode_parallel(*args, symbol_size=s)))
    assert np.array_equal(_np(got), _np(sym))


def test_plain_versions_are_not_counted_as_launches():
    ops.reset_launch_counts()
    sym = _symbols(2, 2, 64, seed=1)
    tpipe.compress_chunks(sym, tpipe.LZSSConfig(chunk_symbols=64, backend="fused-deflate"))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_wrappers_refuse_other_devices():
    meta = torch.empty(2, 64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.lz_kernel1(meta, window=8, min_match=2, symbol_size=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.lz_decode(meta.to(torch.uint8), meta, meta[:, 0], symbol_size=2)


def test_bindings_match_the_cuda_sources():
    """Every ctypes signature names an extern "C" entry point of its source
    with as many parameters as it declares."""
    for name, fns in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
            assert m, fn
            assert len(m.group(1).split(",")) == len(argtypes), fn
    assert sorted(_build.SIGNATURES) == sorted(_build.SOURCES)
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)


@pytest.mark.parametrize("s,c,fits", [(4, 32768, True), (1, 32768, True),
                                      (2, 58000, False), (4, 40000, False)])
def test_shared_memory_fit(s, c, fits):
    if fits:
        autotune.validate_block_geometry(c, 8, s)
    else:
        with pytest.raises(ValueError, match=f"chunk_symbols={c}"):
            autotune.validate_block_geometry(c, 8, s)
