"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, and loaded with ``ctypes``; no
PyTorch header is compiled, which keeps a build to seconds.  All sources
build at once, one ``nvcc`` each.  Libraries are named by a hash of their
sources and flags, in ``src/repro_torch/_build/`` (git-ignored), so a
changed source is rebuilt and an unchanged one is reused within a checkout.
The ``-Xptxas -v`` report of each build is kept beside its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
SOURCES = (
    "lz_match", "lz_scatter", "lz_decode", "lz_entropy", "lz_bitshuffle", "lz_fused",
    "lz_decode_mono",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of every entry point: argtypes; each returns a cudaError_t.
SIGNATURES = {
    "lz_match": {
        "lz_kernel1_launch": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
        "lz_match_launch": [_P, _I, _I, _I, _I, _P, _P, _P],
        "lz_match_occupancy": [_I, _I, _P],
    },
    "lz_scatter": {
        "lz_global_offsets_launch": [_P, _P, _I, _I, _P, _P, _P, _P],
        "lz_global_offsets_occupancy": [_P],
        "lz_scatter_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _P, _P],
        "lz_scatter_occupancy": [_I, _I, _P],
    },
    "lz_decode": {
        "lz_decode_launch": [_P, _P, _P, _I, _I, _I, _P, _P],
        "lz_decode_occupancy": [_I, _I, _P],
    },
    "lz_entropy": {
        "lz_byte_histogram_launch": [_P, _L, _L, _P, _P],
        "lz_byte_histogram_occupancy": [_P],
        "lz_gap_decode_launch": [_P, _L, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P],
        "lz_gap_decode_occupancy": [_P],
    },
    "lz_bitshuffle": {
        "lz_bitshuffle_launch": [_P, _I, _P, _P],
        "lz_bitunshuffle_launch": [_P, _I, _P, _P],
        "lz_bitshuffle_occupancy": [_P],
    },
    "lz_fused": {
        "lz_fused_mono_launch": [
            _P, _I, _I, _I, _I, _I, _I, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        ],
        "lz_fused_occupancy": [_I, _I, _P],
    },
    "lz_decode_mono": {
        "lz_decode_mono_launch": [_P, _L, _I, _I, _P, _P, _P, _L, _I, _I, _P, _P],
        "lz_decode_mono_occupancy": [_I, _I, _P],
    },
}

_LOCK = threading.Lock()
_LIBS: dict = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of repro_torch "
            "are compiled at first use"
        )
    return found


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: pathlib.Path):
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _load(name: str, path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.gplz_error_string.argtypes = [ctypes.c_int]
    lib.gplz_error_string.restype = ctypes.c_char_p
    return lib


def build_all() -> dict:
    """Compile every missing library (in parallel) and load all of them.

    Returns ``{source name: ctypes.CDLL}``.  Raises ``RuntimeError`` with
    the compiler's output when a build fails.
    """
    with _LOCK:
        missing = [n for n in SOURCES if n not in _LIBS]
        if not missing:
            return dict(_LIBS)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name in missing:
            out = _lib_path(name)
            if not out.exists():
                jobs[name] = (out, *_start(name, out))
        errors = []
        for name, (out, proc, tmp) in jobs.items():
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in missing:
            _LIBS[name] = _load(name, _lib_path(name))
        return dict(_LIBS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all()[name]


def ptxas_report() -> dict:
    """``{source name: ptxas -v lines}`` of the libraries built so far."""
    out = {}
    for name in SOURCES:
        log = _lib_path(name).with_suffix(".log")
        if log.exists():
            out[name] = [
                ln.strip() for ln in log.read_text().splitlines()
                if "ptxas" in ln and ("Used" in ln or "Compiling" in ln or "spill" in ln)
            ]
    return out


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor lies on a CUDA device."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} takes CUDA tensors, got one on {t.device}")


def stream(t) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.gplz_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
