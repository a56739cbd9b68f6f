"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through ``ctypes``. A build
happens at first use, into ``recformer_tpu_torch/_build/`` (listed in
``.gitignore``), under a name that carries a hash of the source, the shared
headers and the flags, so an edit rebuilds. Importing this module looks for
nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_CSRC = os.path.join(_HERE, "csrc")
SOURCES = {name: os.path.join(_CSRC, f"{name}.cu")
           for name in ("band_attention_fwd", "band_attention_bwd", "embed_layernorm",
                        "layernorm_bwd")}
HEADERS = tuple(os.path.join(_CSRC, h)
                for h in ("band_common.cuh", "band_mma.cuh", "row_reduce.cuh"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
_DROPOUT = [_I, _U, _U, _F]  # on, seed, threshold, 1/(1-rate)
# C signatures, by library name, then function name: (argtypes, restype)
SIGNATURES = {
    "band_attention_fwd": {
        "band_attention_fwd_path": ([_I, _I, _I, _I], _I),  # dtype D G window
        "band_attention_fwd": (
            [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # dtype, 9 inputs, out
             _I, _I, _I, _I, _I, _I,                       # B L H D G window
             _F, _I, *_DROPOUT, _P],                       # scale, fuse, dropout, stream
            _I),
    },
    "band_attention_bwd": {
        "band_attention_bwd_tile": ([_I, _I, _I], _I),  # D G window
        "band_attention_bwd_path": ([_I, _I, _I, _I], _I),  # dtype D G window
        "band_attention_bwd": (
            [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,      # dtype, 9 inputs
             _P, _P, _P, _P, _P, _P,                       # dq dk dv dg stats ws
             _I, _I, _I, _I, _I, _I,                       # B L H D G window
             _F, _F, _I, *_DROPOUT, _P],                   # q/dq scales, fuse, dropout, stream
            _I),
    },
    "embed_layernorm": {
        "embed_layernorm_bwd_blocks": ([_I], _I),  # M
        "embed_layernorm_fwd": (
            [_I, _P, _P, _P, _P, _P, _P, _P,              # dtype, a b c d, gamma beta, out
             _I, _I, _F, _P],                              # M H eps stream
            _I),
        "embed_layernorm_bwd": (
            [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,      # dtype, a b c d, gamma dout dx partial dgb
             _I, _I, _F, _P],                              # M H eps stream
            _I),
    },
    "layernorm_bwd": {
        "layernorm_bwd_blocks": ([_I], _I),  # M
        "layernorm_bwd": (
            [_I, _P, _P, _P, _P, _P, _P,                  # dtype, x gamma dout dx partial dgb
             _I, _I, _F, _P],                              # M H eps stream
            _I),
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}

# the ``dtype`` argument of every kernel's C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data at a multiple of 32 bytes (the row
    kernels' vector loads need it; a fresh allocation always is)."""
    t = t.contiguous()
    return t if t.data_ptr() % 32 == 0 else t.clone()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (SOURCES[name], *HEADERS):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns (Popen, tmp, final) or None if
    the library is already built."""
    so = library_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, so


def _finish_build(name: str, job) -> None:
    proc, tmp, so = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log.decode(errors='replace')}")
    os.replace(tmp, so)


def build_all() -> None:
    """Build every kernel library, one ``nvcc`` per source, all started
    together."""
    jobs = {name: _start_build(name) for name in SOURCES}
    for name, job in jobs.items():
        if job is not None:
            _finish_build(name, job)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(library_path(name))
        for fn_name, (argtypes, restype) in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, restype
        _LOADED[name] = lib
    return lib
