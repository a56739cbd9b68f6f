"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through ``ctypes``. A build
happens at first use, into ``recformer_tpu_torch/_build/`` (listed in
``.gitignore``), under a name that carries a hash of the source, the shared
headers and the flags, so an edit rebuilds. Importing this module looks for
nothing.

    python3 -m recformer_tpu_torch.ops._build --ptxas [SOURCE.cu ...]

compiles the sources given (by default every kernel source) with
``-Xptxas -v`` and prints each kernel's registers, shared memory and
spills, one JSON line per kernel;

    python3 -m recformer_tpu_torch.ops._build --sass [NAME ...]

builds the libraries named (by default every one) and prints, one JSON line
each, how many of Hopper's warpgroup MMA (``HGMMA``) and TMA load and store
(``UTMALDG``, ``UTMASTG``) instructions ``cuobjdump -sass`` finds in each.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_CSRC = os.path.join(_HERE, "csrc")
SOURCES = {name: os.path.join(_CSRC, f"{name}.cu")
           for name in ("band_attention_fwd", "band_attention_bwd", "embed_layernorm",
                        "layernorm_bwd", "band_probes")}
HEADERS = tuple(os.path.join(_CSRC, h)
                for h in ("band_common.cuh", "band_mma.cuh", "row_reduce.cuh", "hopper_tma.cuh"))
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
        "embed_layernorm_bwd_partial_rows": ([_I, _I], _I),  # dtype H
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
        "layernorm_bwd_partial_rows": ([_I, _I], _I),  # dtype H
        "layernorm_bwd": (
            [_I, _P, _P, _P, _P, _P, _P,                  # dtype, x gamma dout dx partial dgb
             _I, _I, _F, _P],                              # M H eps stream
            _I),
    },
    "band_probes": {
        "band_ablation": (
            [_I, _P, _P, _P, _P, _P, _P, _P,              # variant, q kpad vpad keyloc gk gvalid, out
             _I, _I, _I, _I, _I, _I, _P],                  # B L H G window block_q stream
            _I),
        "band_headpair": (
            [_I, _P, _P, _P, _P,                          # variant, q k v, out
             _I, _I, _I, _I, _I, _P],                      # B L pairs window block_q stream
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


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return path


def _nvcc() -> str:
    return _tool("nvcc")


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


def ptxas_report(source: str) -> list:
    """Each kernel of ``source`` with the registers, shared memory and
    spills ``nvcc -Xptxas -v`` reports for it on sm_90a."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              os.path.join(tmp, "lib.so"), source],
                             capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{out.stderr}")
    rows, kernel = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = {"kernel": m.group(1)}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel is not None:
            kernel["spill_stores"], kernel["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            kernel["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            kernel["static_smem"] = int(smem.group(1)) if smem else 0
            rows.append(kernel)
            kernel = None
    return rows


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG")  # wgmma, TMA load, TMA store


def sass_counts(name: str) -> dict:
    """How many instructions of each opcode of ``SASS_OPS`` the built
    library ``name`` holds (``cuobjdump -sass``)."""
    load_library(name)
    out = subprocess.run([_tool("cuobjdump"), "-sass", library_path(name)],
                         check=True, capture_output=True, text=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", out)) for op in SASS_OPS}


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="registers, shared memory and spills per kernel; "
                                 "Hopper instructions per library")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--ptxas", action="store_true")
    mode.add_argument("--sass", action="store_true")
    ap.add_argument("names", nargs="*", help="sources (--ptxas) or library names (--sass)")
    args = ap.parse_args()
    if args.sass:
        for name in args.names or list(SOURCES):
            print(json.dumps({"library": name, **sass_counts(name)}), flush=True)
    else:
        for src in args.names or list(SOURCES.values()):
            for row in ptxas_report(src):
                print(json.dumps({"source": os.path.basename(src), **row}), flush=True)
