"""Build the CUDA sources of `reconvat_tpu_torch/csrc/` and bind them.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled by
`nvcc` for sm_90a into a shared library under `build/kernels/` of the
checkout (listed in `.gitignore`), named by a hash of its source and of
the headers under `csrc/` (`*.cuh`), so an edited kernel or header is
rebuilt. The library is loaded with `ctypes`; pointers and
the stream are passed as `c_void_p`. Nothing is built at import time: the
first call that needs a kernel builds it, and `build_all()` builds every
source at once, one `nvcc` process per source, started together.

The host C++ sources (`csrc/*.cpp`: the note decoder and the FLAC decoder,
copies of `native/`) are built the same way by the host compiler into one
library, `load(HOST)`; a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

HOST = "host"    # the host library of csrc/*.cpp among the sources' names
HOST_SOURCES = ("note_extract.cpp", "flac_decoder.cpp")
HOST_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]

# source name -> {C function: its ctypes argtypes}; every pointer and the
# stream are c_void_p so ctypes never truncates them to 32 bits. All return
# int (a cudaError_t for the launches). The host library's functions take
# typed pointers and give (restype, argtypes).
_P, _I = ctypes.c_void_p, ctypes.c_int
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PI16 = ctypes.POINTER(ctypes.c_int16)
_LL, _F = ctypes.c_longlong, ctypes.c_float
ENTRY_POINTS = {
    HOST: {
        "extract_notes": (_LL, [ctypes.POINTER(_F)] * 2
                          + [_I, _I, _F, _F, _I, ctypes.POINTER(_PI32)]),
        "extract_notes_packed_batch": (
            _LL, [ctypes.POINTER(ctypes.c_uint8)] * 2 + [_I] * 5
            + [ctypes.POINTER(_PI32), ctypes.POINTER(ctypes.c_int64)]),
        "notes_free": (None, [_PI32]),
        "flac_decode_file": (_LL, [ctypes.c_char_p, ctypes.POINTER(_PI16),
                                   ctypes.POINTER(_I), ctypes.POINTER(_I)]),
        "flac_free": (None, [_PI16])},
    "mel": {"mel_power_launch": [_P] * 6 + [_I] * 6 + [_P]},
    "banded_attention": {
        "banded_attention_fwd_launch": [_P] * 6 + [_I] * 5 + [_P],
        "banded_attention_fwd_bf16_launch": [_P] * 6 + [_I] * 5 + [_P]},
    "banded_attention_bwd": {
        "banded_attention_bwd_partials_launch": [_P] * 9 + [_I] * 6 + [_P],
        "banded_attention_bwd_partials_bf16_launch":
            [_P] * 9 + [_I] * 6 + [_P],
        "banded_attention_bwd_partials_smem_bytes": [_I],
        "banded_attention_bwd_partials_smem_limit": [],
        "banded_attention_bwd_reduce_launch": [_P] * 6 + [_I] * 6 + [_P],
        "banded_attention_bwd_reduce_bf16_launch":
            [_P] * 6 + [_I] * 6 + [_P]},
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the "
                       "note and FLAC decoders of csrc/*.cpp need one")


def _lib_path(name: str) -> str:
    """The library of `csrc/<name>.cu`, named by a hash of the source, of
    every header under `csrc/` (a source may include any of them) and of
    the flags; for HOST, of `HOST_SOURCES` and `HOST_FLAGS`."""
    if name == HOST:
        flags, sources = HOST_FLAGS, list(HOST_SOURCES)
    else:
        flags = NVCC_FLAGS
        sources = [f"{name}.cu", *sorted(
            f for f in os.listdir(CSRC) if f.endswith(".cuh"))]
    digest = hashlib.sha256(" ".join(flags).encode())
    for fname in sources:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def expanded_source(name: str) -> str:
    """The text of `csrc/<name>.cu` with each `#include "<header>.cuh"` of
    `csrc/` replaced by the header's text: a self-contained copy that a
    tool may edit and build elsewhere."""
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        lines = f.read().split("\n")
    for i, line in enumerate(lines):
        if line.startswith('#include "') and line.endswith('.cuh"'):
            with open(os.path.join(CSRC, line.split('"')[1])) as f:
                lines[i] = f.read().replace("#pragma once\n", "")
    return "\n".join(lines)


def nvcc_command(source: str, out: str, verbose: bool = False) -> list:
    """nvcc's command line that builds `source` into the shared library
    `out`, with the headers of `csrc/` on the include path."""
    return [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
            "-I", CSRC, "-o", out, source]


def _start_build(name: str, verbose: bool):
    """Start nvcc for one source (the host compiler for HOST); returns
    (Popen, tmp path, final path), or None when the library is already
    built. The tmp name is unique per process, so concurrent builds (test
    workers) never write one file."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    if name == HOST:
        cmd = [_cxx(), *HOST_FLAGS, "-o", tmp,
               *(os.path.join(CSRC, f) for f in HOST_SOURCES)]
    else:
        cmd = nvcc_command(os.path.join(CSRC, f"{name}.cu"), tmp, verbose)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job, verbose: bool) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        what = ("the host compiler failed for csrc/*.cpp" if name == HOST
                else f"nvcc failed for csrc/{name}.cu")
        raise RuntimeError(f"{what} (rc {proc.returncode}):\n{log}")
    if verbose and log:
        print(log, end="")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or none


def build_all(verbose: bool = False) -> None:
    """Compile every source in parallel (one nvcc each, the host compiler
    for the host library) and load them."""
    with _lock:
        jobs = {n: _start_build(n, verbose) for n in ENTRY_POINTS}
        for name, job in jobs.items():
            if job is not None:
                _finish_build(name, job, verbose)
    for name in ENTRY_POINTS:
        load(name)


def load(name: str) -> ctypes.CDLL:
    """The bound library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        job = _start_build(name, verbose=False)
        if job is not None:
            _finish_build(name, job, verbose=False)
        lib = ctypes.CDLL(_lib_path(name))
        for fn_name, spec in ENTRY_POINTS[name].items():
            fn = getattr(lib, fn_name)
            fn.restype, fn.argtypes = (spec if isinstance(spec, tuple)
                                       else (ctypes.c_int, spec))
        _libs[name] = lib
        return lib


def check_tensor(name: str, t, shape, device, dtype=torch.float32) -> None:
    """Validate a kernel argument: of `dtype`, on `device`, of `shape`,
    contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
