"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` (with the shared ``csrc/bfp_common.cuh``) is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
with a plain C interface, loaded with ``ctypes``.  Every source builds in
its own ``nvcc`` process, all started together.  Libraries go to the fixed
directory ``kernels/build`` (listed in ``.gitignore``), named by a hash of
their sources, so an edited source is rebuilt and an unchanged one is
loaded as it is.

Nothing here runs at import time: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("bfp_quant", "bfp_attention_prefill", "bfp_attention_decode")
HEADERS = ("bfp_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the GPU")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu", *HEADERS):
        h.update((CSRC / src).read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@functools.cache
def build_all() -> Dict[str, dict]:
    """Compile every source that has no library yet, in parallel.

    Returns {name: {"seconds": wall seconds of the whole build,
    "log": nvcc's output (ptxas register and shared-memory report) or ""
    when the library was already built}}.  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(".tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {name: "" for name in SOURCES}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{logs[name]}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    seconds = time.perf_counter() - t0
    return {name: {"seconds": seconds, "log": logs[name]}
            for name in SOURCES}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    build_all()
    lib = ctypes.CDLL(str(_lib_path(name)))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _function(lib_name: str, fn_name: str, signature: str):
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = [_CTYPE[c] for c in signature] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(lib_name: str, fn_name: str, signature: str, *args) -> None:
    """Call ``fn_name`` of ``lib<lib_name>`` on the current CUDA stream.

    ``signature`` has one letter per argument: ``p`` for a tensor (passed
    as its data pointer), ``i`` for an int, ``f`` for a float.  The C
    function returns ``cudaGetLastError()`` after its launches; a nonzero
    code raises here."""
    if len(signature) != len(args):
        raise TypeError(f"{fn_name}: {len(args)} arguments for signature "
                        f"{signature!r}")
    fn = _function(lib_name, fn_name, signature)
    c_args = [a.data_ptr() if kind == "p" else a
              for kind, a in zip(signature, args)]
    rc = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = library(lib_name).kernel_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {fn_name} failed: {msg} ({rc})")


__all__ = ["build_all", "library", "launch", "BUILD_DIR", "CSRC", "SOURCES"]
