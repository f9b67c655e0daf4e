"""Build and load the port's CUDA kernel library.

Every `gf3x_torch/csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into
ONE shared library with a plain C interface, loaded with `ctypes`. The
library lands in `gf3x_torch/_build/<hash of sources and flags>/` (ignored
by git) and is built at its first use, so a fresh checkout on a machine
with the CUDA toolkit builds it by itself; nothing is built or loaded when
the package is imported.

`--fmad=false` is part of the build: the LDPC kernel must reproduce the
plain version's float32 roundings bit for bit, and nvcc otherwise contracts
`α·p·m − c2v` into one fused multiply-add.

Each C entry point launches on the stream it is handed and returns
`cudaGetLastError()`; `launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["CSRC", "NVCC_FLAGS", "kernel_lib", "library_path", "launch",
           "stream_of", "ptr"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = CSRC.parent / "_build"
_LIB_NAME = "libgf3x_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD / h.hexdigest()[:16] / _LIB_NAME


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the gf3x_torch kernels "
                           "build only where nvcc is installed")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(out: Path) -> None:
    """Compile every source into `out`; the compiler's report (registers,
    shared memory, spills per kernel) is kept beside it as build.log."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent builder sees all or none


@functools.lru_cache(maxsize=None)
def kernel_lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source set has none."""
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    lib.gf3x_error_string.argtypes = [ctypes.c_int]
    lib.gf3x_error_string.restype = ctypes.c_char_p
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(name: str, argtypes: list, *args) -> None:
    """Call C entry `name` (declaring its argument types) and raise on a
    non-zero CUDA error code."""
    lib = kernel_lib()
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.gf3x_error_string(rc).decode()}")
