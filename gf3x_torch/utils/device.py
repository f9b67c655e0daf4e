"""Build and load the port's CUDA kernel library.

Every `gf3x_torch/csrc/*.cu` source is compiled by `nvcc` for `sm_90a`
(one `nvcc` per source, all started together) and linked into ONE shared
library with a plain C interface, loaded with `ctypes`. The library lands
in `gf3x_torch/_build/<hash of sources and flags>/` (ignored by git) and
is built at its first use, so a fresh checkout on a machine with the CUDA
toolkit builds it by itself; nothing is built or loaded when the package
is imported.

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
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")


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
    """Compile every source into `out`, one nvcc process per source running
    side by side, then link; the compilers' reports (registers, shared
    memory, spills per kernel) are kept beside it as build.log."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        srcs = [p for p in _sources() if p.suffix == ".cu"]
        objs = [os.path.join(tmpdir, p.stem + ".o") for p in srcs]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", str(src),
                                   "-o", obj], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        tmp = os.path.join(tmpdir, _LIB_NAME)
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        (out.parent / "build.log").write_text("".join(logs))
        failed = [(src.name, p.returncode) for src, p in zip(srcs, procs)
                  if p.returncode != 0]
        if failed or link.returncode != 0:
            raise RuntimeError(f"nvcc failed {failed or link.returncode}:\n"
                               + "".join(logs))
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none


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
