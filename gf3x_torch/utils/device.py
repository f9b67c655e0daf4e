"""Build and load the port's CUDA kernel library.

Every `gf3x_torch/csrc/*.cu` source is compiled by `nvcc` for `sm_90a`
(one `nvcc` per source, all started together) and linked into ONE shared
library: C entry points, one per kernel, and a CPython extension module
(`csrc/binding.cu`) whose functions call them, loaded by path. It lands in
`gf3x_torch/_build/<hash of sources and flags>/` (ignored by git) and
is built at its first use, so a fresh checkout on a machine with the CUDA
toolkit builds it by itself; nothing is built or loaded when the package
is imported.

`--fmad=false` is part of the build: the LDPC kernel must reproduce the
plain version's float32 roundings bit for bit, and nvcc otherwise contracts
`α·p·m − c2v` into one fused multiply-add.

Each C entry point takes the stream as its last argument, launches on it
and returns `cudaGetLastError()`; `launch` raises when that is not 0.

`launch` is the one call path of every wrapper, so its host cost is paid
on every kernel launch: an entry is resolved once per process and converts
its own arguments (no ctypes); it compares the tensors' device with the
current one itself, and only where they differ does `launch` switch device
and call again; the stream is read as a raw pointer, with no
`torch.cuda.Stream` object.

The card's limits that the kernels' launch rules size blocks by (an H100,
sm_90) are defined here, once, beside `sm_count`, the SM count of a device.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
from pathlib import Path

import torch

__all__ = ["CSRC", "NVCC_FLAGS", "kernel_lib", "library_path", "launch",
           "sm_count", "SMEM_BLOCK", "SMEM_SM", "SMEM_RESERVED", "WARPS_SM",
           "BLOCKS_SM", "H100_SMS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = CSRC.parent / "_build"
_LIB_NAME = "libgf3x_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
              "-I" + sysconfig.get_paths()["include"])


SMEM_BLOCK = 232_448     # dynamic shared memory one block may use (227 KB)
SMEM_SM = 233_472        # shared memory of one SM (228 KB)
SMEM_RESERVED = 1_024    # per resident block
WARPS_SM = 32            # resident warps per SM at ≤ 64 registers a thread
                         # (kernels 2 and A's __launch_bounds__(1024, 1))
BLOCKS_SM = 32           # resident blocks per SM
H100_SMS = 132           # the SMs of an H100 SXM, the launch rules' default


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
def kernel_lib():
    """The kernel library as a loaded extension module, built first if this
    source set has none."""
    path = library_path()
    if not path.exists():
        _build(path)
    spec = importlib.util.spec_from_file_location("gf3x_kernels", path)
    lib = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lib)
    return lib


# torch's own getter of a device's current cudaStream_t, called with no
# Python frame around it; CUDA builds of torch have it, and only a launch,
# which needs a card, calls it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_ENTRIES: dict = {}   # entry name → the library's function
_OTHER_DEVICE = -1    # an entry's return when its device is not current


def _entry(name: str):
    fn = _ENTRIES[name] = getattr(kernel_lib(), name)
    return fn


def launch(name: str, index: int, *args) -> None:
    """Call entry `name` on CUDA device `index` with `args` (addresses and
    numbers) and that device's current stream (its last parameter); raise
    on a non-zero CUDA error code. The entry launches nothing when `index`
    is not the current device; then the device is switched for a second
    call."""
    fn = _ENTRIES.get(name) or _entry(name)
    rc = fn(*args, _raw_stream(index), index)
    if rc == _OTHER_DEVICE:
        with torch.cuda.device(index):
            rc = fn(*args, _raw_stream(index), index)
        if rc == _OTHER_DEVICE:
            raise RuntimeError(f"{name}: device {index} is not current "
                               "after switching to it")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{kernel_lib().gf3x_error_string(rc)}")
