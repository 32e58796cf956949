"""Build and load the port's hand-written CUDA kernels.

The sources under `csrc/` (K1 `route_kernels.cu`, K2 and K2'
`rspmv_kernels.cu`, K3 `wcoo_kernels.cu`, K4 `bsr_kernels.cu`, the
probes' P1 and P2 `probe_kernels.cu`, and the shared header
`value_types.cuh`) each expose
plain `extern "C"` launchers that return `cudaGetLastError()`, one per
variant: `sblas_<kernel>_<variant>`, the variant naming the value type
(`f32`, `f64`, `bf16`) and, for a mixed one, the second type (K1's
`bf16_i16` takes int16 indices, K2's `f32_bf16` stores bf16).  At first
use each source is compiled by its own `nvcc` for Hopper (`sm_90a`), all
started together, and the objects are linked into one shared library,
loaded with ctypes: nothing is built or imported when the package is
imported, so the CPU tests never need a compiler.  The library lands in
`_build/` (git-ignored) under a name keyed on the sources' content and
the flags, so an edited source rebuilds and an unchanged one loads in
milliseconds.

There is no fallback: a missing `nvcc` or a failed build raises
`KernelError`.  Wrappers launch on PyTorch's current stream and allocate
their outputs with torch; the kernels allocate nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from .utils.errors import KernelError, ShapeError, require

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("route_kernels.cu", "rspmv_kernels.cu", "wcoo_kernels.cu",
           "bsr_kernels.cu", "probe_kernels.cu")
HEADERS = ("value_types.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

_p, _i64, _f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# kernel -> (argument types before the stream, its variants)
LAUNCHERS = {
    "lane_shuffle": ([_p, _p, _p, _i64], ("f32", "f64", "bf16", "bf16_i16")),
    "slab_gather": ([_p] * 5 + [_i64], ("f32", "f64", "bf16", "f32_bf16")),
    "tile_gather": ([_p] * 4 + [_i64], ("f32", "f64", "bf16", "f32_bf16")),
    "window_reduce": ([_p] * 10 + [_i64] * 5, ("f32", "f64", "bf16")),
    "bell_spmm": ([_p] * 5 + [_i64] * 5 + [_f64, _f64], ("f32", "f64", "bf16")),
    "stage_fuse_gather": ([_p] * 6 + [_i64], ("f32", "f64")),
    "window_lane_gather": ([_p] * 4 + [_i64, _i64], ("f32", "f64")),
}

_lib: Optional[ctypes.CDLL] = None

# launches since the last clear, by launcher name (one count per variant;
# each wrapper's own `launches` counts all of its variants)
LAUNCHED: Counter = Counter()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                      "kernels cannot be built")


def library_path() -> str:
    """Path of the built library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libsblas_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists: one
    `nvcc -c` per source, run in parallel, then one link."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{name}.o" for name in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, name),
                 "-o", obj] for name, obj in zip(SOURCES, objs)]
    try:
        # every compile runs to its end before any result is looked at
        with ThreadPoolExecutor(len(compiles)) as pool:
            done = list(pool.map(_run, compiles))
        for cmd, proc in zip(compiles, done):
            _check(cmd, proc)
        link = [nvcc, "-shared", "-o", tmp, *objs]
        _check(link, _run(link))
        os.replace(tmp, so)   # atomic: a concurrent build never sees a partial .so
    finally:
        for path in objs:
            if os.path.exists(path):
                os.remove(path)
    return so


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def _check(cmd, proc: subprocess.CompletedProcess) -> None:
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, (types, variants) in LAUNCHERS.items():
            for sfx in variants:
                fn = getattr(lib, f"sblas_{name}_{sfx}")
                fn.argtypes = types + [_p]    # the stream last
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is what a kernel takes: a contiguous CUDA tensor of
    `dtype` and `shape` on `device`."""
    require(t.device == device, KernelError,
            f"{name} is on {t.device}, expected {device}")
    require(t.dtype == dtype, KernelError,
            f"{name} has dtype {t.dtype}, expected {dtype}")
    require(tuple(t.shape) == tuple(shape), ShapeError,
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    require(t.is_contiguous(), KernelError, f"{name} is not contiguous")


def value_suffix(dtype: torch.dtype) -> str:
    require(dtype in SUFFIX, KernelError,
            f"kernels take float32, float64 or bfloat16 values, got {dtype}")
    return SUFFIX[dtype]


def launcher(kernel: str, variant: str) -> str:
    """The launcher's name, `sblas_<kernel>_<variant>`; raises
    `KernelError` for a variant the kernel does not have."""
    require(variant in LAUNCHERS[kernel][1], KernelError,
            f"kernel {kernel} has no {variant} variant (it has "
            f"{', '.join(LAUNCHERS[kernel][1])})")
    return f"sblas_{kernel}_{variant}"


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call launcher `fn_name` (see `launcher`) with tensor pointers / ints
    on the current stream of `device`; raise on a refused launch."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args]
        rc = getattr(lib, fn_name)(*c_args, stream)
    require(rc == 0, KernelError,
            f"{fn_name} launch failed: cudaError {rc}")
    LAUNCHED[fn_name] += 1
