"""Build and load the port's hand-written CUDA kernels.

The sources under `csrc/` (K1 `route_kernels.cu`, K2 and K2'
`rspmv_kernels.cu`, K3 `wcoo_kernels.cu`, K4 `bsr_kernels.cu`, K5 and
K6 `dia_kernels.cu`, the probes' P1 and P2 `probe_kernels.cu`, and the
shared headers `value_types.cuh` and `row_io.cuh`) each expose plain
`extern "C"` launchers that return `cudaGetLastError()`, one per
variant: `sblas_<kernel>_<variant>`, the variant naming the value type
(`f32`, `f64`, `bf16`) and, for a mixed one, the second type (K1's
`bf16_i16` takes int16 indices, K2's `f32_bf16` stores bf16); K3's and
K4's `bf16_ragged` is their bf16 kernel for any stride and alignment,
where `bf16` needs 16-byte rows and bases.  K1's transposed store, its
second body, has launchers of its own (`lane_shuffle_transposed`).  K1,
K2 and K6 are launched with programmatic dependent launch
(`row_io.cuh`).  At first
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

from .utils import trace
from .utils.errors import KernelError, ShapeError, require

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("route_kernels.cu", "rspmv_kernels.cu", "wcoo_kernels.cu",
           "bsr_kernels.cu", "dia_kernels.cu", "probe_kernels.cu")
HEADERS = ("value_types.cuh", "row_io.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

_p, _i64, _f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# kernel -> (argument types before the stream, its variants)
LAUNCHERS = {
    "lane_shuffle": ([_p, _p, _p, _i64], ("f32", "f64", "bf16", "bf16_i16")),
    "lane_shuffle_transposed": ([_p, _p, _p, _i64, _i64, _i64],
                                ("f32", "f64", "bf16", "bf16_i16")),
    "slab_gather": ([_p] * 5 + [_i64], ("f32", "f64", "bf16", "f32_bf16")),
    "tile_gather": ([_p] * 4 + [_i64], ("f32", "f64", "bf16", "f32_bf16")),
    "window_reduce": ([_p] * 11 + [_i64] * 7 + [_f64, _f64],
                      ("f32", "f64", "bf16", "bf16_ragged")),
    "bell_spmm": ([_p] * 5 + [_i64] * 5 + [_f64, _f64],
                  ("f32", "f64", "bf16", "bf16_ragged")),
    "dia_spmm": ([_p] * 5 + [_i64] * 8 + [_f64, _f64], ("f32", "f64")),
    "dia_spmv": ([_p] * 5 + [_i64] * 4 + [_f64, _f64], ("f32", "f64")),
    "stage_fuse_gather": ([_p] * 6 + [_i64], ("f32", "f64")),
    "window_lane_gather": ([_p] * 4 + [_i64, _i64], ("f32", "f64")),
}

# host-side queries a wrapper asks before it launches: name -> argument
# types (returning int)
QUERIES = {
    # the body `sblas_window_reduce_bf16_ragged` runs (an index into
    # `ops.wcoo.RAGGED_BODIES`): B, C, out, ldb, k0, ldo
    "sblas_window_reduce_bf16_ragged_body": [_p] * 3 + [_i64] * 3,
    # the body `sblas_bell_spmm_f64` runs (an index into
    # `ops.bsr_pallas.F64_BODIES`): B, C, out, k
    "sblas_bell_spmm_f64_body": [_p] * 3 + [_i64],
    # the depth of K4[f64]'s mma.sync shape (`ops.bsr_pallas.f64_mma_shape`)
    "sblas_bell_spmm_f64_mma": [],
}

_lib: Optional[ctypes.CDLL] = None

# launches since the last clear, by launcher name (one count per variant;
# each wrapper's own `launches` counts all of its variants)
LAUNCHED: Counter = Counter()
# launches by kernel body, for a kernel with several bodies
# (`window_reduce_bf16_ragged.masked` / `.ring`, `bell_spmm_f64.dmma` /
# `.dmma_unpaired`)
BODIES: Counter = Counter()


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
    `nvcc -c` per source, run in parallel, then one link.  Each compile's
    `-Xptxas -v` report (registers, spills) is kept beside the library
    (`ptxas_report`)."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{name}.o" for name in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 os.path.join(CSRC_DIR, name), "-o", obj]
                for name, obj in zip(SOURCES, objs)]
    try:
        # every compile runs to its end before any result is looked at
        with ThreadPoolExecutor(len(compiles)) as pool:
            done = list(pool.map(_run, compiles))
        for cmd, proc in zip(compiles, done):
            _check(cmd, proc)
        with open(so + ".ptxas", "w") as fh:
            fh.write("".join(proc.stderr for proc in done))
        link = [nvcc, "-shared", "-o", tmp, *objs]
        _check(link, _run(link))
        os.replace(tmp, so)   # atomic: a concurrent build never sees a partial .so
    finally:
        for path in objs:
            if os.path.exists(path):
                os.remove(path)
    return so


def build_copy(stem: str, src: str) -> tuple:
    """Build a copy of a kernel source, e.g. one of the tools' variants:
    `src` is written to `_build/<stem>.cu` (it may include the headers of
    `csrc/`) and compiled with `-Xptxas -v` into `_build/<stem>.so`.
    Returns (the library's path, or None if nvcc refused the copy; the
    compiler's report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, f"{stem}.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as fh:
        fh.write(src)
    proc = _run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC_DIR,
                 "-shared", cu, "-o", so])
    return (so if proc.returncode == 0 else None), proc.stderr


def ptxas_report() -> Optional[str]:
    """The `-Xptxas -v` report of the library `build` made for the current
    sources, or None where it was built without one."""
    path = library_path() + ".ptxas"
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return fh.read()


def kernel_resources(report: str, fragment: str) -> list:
    """Each kernel of a `-Xptxas -v` report whose (mangled) name holds
    `fragment`: dicts of its name, registers a thread and spill bytes
    (stores, loads), in the report's order."""
    found, name = [], None
    for line in report.splitlines():
        text = line.strip()
        if text.startswith("ptxas info") and "Function properties for" in text:
            name, spill = text.rsplit(" ", 1)[-1], (0, 0)
        elif name and "spill stores" in text:
            words = text.replace(",", "").split()
            spill = (int(words[words.index("spill") - 2]),
                     int(words[words.index("loads") - 3]))
        elif name and text.startswith("ptxas info") and "Used" in text:
            words = text.replace(",", "").split()
            regs = int(words[words.index("registers") - 1])
            if fragment in name:
                found.append(dict(name=name, registers=regs,
                                  spill_stores=spill[0],
                                  spill_loads=spill[1]))
            name = None
    return found


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
        built = not os.path.exists(library_path())
        with trace.span("sblas.kernels.load", built=built):
            lib = ctypes.CDLL(build())
        if built:
            trace.count("library_builds")
        for name, (types, variants) in LAUNCHERS.items():
            for sfx in variants:
                fn = getattr(lib, f"sblas_{name}_{sfx}")
                fn.argtypes = types + [_p]    # the stream last
                fn.restype = ctypes.c_int
        for name, types in QUERIES.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is what a kernel takes: a contiguous CUDA tensor of
    `dtype` and `shape` on `device`."""
    # every wrapper checks its operands on each launch: the messages are
    # formatted only for an operand that fails
    if (t.device == device and t.dtype == dtype and t.shape == shape
            and t.is_contiguous()):
        return
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
    if variant not in LAUNCHERS[kernel][1]:
        raise KernelError(f"kernel {kernel} has no {variant} variant (it "
                          f"has {', '.join(LAUNCHERS[kernel][1])})")
    return f"sblas_{kernel}_{variant}"


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call launcher `fn_name` (see `launcher`) with tensor pointers / ints
    on the current stream of `device`; raise on a refused launch."""
    lib = library()
    with trace.span("sblas.launch", launcher=fn_name), \
            torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args]
        rc = getattr(lib, fn_name)(*c_args, stream)
    if rc != 0:
        raise KernelError(f"{fn_name} launch failed: cudaError {rc}")
    LAUNCHED[fn_name] += 1

