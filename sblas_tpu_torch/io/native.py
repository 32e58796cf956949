"""ctypes bridge to the repository's plan-time C++ library (`native/`).

The port loads the same `native/libsblasio.so` the JAX package loads (the
library is shared, not copied), building it with `make -C native` on first
use when any linked source is newer than the library.  It provides the
Matrix-Market parser (native/mtxparse.cpp) and the route planner's edge
colouring, fused route level and bucketed scatter (native/route.cpp).
Callers fall back to numpy when it is unavailable; the routed plan at 1M
rows needs it to finish in seconds (`available()` says whether it
loaded).  Parity contract: byte-identical results to the numpy paths.

Recorded (`utils/trace.py`): the first load as span `sblas.native.load`
(attributes `built`, whether `make` ran, and `available`), each `make`
as counter `library_builds`, and each fallback to numpy that the
library's absence caused as counter `native_unavailable`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from typing import Optional

import numpy as np

from ..utils import trace

# repo checkouts find native/ two levels up; installed wheels run the
# numpy fallbacks unless SBLAS_NATIVE_DIR points at a native/ checkout
_NATIVE_DIR = os.environ.get(
    "SBLAS_NATIVE_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libsblasio.so"))

_lib: Optional[ctypes.CDLL] = None
_tried = False

FIELD_CODES = {"pattern": 0, "real": 1, "integer": 1, "complex": 2}


def _lib_sources(ndir: str):
    """The inputs that can change libsblasio.so: every .cpp named in the
    Makefile's link line (parsed, not hardcoded — a source added to the
    Makefile but not to a Python allowlist would otherwise reinstate
    the silent-stale-.so failure), every header, and the Makefile
    itself (a flag change must rebuild too).  Unrelated tools in
    native/ (bench_color.cpp) are not in the Makefile and so do not
    trigger rebuilds."""
    import glob
    import re
    srcs = {"Makefile"}
    try:
        with open(os.path.join(ndir, "Makefile")) as fh:
            srcs.update(re.findall(r"\b[\w./-]+\.cpp\b", fh.read()))
    except OSError:
        pass
    srcs.update(os.path.basename(h)
                for h in glob.glob(os.path.join(ndir, "*.h")))
    return srcs


def _stale() -> bool:
    """True when any linked native source (or a header, or the Makefile)
    is newer than the built library — a pre-existing .so from an older
    checkout would otherwise silently lack newer symbols and every fast
    path would fall back with no warning."""
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    ndir = os.path.abspath(_NATIVE_DIR)
    for f in _lib_sources(ndir):
        try:
            if os.path.getmtime(os.path.join(ndir, f)) > lib_mtime:
                return True
        except OSError:
            continue
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    built = _stale() and os.environ.get("SBLAS_NO_NATIVE_BUILD") != "1"
    with trace.span("sblas.native.load", built=built) as sp:
        if built:
            trace.count("library_builds")
            try:
                subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR),
                                "-B"],
                               capture_output=True, timeout=120, check=True)
            except (OSError, subprocess.SubprocessError):
                pass  # an existing (possibly stale) lib still loads
        _lib = _open()
        sp.set(available=_lib is not None)
    return _lib


def _open() -> Optional[ctypes.CDLL]:
    """The library loaded, its functions typed; None when absent."""
    lib = None
    for attempt in range(3):
        if not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            break
        except OSError:
            # another process may be relinking the library this moment
            # (parallel test workers each find it stale): wait for it
            time.sleep(1.0 + attempt)
    if lib is None:
        return None
    lib.sblas_mtx_parse.restype = ctypes.c_int
    lib.sblas_mtx_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.sblas_mtx_count_lines.restype = ctypes.c_int64
    lib.sblas_mtx_count_lines.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.sblas_edge_color.restype = ctypes.c_int
    lib.sblas_edge_color.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    if hasattr(lib, "sblas_edge_color_blocked"):
        lib.sblas_edge_color_blocked.restype = ctypes.c_int
        lib.sblas_edge_color_blocked.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
    if hasattr(lib, "sblas_route_level"):
        lib.sblas_route_level.restype = ctypes.c_int
        lib.sblas_route_level.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
    for suffix, ct in (("i8", ctypes.c_int8), ("i32", ctypes.c_int32),
                       ("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fn = getattr(lib, f"sblas_scatter_{suffix}", None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int64, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_int32),
                           ctypes.POINTER(ct), ctypes.POINTER(ct)]
    return lib


_SCATTER_SUFFIX = {np.dtype(np.int8): "i8", np.dtype(np.bool_): "i8",
                   np.dtype(np.int32): "i32", np.dtype(np.float32): "f32",
                   np.dtype(np.float64): "f64"}


def scatter(out: np.ndarray, addr: np.ndarray, vals) -> np.ndarray:
    """`out[addr] = vals` with cache-resident write windows (route.cpp).

    This host pays ~14x for random memory access: numpy's fancy scatter of
    4.2M int32 to random addresses measured 4.9 s where the bucketed native
    path is ~3 streaming passes.  Falls back to the numpy scatter when the
    native library is unavailable or the dtype has no native kernel.
    Duplicate addresses keep numpy's last-write-wins semantics.  Returns
    `out` (modified in place)."""
    suffix = _SCATTER_SUFFIX.get(out.dtype)
    lib = _load() if (suffix is not None
                      and os.environ.get("SBLAS_NO_NATIVE") != "1") else None
    fn = getattr(lib, f"sblas_scatter_{suffix}", None) if lib else None
    if suffix is not None and lib is None:
        trace.count("native_unavailable")
    addr = np.asarray(addr)
    if (fn is None or not out.flags.c_contiguous or out.ndim != 1
            or addr.dtype.kind != "i" or len(addr) == 0):
        # boolean masks and other fancy-index forms keep numpy semantics
        out[addr] = vals
        return out
    if int(addr.min()) < 0 or int(addr.max()) >= out.shape[0]:
        # match numpy's IndexError instead of corrupting memory natively
        out[addr] = vals
        return out
    addr32 = np.ascontiguousarray(addr, dtype=np.int32)
    vals_c = np.ascontiguousarray(
        np.broadcast_to(vals, addr32.shape), dtype=out.dtype)
    ct = {"i8": ctypes.c_int8, "i32": ctypes.c_int32,
          "f32": ctypes.c_float, "f64": ctypes.c_double}[suffix]
    fn(len(addr32), out.shape[0],
       addr32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
       vals_c.ctypes.data_as(ctypes.POINTER(ct)),
       out.ctypes.data_as(ctypes.POINTER(ct)))
    return out


def edge_color(src: np.ndarray, dst: np.ndarray, n_left: int, n_right: int,
               d: int, n_blocks: int = 1) -> np.ndarray:
    """Color a d-regular bipartite multigraph with d colors (native/route.cpp).

    With `n_blocks` > 1 the graph is block-diagonal: block b owns the
    contiguous edge slice [b*epb, (b+1)*epb) and node ranges
    [b*npb, (b+1)*npb) on both sides — each block is colored as an
    independent cache-resident subproblem (the route recursion's levels
    below the first have exactly this shape).

    Raises RuntimeError when the native library is unavailable or the input
    is not d-regular (caller may fall back to the pure-python path)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native edge coloring unavailable")
    src32 = np.ascontiguousarray(src, dtype=np.int32)
    dst32 = np.ascontiguousarray(dst, dtype=np.int32)
    out = np.empty(len(src32), dtype=np.int32)
    if n_blocks > 1 and hasattr(lib, "sblas_edge_color_blocked"):
        if (n_left % n_blocks or n_right % n_blocks
                or len(src32) % n_blocks):
            raise RuntimeError("blocked edge coloring: uneven blocks")
        rc = lib.sblas_edge_color_blocked(
            n_blocks, n_left // n_blocks, n_right // n_blocks,
            len(src32) // n_blocks, d,
            src32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dst32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    else:
        rc = lib.sblas_edge_color(
            n_left, n_right, len(src32), d,
            src32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dst32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"native edge coloring failed with code {rc}")
    return out


def route_level(p: np.ndarray, bs: int, mix_max: int):
    """One fused route-recursion level (native/route.cpp): coloring +
    source lane shuffle + next-level permutation (or mix table) from the
    block-local permutation `p`, each table one streaming pass.

    Returns (color, idx1, qrho) int32 arrays of len(p); `qrho` is the mix
    table rho_local when bs//128 <= mix_max, else the next level's
    permutation q.  Raises RuntimeError when the native library is
    unavailable or the input is rejected (caller falls back to numpy)."""
    lib = _load() if os.environ.get("SBLAS_NO_NATIVE") != "1" else None
    if lib is None or not hasattr(lib, "sblas_route_level"):
        raise RuntimeError("native route level unavailable")
    p32 = np.ascontiguousarray(p, dtype=np.int32)
    n = len(p32)
    color = np.empty(n, dtype=np.int32)
    idx1 = np.empty(n, dtype=np.int32)
    qrho = np.empty(n, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.sblas_route_level(
        n, bs, mix_max, p32.ctypes.data_as(i32p),
        color.ctypes.data_as(i32p), idx1.ctypes.data_as(i32p),
        qrho.ctypes.data_as(i32p))
    if rc != 0:
        raise RuntimeError(f"native route level failed with code {rc}")
    return color, idx1, qrho


def available() -> bool:
    """Whether the library loaded (and SBLAS_NO_NATIVE is not 1); a False
    answer counts as a fallback (`native_unavailable`)."""
    ok = (os.environ.get("SBLAS_NO_NATIVE") != "1") and _load() is not None
    if not ok:
        trace.count("native_unavailable")
    return ok


def parse_coordinate(path: str, offset: int, nnz: int, field: str):
    """Parse `nnz` coordinate entries; returns (rows, cols, vals[, imag]).

    Raises RuntimeError on parse failure (caller may fall back to numpy).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float64)
    want_imag = field == "complex"
    imag = np.empty(nnz, dtype=np.float64) if want_imag else None
    rc = lib.sblas_mtx_parse(
        path.encode(), offset, nnz, FIELD_CODES[field],
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        imag.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if want_imag else None)
    if rc != 0:
        raise RuntimeError(f"native mtx parse failed with code {rc}")
    return (rows, cols, vals, imag) if want_imag else (rows, cols, vals)
