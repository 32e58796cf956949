"""Error handling for the framework.

The reference fails hard with `exit(-1)` macros (`CUDA_SAFE_CALL`,
`CUDA_CHECK_ERROR`, `CHECK_CUSPARSE`, `CHECK_NCCL`, utility.h:27-83).  In a
Python framework the idiomatic equivalent is a typed exception hierarchy:
callers can catch, tests can assert on, and nothing calls `exit()`.
"""

from __future__ import annotations


class SBlasError(Exception):
    """Base class for all framework errors."""


class ShapeError(SBlasError):
    """Operand shapes are incompatible (analog of the reference's dimension
    asserts, e.g. spmm.h:88-90)."""


class LayoutError(SBlasError):
    """Unsupported dense-matrix major order for an op (analog of the
    reference's col-major requirement check, spmm.h:91-98)."""


class FormatError(SBlasError):
    """Malformed Matrix-Market input (analog of mmio.h error codes
    MM_PREMATURE_EOF / MM_NO_HEADER / MM_UNSUPPORTED_TYPE)."""


class PartitionError(SBlasError):
    """Invalid distribution request (bad shard count, unsupported policy)."""


class PlanError(SBlasError):
    """A plan cannot be built for this matrix (size guards, int32 index
    overflow, layout preconditions).  Unlike a plain assert this survives
    `python -O`, so plan-size overflows fail loudly instead of silently
    corrupting int32 slot arithmetic."""


def require(cond: bool, exc: type, msg: str) -> None:
    """Check a precondition; raise `exc(msg)` when it fails."""
    if not cond:
        raise exc(msg)


class KernelError(SBlasError):
    """A hand-written CUDA kernel cannot run: `nvcc` is missing, the build
    failed, the launch was refused, or an operand is not what the kernel
    takes (device, dtype, contiguity).  There is no fallback path."""
