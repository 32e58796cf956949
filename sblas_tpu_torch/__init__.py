"""sblas_tpu_torch — the PyTorch/CUDA port of sblas_tpu, for NVIDIA Hopper.

Same containers, Matrix-Market ingest, plans and `y' = beta*y + alpha*A@x`
semantics as the JAX package `sblas_tpu`, which stays in the repository as
the reference.  Plans are frozen dataclasses of torch tensors on an
explicit device; the kernels the JAX package wrote in Pallas for the TPU
are CUDA C++ for `sm_90a` here (`csrc/`, built with nvcc at first use).
This package imports torch and never jax.

Ported so far: every single-device plan and op (`ops.make_plan` ->
`ops.spmv` / `ops.spmm`), the distribution layer over `torch.distributed`
(`partition`, `parallel`), and the CLIs.  ROADMAP.md lists the rest.
"""

from .config import DEFAULT, SBlasConfig  # noqa: F401
from .containers import (CooMatrix, CscMatrix, CsrMatrix,  # noqa: F401
                         DenseMatrix, DenseVector, MajorOrder, SharePolicy)
from .utils.errors import (FormatError, KernelError,  # noqa: F401
                           LayoutError, NotPortedError, PartitionError,
                           PlanError, SBlasError, ShapeError)
from .utils.verify import VerifyReport, assert_equal, check_equal  # noqa: F401

__version__ = "0.1.0"
