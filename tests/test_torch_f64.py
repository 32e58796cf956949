"""f64 values in the port: the plans chip_smoke's `[f64]` phases take,
kernel K4's f64 wrapper on the CPU against the JAX package's Pallas
kernel (interpret mode), and the tooling around K4[f64]'s `mma.sync` body
that a CPU can check (the `-Xptxas -v` reader, the variant tool's
patches)."""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sblas_tpu.ops as jops
from sblas_tpu.containers import DenseMatrix as JDenseMatrix
from sblas_tpu.io import generate as jgen
from sblas_tpu.ops import bsr as jb
from sblas_tpu.ops.bsr_pallas import spmm_bsr_pallas as j_spmm_bsr_pallas
import sblas_tpu_torch.ops as tops
from sblas_tpu_torch import _kernels
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.io import generate as tgen
from sblas_tpu_torch.ops import bsr_pallas as tbp
from sblas_tpu_torch.tools import k4_f64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


@pytest.mark.parametrize("n,kind", [(80_000, "bsr"), (90_449, "dia")])
def test_f64_bell_spmm_choice_follows_the_byte_cap(n, kind, monkeypatch):
    """The band-73 structure's SpMM plan at f64: BELL up to the byte cap
    (`_BSR_DIA_SPMM_BYTES`, 256 MiB at 8 bytes a stored value), DIA at
    the full 90,449 rows, where f32 keeps BELL; the JAX package makes the
    same choice (its plan builders stubbed, so no plan is built)."""
    A = tgen.fem_banded_like(n=n)
    assert tops.choose_kind(A, torch.float64, op="spmm") == kind
    assert tops.choose_kind(A, torch.float32, op="spmm") == "bsr"
    for name, cls in (("bsr", jops.BsrPlan), ("dia", jops.DiaPlan)):
        monkeypatch.setattr(cls, "from_csr", classmethod(
            lambda c, A, name=name, **kw: name))
    J = jgen.fem_banded_like(n=n)
    assert jops.make_plan(J, dtype=jnp.float64, op="spmm") == kind
    assert jops.make_plan(J, dtype=jnp.float32, op="spmm") == "bsr"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields_equal(a, b) -> None:
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        elif isinstance(x, tuple) and x and isinstance(x[0], torch.Tensor):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and torch.equal(u, v), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kind,matrix", [
    ("routed", lambda: tgen.webbase_like(n=20_000, avg_deg=4.0,
                                         dtype=np.float32)),
    ("wcoo", lambda: tgen.webbase_like(n=20_000, avg_deg=4.0,
                                       dtype=np.float32)),
    ("bsr", lambda: tgen.fem_banded_like(n=3000, half_band=36,
                                         dtype=np.float32))])
def test_cast_plan_is_make_plans_f64_plan(kind, matrix):
    """chip_smoke's `cast_plan` of an f32 plan is, field by field, the
    plan `make_plan` builds at f64 for the same f32-valued matrix."""
    cast_plan = _chip_smoke().cast_plan
    A = matrix()
    p32 = tops.make_plan(A, dtype=torch.float32, force=kind, device="cpu")
    p64 = tops.make_plan(A, dtype=torch.float64, force=kind, device="cpu")
    got = cast_plan(p32, torch.float64)
    assert got.dtype == torch.float64
    _fields_equal(got, p64)


@pytest.mark.parametrize("k,offset", [(7, 1), (256, 1), (17, 0)])
def test_k4_f64_into_an_offset_out_matches_pallas_kernel(k, offset):
    """`bell_spmm(..., out=)` at f64 writes into `out` (here a view
    `offset` elements into its storage, B and C likewise) what the JAX
    package's Pallas kernel computes (interpret mode), within 1e-12."""
    A = jgen.fem_banded_like(n=700, half_band=9)
    jp = jb.BsrPlan.from_csr(A, dtype=jnp.float64)
    tp = tops.make_plan(_port(A), dtype=torch.float64, force="bsr",
                        device="cpu")
    B = JDenseMatrix.random(A.width, k).values
    C = JDenseMatrix.constant(A.height, k, 1.0).values
    want = np.asarray(j_spmm_bsr_pallas(jp, jnp.asarray(B), 3.0, 4.0,
                                        jnp.asarray(C)))

    def at_offset(a):
        buf = torch.zeros(a.size + offset, dtype=torch.float64)
        return buf[offset:].view(a.shape).copy_(torch.from_numpy(a))

    Bt, Ct, out = at_offset(B), at_offset(C), at_offset(np.zeros_like(C))
    got = tbp.bell_spmm(tp.vals, tp.bcol, Bt, Ct, 3.0, 4.0, out=out)
    assert got.data_ptr() == out.data_ptr()
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-12, atol=1e-12)


REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121bell_spmm_dmma_kernelILb1EEEvPKdPKiS3_S3_Pdilllliidd' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121bell_spmm_dmma_kernelILb1EEEvPKdPKiS3_S3_Pdilllliidd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 214 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121bell_spmm_dmma_kernelILb0EEEvPKdPKiS3_S3_Pdilllliidd' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121bell_spmm_dmma_kernelILb0EEEvPKdPKiS3_S3_Pdilllliidd
    24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123bell_spmm_tf32x3_kernelILb1EEEvPKfPKiS3_S3_Pfiilllff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123bell_spmm_tf32x3_kernelILb1EEEvPKfPKiS3_S3_Pfiilllff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 424 bytes cmem[0]
"""


def test_kernel_resources_reads_a_ptxas_report():
    got = _kernels.kernel_resources(REPORT, "bell_spmm_dmma_kernel")
    assert [(r["registers"], r["spill_stores"], r["spill_loads"])
            for r in got] == [(214, 0, 0), (255, 16, 8)]
    assert all("bell_spmm_dmma_kernel" in r["name"] for r in got)
    assert k4_f64.dmma_resources(REPORT) == [(214, 0, 0), (255, 16, 8)]
    assert _kernels.kernel_resources(REPORT, "no_such_kernel") == []


@pytest.mark.parametrize("variant", sorted(k4_f64.VARIANTS))
def test_k4_f64_variant_patches_match_the_source(variant):
    """Every copy the K4[f64] tool builds is made from the current
    csrc/bsr_kernels.cu: each patch matches exactly once."""
    patches = k4_f64.VARIANTS[variant]
    copy = k4_f64.patched_source(patches)
    assert "sblas_bell_spmm_f64" in copy
    assert (copy == k4_f64.patched_source([])) == (not patches)


def test_k4_f64_bodies_are_named():
    assert tbp.F64_BODIES == ("dmma", "dmma_unpaired")
    assert "sblas_bell_spmm_f64_body" in _kernels.QUERIES
    assert "sblas_bell_spmm_f64_mma" in _kernels.QUERIES
