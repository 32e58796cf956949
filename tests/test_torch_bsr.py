"""Port parity: the BELL plan and its ops, and kernel K4's plain version,
against `sblas_tpu.ops.bsr` and `sblas_tpu.ops.bsr_pallas` (whose Pallas
kernel runs in interpret mode on the CPU, as tests/test_bsr_pallas.py
runs it).

Plan arrays are byte-identical.  Sums run in another order (batched
matmuls, einsum), so f64 results agree to 1e-12 relative; f32 results
meet the numpy oracle at the reference's 1e-3."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas_tpu.containers import DenseMatrix as JDenseMatrix
from sblas_tpu.containers import DenseVector as JDenseVector
from sblas_tpu.io import generate as jgen
from sblas_tpu.ops import bsr as jb
from sblas_tpu.ops.bsr_pallas import spmm_bsr_pallas as j_spmm_bsr_pallas
from sblas_tpu.ops.cpu_reference import spmm_cpu, spmv_cpu
import sblas_tpu_torch.ops as tops
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.ops import bsr as tb
from sblas_tpu_torch.ops import bsr_pallas as tbp
from sblas_tpu_torch.utils.errors import KernelError
from sblas_tpu_torch.utils.verify import check_equal

MATRICES = {
    "banded": lambda: jgen.fem_banded_like(n=700, half_band=9),
    "blocky": lambda: jgen.uniform_random(300, 260, nnz_per_row=5, seed=3),
    "tiny": lambda: jgen.uniform_random(5, 7, 2, seed=4),
    "skew": lambda: jgen.adversarial_skew(m=96, n=96, heavy_rows=1,
                                          heavy_nnz=64, light_nnz=1),
}
ALPHA, BETA = 3.0, 4.0


@functools.lru_cache(maxsize=None)
def _matrix(name):
    return MATRICES[name]()


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


@functools.lru_cache(maxsize=None)
def _plans(name, block=(128, 128)):
    A = _matrix(name)
    return (jb.BsrPlan.from_csr(A, dtype=jnp.float64, block=block),
            tb.BsrPlan.from_csr(_port(A), dtype=torch.float64, block=block,
                                device="cpu"))


@pytest.mark.parametrize("block", [(128, 128), (8, 128), (16, 64)])
@pytest.mark.parametrize("name", list(MATRICES))
def test_plan_arrays_match_jax_and_round_trip(name, block):
    jp, tp = _plans(name, block)
    fields = {"vals": np.asarray(jp.vals), "bcol": np.asarray(jp.bcol)}
    for f, want in fields.items():
        got = getattr(tp, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert tp.slots == jp.slots and tp.blowup == pytest.approx(jp.blowup)
    assert tb.bell_stats(_port(_matrix(name)), block) == jb.bell_stats(
        _matrix(name), block)
    back = tb.BsrPlan.from_numpy(fields, dict(shape=jp.shape, nnz=jp.nnz,
                                              block=jp.block), "cpu")
    assert torch.equal(back.vals, tp.vals) and back.block == tuple(block)


@pytest.mark.parametrize("name", list(MATRICES))
def test_spmm_spmv_bsr_match_jax_f64(name):
    A = _matrix(name)
    jp, tp = _plans(name)
    B = JDenseMatrix.random(A.width, 12)
    C = JDenseMatrix.constant(A.height, 12, 1.0)
    x = JDenseVector.random(A.width)
    y = JDenseVector.constant(A.height, 1.0)
    want = np.asarray(jb.spmm_bsr(jp, jnp.asarray(B.values), ALPHA, BETA,
                                  jnp.asarray(C.values)))
    got = tb.spmm_bsr(tp, torch.from_numpy(B.values), ALPHA, BETA,
                      torch.from_numpy(C.values)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert check_equal(got, spmm_cpu(A, B, ALPHA, BETA, C)).ok
    wv = np.asarray(jb.spmv_bsr(jp, jnp.asarray(x.values), ALPHA, BETA,
                                jnp.asarray(y.values)))
    gv = tb.spmv_bsr(tp, torch.from_numpy(x.values), ALPHA, BETA,
                     torch.from_numpy(y.values)).numpy()
    np.testing.assert_allclose(gv, wv, rtol=1e-12, atol=1e-12)
    assert check_equal(gv, spmv_cpu(A, x, ALPHA, BETA, y)).ok


@pytest.mark.parametrize("name,k,alpha,beta", [
    ("banded", 17, 3.0, 4.0), ("banded", 17, 2.5, 0.0),
    ("blocky", 33, 3.0, 4.0)])
def test_k4_plain_matches_pallas_kernel(name, k, alpha, beta):
    """Kernel K4's plain version against the JAX package's Pallas kernel
    (interpret mode), f64."""
    A = _matrix(name)
    jp, tp = _plans(name)
    B = JDenseMatrix.random(A.width, k)
    C = JDenseMatrix.random(A.height, k)
    want = np.asarray(j_spmm_bsr_pallas(jp, jnp.asarray(B.values), alpha,
                                        beta, jnp.asarray(C.values)))
    tbp.bell_spmm.launches = 0
    got = tbp.spmm_bsr_pallas(tp, torch.from_numpy(B.values), alpha, beta,
                              torch.from_numpy(C.values)).numpy()
    assert tbp.bell_spmm.launches == 0        # the CPU runs no kernel
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    plain = tbp.bell_spmm_plain(tp.vals, tp.bcol, torch.from_numpy(B.values),
                                torch.from_numpy(C.values), alpha, beta)
    np.testing.assert_array_equal(plain.numpy(), got)


def test_k4_plain_f32_meets_oracle():
    A = _matrix("banded").astype(np.float32)
    plan = tb.BsrPlan.from_csr(_port(A), dtype=torch.float32, device="cpu")
    B = JDenseMatrix.random(A.width, 256, dtype=np.float32)
    C = JDenseMatrix.constant(A.height, 256, 1.0, dtype=np.float32)
    got = tbp.spmm_bsr_pallas(plan, torch.from_numpy(B.values), ALPHA, BETA,
                              torch.from_numpy(C.values))
    assert got.dtype == torch.float32
    assert check_equal(got.numpy(), spmm_cpu(A, B, ALPHA, BETA, C),
                       relative=True).ok


@pytest.mark.parametrize("k", [255, 256])
def test_dispatcher_takes_bsr_on_cpu_at_any_k(k):
    """The K4 gate is K >= 256 *and* B on CUDA, as the JAX package's is
    K >= 256 and a TPU backend: on the CPU both take `spmm_bsr`."""
    A = _matrix("banded")
    plan = tops.make_plan(_port(A), dtype=torch.float64, op="spmm",
                          device="cpu")
    assert isinstance(plan, tops.BsrPlan)
    B = JDenseMatrix.random(A.width, k)
    tbp.bell_spmm.launches = 0
    got = tops.spmm(plan, torch.from_numpy(B.values), 2.0).numpy()
    assert tbp.bell_spmm.launches == 0
    want = np.asarray(jb.spmm_bsr(_plans("banded")[0], jnp.asarray(B.values),
                                  2.0, 0.0, jnp.zeros((A.height, k))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_k4_wrapper_refuses_a_non_cuda_device():
    _, tp = _plans("banded")
    B = torch.zeros((tp.shape[1], 4), dtype=torch.float64)
    C = torch.zeros((tp.shape[0], 4), dtype=torch.float64)
    with pytest.raises(KernelError, match="cpu or cuda"):
        tbp.bell_spmm(tp.vals.to("meta"), tp.bcol.to("meta"), B.to("meta"),
                      C.to("meta"), 1.0, 0.0)


def test_true_f32_check_is_for_cuda_only():
    tb.require_true_f32(torch.zeros(2, dtype=torch.float32))   # no raise


@pytest.mark.parametrize("block,k,on_cuda,k4", [
    ((128, 128), 256, True, True),
    ((128, 128), 255, True, False),
    ((128, 128), 256, False, False),
    ((8, 128), 256, True, False),
    ((16, 64), 512, True, False),
])
def test_k4_gate_follows_the_block_shape(block, k, on_cuda, k4):
    """`spmm` over a BELL plan takes kernel K4 only for its 128 x 128
    blocks at K >= 256 on CUDA; other blocks take `spmm_bsr`, as the CPU
    does (K4 raises for them)."""
    _, tp = _plans("banded", block)
    assert tb.takes_k4(tp, k, on_cuda) is k4


@pytest.mark.parametrize("k,offset,slots,variant", [
    (17, 0, 1, "bf16_ragged"), (256, 0, 1, "bf16"), (264, 0, 3, "bf16"),
    (300, 0, 1, "bf16_ragged"), (512, 0, 2, "bf16"),
    (256, 1, 1, "bf16_ragged"), (256, 8, 1, "bf16"),
    (256, 0, 0, "bf16_ragged"), (8, 0, 1, "bf16"), (32, 0, 2, "bf16")])
def test_k4_bf16_variant_follows_k_and_alignment(k, offset, slots, variant):
    """K4[bf16] takes its wgmma variant only when K % 8 == 0, every
    operand starts on 16 bytes (`offset` bf16 elements into B's storage
    moves B's start by 2 * offset bytes) and the plan has a slot."""
    vals = torch.zeros((2, slots, 128, 128), dtype=torch.bfloat16)
    B = torch.zeros(offset + 200 * k, dtype=torch.bfloat16)[offset:]
    C, out = (torch.zeros((200, k), dtype=torch.bfloat16) for _ in "co")
    assert vals.data_ptr() % 16 == 0 and C.data_ptr() % 16 == 0
    assert tbp.bf16_variant(vals, B.view(200, k), C, out) == variant



@pytest.mark.parametrize("k,tiles", [
    (263, [(0, 136), (136, 127)]), (300, [(0, 152), (152, 148)]),
    (257, [(0, 136), (136, 121)]), (383, [(0, 192), (192, 191)]),
    (17, [(0, 17)]), (193, [(0, 104), (104, 89)]),
    (1000, [(0, 168), (168, 168), (336, 168), (504, 168), (672, 168),
            (840, 160)])])
def test_k4_ragged_column_tiles(k, tiles):
    """K4[bf16_ragged]'s column tiles at the path's K: ceil(K / 192) of
    them, never a tile of a few columns (K=263 was 128 + 128 + 7)."""
    assert tbp.ragged_column_tiles(k) == tiles


def test_k4_ragged_column_tiles_cover_k_once():
    """For every K up to 4096: the tiles cover [0, K) in order, once; all
    but the last are one width, a multiple of 8; each is at most 192
    wide, and there are ceil(K / 192) of them."""
    assert tbp.ragged_column_tiles(0) == []
    for k in range(1, 4097):
        tiles = tbp.ragged_column_tiles(k)
        starts = [c for c, _ in tiles]
        widths = [w for _, w in tiles]
        assert starts == [sum(widths[:j]) for j in range(len(tiles))], k
        assert sum(widths) == k, k
        assert all(w % 8 == 0 and w == widths[0] for w in widths[:-1]), k
        assert 0 < widths[-1] <= widths[0] <= tbp.RAGGED_MAX_TILE, k
        assert len(tiles) == -(-k // tbp.RAGGED_MAX_TILE), k
