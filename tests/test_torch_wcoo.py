"""Port parity: the windowed-COO plan, its SpMV, and kernel K3's plain
version, against `sblas_tpu.ops.wcoo` (whose Pallas reduce runs in
interpret mode on the CPU, as tests/test_wcoo.py runs it).

Plan arrays are byte-identical; K3's port-only tables (`k3_units`,
`k3_rows`) derived from the JAX package's arrays equal the port's own
(tests/test_torch_k3_units.py checks what they hold).  The JAX package
reduces with one-hot matmuls, the port with `index_add_`, so f64 results
agree to 1e-12 relative; f32 results meet the numpy oracle at the
reference's 1e-3."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas_tpu.containers import CooMatrix as JCooMatrix
from sblas_tpu.containers import DenseMatrix as JDenseMatrix
from sblas_tpu.containers import DenseVector as JDenseVector
from sblas_tpu.io import generate as jgen
from sblas_tpu.ops import wcoo as jw
from sblas_tpu.ops.cpu_reference import spmm_cpu, spmv_cpu
import sblas_tpu_torch.ops as tops
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.ops import wcoo as tw
from sblas_tpu_torch.utils.verify import check_equal


def _gappy():
    """nnz separated by large empty-row gaps: forces tile splits."""
    rng = np.random.RandomState(3)
    m = 10_000
    rows = np.sort(rng.choice(m, size=60, replace=False)).astype(np.int64)
    cols = rng.randint(0, m, size=60).astype(np.int64)
    return JCooMatrix(rows, cols, rng.randn(60), (m, m)).to_csr()


def _one_window():
    """~40 tiles, all in the first window: long accumulation runs."""
    rng = np.random.RandomState(3)
    rows = rng.randint(0, 128, size=5000).astype(np.int64)
    cols = rng.randint(0, 2048, size=5000).astype(np.int64)
    return JCooMatrix(rows, cols, rng.random_sample(5000),
                      (256, 2048)).to_csr()


MATRICES = {
    "web": lambda: jgen.webbase_like(n=2000, avg_deg=3.0),
    "uniform": lambda: jgen.uniform_random(300, 250, 4, seed=5),
    "skew": lambda: jgen.adversarial_skew(m=256, n=200, heavy_rows=2,
                                          heavy_nnz=300, light_nnz=1),
    "gappy": _gappy,
    "one_window": _one_window,
}
ALPHA, BETA = 3.0, 4.0


@functools.lru_cache(maxsize=None)
def _matrix(name):
    return MATRICES[name]()


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


@functools.lru_cache(maxsize=None)
def _plans(name, min_tiles=0):
    A = _matrix(name)
    return (jw.WcooPlan.from_csr(A, dtype=jnp.float64, min_tiles=min_tiles),
            tw.WcooPlan.from_csr(_port(A), dtype=torch.float64,
                                 min_tiles=min_tiles, device="cpu"))


_FIELDS = ("xblk", "lane", "vals", "relrow", "half_ids", "wb", "visit0",
           "visit1")


@pytest.mark.parametrize("min_tiles", [0, 7])
@pytest.mark.parametrize("name", list(MATRICES))
def test_plan_arrays_match_jax_and_round_trip(name, min_tiles):
    jp, tp = _plans(name, jw.wcoo_tile_count(_matrix(name)) + min_tiles
                    if min_tiles else 0)
    fields = {f: np.asarray(getattr(jp, f)) for f in _FIELDS}
    for f, want in fields.items():
        got = getattr(tp, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert (tp.n_tiles, tp.n_row_blocks) == (jp.n_tiles, jp.n_row_blocks)
    assert tp.fill_ratio == jp.fill_ratio
    assert tw.wcoo_tile_count(_port(_matrix(name))) == jw.wcoo_tile_count(
        _matrix(name))
    # K3's tables, derived from the JAX package's arrays
    meta = dict(shape=jp.shape, nnz=jp.nnz, n_tiles=jp.n_tiles,
                n_row_blocks=jp.n_row_blocks)
    back = tw.WcooPlan.from_numpy(fields, meta, "cpu")
    for f in tw.WcooPlan.PORT_FIELDS:
        assert torch.equal(getattr(back, f), getattr(tp, f)), f
    assert torch.equal(back.relrow, tp.relrow)


@pytest.mark.parametrize("name", list(MATRICES))
def test_spmv_wcoo_matches_jax(name):
    A = _matrix(name)
    jp, tp = _plans(name)
    x = JDenseVector.random(A.width)
    y = JDenseVector.constant(A.height, 1.0)
    want = np.asarray(jw.spmv_wcoo(jp, jnp.asarray(x.values), ALPHA, BETA,
                                   jnp.asarray(y.values)))
    got = tops.spmv(tp, torch.from_numpy(x.values), ALPHA, BETA,
                    torch.from_numpy(y.values)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert check_equal(got, spmv_cpu(A, x, ALPHA, BETA, y)).ok


@pytest.mark.parametrize("name,k,k_chunk,min_tiles", [
    ("web", 10, 4, 0),           # ragged last chunk: 4, 4, 2
    ("skew", 8, None, 0),
    ("one_window", 16, None, 0),
    ("uniform", 8, None, 7),     # min_tiles pad tiles at the last window
])
def test_spmm_wcoo_matches_jax(name, k, k_chunk, min_tiles):
    """K3's plain version through `spmm_wcoo` against the JAX package's
    Pallas window reduce (interpret mode), f64; chunking as the JAX
    package chunks."""
    A = _matrix(name)
    extra = jw.wcoo_tile_count(A) + min_tiles if min_tiles else 0
    jp, tp = _plans(name, extra)
    B = JDenseMatrix.random(A.width, k)
    C = JDenseMatrix.constant(A.height, k, 1.0)
    want = np.asarray(jw.spmm_wcoo(jp, jnp.asarray(B.values), ALPHA, BETA,
                                   jnp.asarray(C.values), k_chunk=k_chunk))
    tw.window_reduce.launches = 0
    got = tw.spmm_wcoo(tp, torch.from_numpy(B.values), ALPHA, BETA,
                       torch.from_numpy(C.values), k_chunk=k_chunk).numpy()
    assert tw.window_reduce.launches == 0        # the CPU runs no kernel
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert check_equal(got, spmm_cpu(A, B, ALPHA, BETA, C)).ok


def test_k3_plain_matches_window_reduce_range():
    """`window_reduce_plain` on one column chunk against the JAX package's
    `_window_reduce_range` fed the gathered B rows it takes, f64."""
    A = _matrix("one_window")
    jp, tp = _plans("one_window")
    k, k0, kc = 12, 5, 4
    B = JDenseMatrix.random(A.width, k).values
    cols = np.asarray(jp.xblk) * 128 + np.asarray(jp.lane)
    gathered = jnp.asarray(B[cols, k0:k0 + kc])
    want = np.asarray(jw._window_reduce_range(
        jp.wb, jp.vals, jp.relrow, jp.visit0, jp.visit1, gathered, kc,
        jp.n_row_blocks)).reshape(-1, kc)
    got = tw.window_reduce_plain(tp.k3, tp.wb, tp.relrow, tp.vals,
                                 tp.xblk, tp.lane, torch.from_numpy(B), k0,
                                 kc)
    assert got.shape == (tp.n_row_blocks * 128, kc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_tiles,k", [(1, 64), (6417, 64), (6417, 4096),
                                       (600_000, 64), (10, 2000)])
def test_k_chunk_width_is_jax_choice(n_tiles, k):
    """Same chunk width, so K3 launches as often as the JAX package's
    Pallas reduce runs."""
    want = max(min(k, jw._K_CHUNK_MAX,
                   jw._K_BUDGET_ELEMS // max(n_tiles * jw.TILE, 1)), 1)
    assert tw.k_chunk_width(n_tiles, k) == want


def test_f32_meets_oracle_and_dispatch():
    A = jgen.webbase_like(n=3000, avg_deg=3.0, dtype=np.float32)
    plan = tops.make_plan(_port(A), dtype=torch.float32, device="cpu")
    assert isinstance(plan, tops.WcooPlan) and plan.dtype == torch.float32
    B = JDenseMatrix.random(A.width, 24, dtype=np.float32)
    C = JDenseMatrix.constant(A.height, 24, 1.0, dtype=np.float32)
    got = tops.spmm(plan, torch.from_numpy(B.values), ALPHA, BETA,
                    torch.from_numpy(C.values))
    assert got.dtype == torch.float32
    assert check_equal(got.numpy(), spmm_cpu(A, B, ALPHA, BETA, C),
                       relative=True).ok


def test_empty_matrix():
    A = CsrMatrix(np.zeros(11, np.int64), np.zeros(0, np.int64),
                  np.zeros(0), (10, 10))
    plan = tw.WcooPlan.from_csr(A, dtype=torch.float64, device="cpu")
    got = tw.spmv_wcoo(plan, torch.ones(10, dtype=torch.float64), 3.0, 4.0,
                       torch.full((10,), 2.0, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), 8.0)
    out = tw.spmm_wcoo(plan, torch.ones((10, 3), dtype=torch.float64), 3.0,
                       4.0, torch.full((10, 3), 2.0, dtype=torch.float64))
    np.testing.assert_allclose(out.numpy(), 8.0)


@pytest.mark.parametrize("name,k,k_chunk,min_tiles", [
    ("web", 10, 4, 0),
    ("skew", 8, None, 0),
    ("one_window", 16, None, 0),
    ("uniform", 8, None, 7),
])
def test_spmm_wcoo_beta_zero_matches_jax(name, k, k_chunk, min_tiles):
    """beta = 0 through K3's fused plain version: alpha*A@B, f64, against
    the JAX package's spmm_wcoo at 1e-12."""
    A = _matrix(name)
    extra = jw.wcoo_tile_count(A) + min_tiles if min_tiles else 0
    jp, tp = _plans(name, extra)
    B = JDenseMatrix.random(A.width, k)
    C = JDenseMatrix.random(A.height, k)
    want = np.asarray(jw.spmm_wcoo(jp, jnp.asarray(B.values), ALPHA, 0.0,
                                   jnp.asarray(C.values), k_chunk=k_chunk))
    got = tw.spmm_wcoo(tp, torch.from_numpy(B.values), ALPHA, 0.0,
                       torch.from_numpy(C.values), k_chunk=k_chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k0,width", [(0, 12), (5, 4), (11, 1)])
def test_k3_plain_fused_form_writes_its_chunk(k0, width):
    """The fused form writes beta*C + alpha*(the grid form's rows below m)
    into out's columns k0:k0+width and leaves out's other columns."""
    A = _matrix("web")
    _, tp = _plans("web")
    rng = np.random.RandomState(k0)
    B = torch.from_numpy(rng.rand(A.width, 12))
    C = torch.from_numpy(rng.rand(A.height, 12))
    args = (tp.k3, tp.wb, tp.relrow, tp.vals, tp.xblk, tp.lane, B, k0,
            width)
    grid = tw.window_reduce_plain(*args)
    out = torch.full_like(C, -7.0)
    got = tw.window_reduce(*args, C=C, alpha=ALPHA, beta=BETA, out=out)
    assert got is out
    want = torch.full_like(C, -7.0)
    want[:, k0:k0 + width] = BETA * C[:, k0:k0 + width] + ALPHA * grid[
        :A.height]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("plan_dtype,c_dtype,want_dtype", [
    (torch.float32, torch.float64, torch.float64),
    (torch.float64, torch.float32, torch.float64),
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16)])
def test_spmm_wcoo_result_dtype_with_another_c_dtype(plan_dtype, c_dtype,
                                                     want_dtype):
    """K3 runs in the plan's dtype; the result has the dtype that
    beta*C + alpha*(A@B) in the plan's dtype has, and meets the numpy
    oracle at the plan's precision."""
    A = _matrix("web")
    plan = tw.WcooPlan.from_csr(_port(A), dtype=plan_dtype, device="cpu")
    B = JDenseMatrix.random(A.width, 6)
    C = JDenseMatrix.random(A.height, 6)
    Ct = torch.from_numpy(C.values).to(c_dtype)
    got = tw.spmm_wcoo(plan, torch.from_numpy(B.values), ALPHA, BETA, Ct)
    assert got.dtype == want_dtype == (
        BETA * Ct + ALPHA * torch.zeros(1, dtype=plan_dtype)).dtype
    bar = 2e-2 if torch.bfloat16 in (plan_dtype, c_dtype) else 1e-5
    assert check_equal(got.double().numpy(), spmm_cpu(A, B, ALPHA, BETA, C),
                       error_bar=bar, relative=True).ok


@pytest.mark.parametrize("plan_dtype,c_dtype,jax_dtypes,bar", [
    (torch.bfloat16, torch.float32, (jnp.bfloat16, jnp.float32), 2.0 ** -7),
    (torch.float32, torch.float64, (jnp.float32, jnp.float64), 1e-5)])
def test_spmm_wcoo_keeps_a_wider_c(plan_dtype, c_dtype, jax_dtypes, bar):
    """C wider than the plan: K3 forms A@B in the plan's dtype and the
    epilogue runs in C's, so C is never rounded to the plan's dtype.  The
    result is off the plan dtype's grid, equals beta*C + alpha*(K3's
    product) to C's own rounding, and meets the JAX package's spmm_wcoo
    (which keeps C in its dtype) at the plan dtype's error."""
    A = jgen.webbase_like(n=2000, avg_deg=3.0)
    rng = np.random.RandomState(0)
    B = rng.rand(A.width, 8)
    C = rng.rand(A.height, 8) * 1000 + 1
    tp = tw.WcooPlan.from_csr(_port(A), dtype=plan_dtype, device="cpu")
    Ct = torch.from_numpy(C).to(c_dtype)
    got = tw.spmm_wcoo(tp, torch.from_numpy(B).to(c_dtype), ALPHA, BETA, Ct)
    assert got.dtype == c_dtype
    assert not torch.equal(got, got.to(plan_dtype).to(c_dtype))
    ab = tw.window_reduce_plain(tp.k3, tp.wb, tp.relrow, tp.vals, tp.xblk,
                                tp.lane, torch.from_numpy(B).to(plan_dtype),
                                0, 8)[:A.height]
    kept = BETA * Ct.double() + ALPHA * ab.double()
    eps = torch.finfo(c_dtype).eps
    assert bool(((got.double() - kept).abs() <= eps * kept.abs()).all())
    jp = jw.WcooPlan.from_csr(A, dtype=jax_dtypes[0])
    want = np.asarray(jw.spmm_wcoo(jp, jnp.asarray(B, jax_dtypes[1]), ALPHA,
                                   BETA, jnp.asarray(C, jax_dtypes[1])))
    assert want.dtype == got.numpy().dtype
    rel = np.abs(got.numpy() - want) / np.abs(want)
    assert rel.max() <= bar, rel.max()


def test_bf16_variant_choices():
    """`bf16` needs B's row stride, k0 and width in multiples of 8 and B,
    C and out on 16 bytes; anything else takes `bf16_ragged`."""
    bf = torch.bfloat16
    B = torch.zeros((100, 64), dtype=bf)
    C, out = torch.zeros((90, 64), dtype=bf), torch.zeros((90, 64), dtype=bf)
    off = torch.zeros(1 + 100 * 64, dtype=bf)[1:].view(100, 64)
    assert tw.bf16_variant(B, 0, 64) == "bf16"
    assert tw.bf16_variant(B, 8, 56, C, out) == "bf16"
    assert tw.bf16_variant(B, 16, 8, C) == "bf16"
    for args in ((B, 13, 48), (B, 8, 31), (B, 0, 1),
                 (torch.zeros((100, 65), dtype=bf), 0, 64),
                 (off, 0, 64), (B, 0, 64, off[:90]),
                 (B, 0, 64, C, off[:90])):
        assert tw.bf16_variant(*args) == "bf16_ragged", args[1:3]


def test_spmm_wcoo_refuses_a_c_of_another_shape():
    """The fused SpMM writes C's own rows and columns: a C that is not
    (m, K) is refused, not broadcast."""
    from sblas_tpu_torch.utils.errors import ShapeError
    _, tp = _plans("web")
    m, n = tp.shape
    B = torch.ones((n, 4), dtype=torch.float64)
    for C in (torch.ones((1, 4), dtype=torch.float64),
              torch.ones((m, 3), dtype=torch.float64)):
        with pytest.raises(ShapeError):
            tw.spmm_wcoo(tp, B, ALPHA, BETA, C)


@pytest.mark.parametrize("k,k_chunk", [(20, 9), (17, 5), (20, None),
                                       (63, None), (100, 81)])
def test_spmm_wcoo_bf16_ragged_chunks_match_jax(k, k_chunk):
    """bf16 values in K-chunks that are not multiples of 8, as the JAX
    package's chunk width makes them at webbase-1M (81 columns; K = 63 one
    chunk, K = 100 chunks of 81 + 19): every chunk here would take K3's
    `bf16_ragged` on the card (its ring body at these row strides).  The port's
    plain path against `spmm_wcoo(..., k_chunk)` of the JAX package
    (its Pallas reduce in interpret mode) at the JAX package's bf16 bound
    (rtol = atol = 0.15), and both against the numpy oracle on the same
    bf16 operands."""
    A = jgen.webbase_like(n=2000, avg_deg=3.0)
    rng = np.random.RandomState(k)
    B16 = torch.from_numpy(rng.rand(A.width, k)).to(torch.bfloat16)
    C16 = torch.from_numpy(rng.rand(A.height, k)).to(torch.bfloat16)
    tp = tw.WcooPlan.from_csr(_port(A), dtype=torch.bfloat16, device="cpu")
    kc = k_chunk or tw.k_chunk_width(tp.n_tiles, k)
    out = torch.empty_like(C16)
    for k0 in range(0, k, kc):
        width = min(kc, k - k0)
        assert tw.bf16_variant(B16, k0, width, C16, out) == (
            "bf16" if width % 8 == 0 and k0 % 8 == 0 and k % 8 == 0
            else "bf16_ragged")
    got = tw.spmm_wcoo(tp, B16, ALPHA, BETA, C16, k_chunk=k_chunk)
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    jp = jw.WcooPlan.from_csr(A, dtype=jnp.bfloat16)
    want = np.asarray(jw.spmm_wcoo(
        jp, jnp.asarray(B16.float().numpy(), jnp.bfloat16), ALPHA, BETA,
        jnp.asarray(C16.float().numpy(), jnp.bfloat16),
        k_chunk=k_chunk)).astype(np.float64)
    oracle = spmm_cpu(A, JDenseMatrix(B16.double().numpy()), ALPHA, BETA,
                      JDenseMatrix(C16.double().numpy()))
    for x, y in ((got, want), (got, oracle), (want, oracle)):
        np.testing.assert_allclose(x, y, rtol=0.15, atol=0.15)
