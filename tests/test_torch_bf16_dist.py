"""Port parity of bf16 values through the distributed and host-streamed
containers, against the JAX package built at bf16 on the same inputs.

* Containers: index arrays equal and bf16 values bitwise equal (compared
  as 16-bit patterns) for the segments, row blocks, every
  `partition_row_plans` kind, the halo DIA and xfoot shards, and the
  host-resident plan, shards and grid, with the JAX package's band and
  grid geometry (sized by 2-byte values).
* Numerics: every mode at world 1 returns bf16 and meets the JAX
  package's bound against the f64 oracle (rtol = atol = 0.15), and lies
  within 2^-7 normwise of the f64 product of the bf16-rounded operands,
  no further from it than the JAX package's result.  Where a row
  straddles shards (mode 2 segments) the partials stay in f32.
* The kernels the paths reach on the card are named by what the CPU
  wrappers are handed: routed shards give K2' and K1 bf16 operands, WCOO
  shards and bands give K3 bf16 values at its aligned `bf16` variant.
* The plan cache refuses bf16 shards and bands (`FormatError`).

The world-4 runs of these modes are the `bf16_*` cases of
`parallel.dryrun`, held against `make_mesh(4)` in test_torch_parallel.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import sblas_tpu.memory as jmem
import sblas_tpu.ops as jops
from sblas_tpu import parallel as jpar
from sblas_tpu.config import SBlasConfig as JConfig
from sblas_tpu.containers import CsrMatrix as JCsrMatrix
from sblas_tpu.containers import DenseMatrix, DenseVector
from sblas_tpu.io import generate as jgen
from sblas_tpu.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas_tpu.partition import (partition_nnz_balanced as j_nnz_balanced,
                                 partition_row_blocks as j_row_blocks)
import sblas_tpu_torch.memory as tmem
from sblas_tpu_torch import parallel as tpar
from sblas_tpu_torch import partition as tpart
from sblas_tpu_torch.config import SBlasConfig as TConfig
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.io.plancache import save_plan
from sblas_tpu_torch.ops import make_plan
from sblas_tpu_torch.ops import route as troute
from sblas_tpu_torch.ops import rspmv as tr
from sblas_tpu_torch.ops import wcoo as tw
from sblas_tpu_torch.parallel.mesh import Mesh
from sblas_tpu_torch.utils.errors import FormatError

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
ALPHA, BETA = 3.0, 4.0
N = 4
ROUTED = dict(routed_min_nnz=256, routed_min_width=256)
TOL = 0.15                 # the JAX package's bf16 bound, rtol = atol
NORMWISE = 2.0 ** -7       # against the f64 model of the bf16 operands


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


@functools.lru_cache(maxsize=None)
def _matrix(name):
    return {
        "banded": lambda: jgen.fem_banded_like(n=1100, half_band=6),
        "web": lambda: jgen.webbase_like(n=3000, avg_deg=3.0, seed=6,
                                         local_scale=60.0),
        "routed": lambda: jgen.uniform_random(400, 512, nnz_per_row=3,
                                              seed=5),
        "bell": lambda: jgen.fem_banded_like(n=640, half_band=40),
    }[name]()


def _bits(t):
    """A bf16 tensor's 16-bit patterns as numpy uint16."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _same(want, got, what):
    """A JAX array (bf16 compared by bit pattern) against a port tensor."""
    want = np.asarray(want)
    if want.dtype == JBF16:
        assert got.dtype == BF16, (what, got.dtype)
        assert np.array_equal(want.view(np.uint16), _bits(got)), what
    else:
        got = got.numpy()
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        assert np.array_equal(got, want), what


def _same_plan(jplan, tplan, s=None):
    """Every field of the JAX plan (row s of it when stacked) against the
    port plan; K3's port-only tables are not in the JAX plan."""
    assert type(jplan).__name__ == type(tplan).__name__
    for f in dataclasses.fields(jplan):
        a, b = getattr(jplan, f.name), getattr(tplan, f.name)
        if isinstance(a, jax.Array):
            _same(a if s is None else np.asarray(a)[s], b, f.name)
        elif isinstance(a, tuple) and a and isinstance(a[0], jax.Array):
            assert len(a) == len(b), f.name
            for u, v in zip(a, b):
                _same(u if s is None else np.asarray(u)[s], v, f.name)
        else:
            assert a == b, (f.name, a, b)


# ---- values: laid out in f32 and narrowed, bitwise JAX's direct bf16 ----

@pytest.mark.parametrize("name", ["banded", "web"])
def test_f32_layout_narrows_to_jax_bf16_values(name):
    vals = _matrix(name).values
    assert vals.dtype == np.float64
    got = torch.from_numpy(vals.astype(np.float32)).to(BF16)
    assert np.array_equal(_bits(got),
                          np.asarray(jnp.asarray(vals, JBF16)).view(np.uint16))


# ---- containers: geometry and values ----

@pytest.mark.parametrize("n", [1, N])
def test_segments_and_row_blocks_bitwise(n):
    A = _matrix("banded")
    js = j_nnz_balanced(A, n, dtype=JBF16)
    ts = tpart.partition_nnz_balanced(_port(A), n, dtype=BF16, device="cpu")
    for f in ("rows", "cols", "vals"):
        _same(getattr(js, f), getattr(ts, f), f)
    assert ts.starting_rows == js.starting_rows
    jb = j_row_blocks(A, n, dtype=JBF16)
    tb = tpart.partition_row_blocks(_port(A), n, dtype=BF16, device="cpu")
    for f in ("cols", "vals", "local_rows"):
        _same(getattr(jb, f), getattr(tb, f), f)
    assert (tb.halo_left, tb.halo_right) == (jb.halo_left, jb.halo_right)


@pytest.mark.parametrize("kind,name", [
    ("bsr", "bell"), ("ell", "banded"), ("dia", "banded"), ("wcoo", "web"),
    ("coo", "web"), ("routed", "routed")])
def test_row_plan_shards_bitwise(kind, name):
    A = _matrix(name)
    js = jpar.partition_row_plans(A, N, dtype=JBF16, kind=kind,
                                  config=JConfig(**ROUTED))
    ts = tpar.partition_row_plans(_port(A), N, dtype=BF16, kind=kind,
                                  config=TConfig(**ROUTED), device="cpu")
    assert (ts.kind, ts.band_rows, ts.row_offsets) == \
        (js.kind, js.band_rows,
         tuple(np.asarray(js.row_offsets)[:, 0].tolist()))
    for s in range(N):
        _same_plan(js.plan, ts.plans[s], s)
        assert ts.plans[s].dtype == BF16


def test_halo_dia_and_xfoot_shards_bitwise():
    A = _matrix("banded")
    jh = jpar.partition_halo_dia(A, N, dtype=JBF16)
    th = tpar.partition_halo_dia(_port(A), N, dtype=BF16, device="cpu")
    jx = jpar.partition_xfoot(A, N, dtype=JBF16)
    tx = tpar.partition_xfoot(_port(A), N, dtype=BF16, device="cpu")
    assert (tx.kind, tx.band_rows, tx.r_x) == (jx.kind, jx.band_rows, jx.r_x)
    for s in range(N):
        _same_plan(jh.plan, th.plans[s], s)
        _same_plan(jx.plan, tx.plans[s].plan, s)


def _band_vals_bytes(band):
    return band.vals.numel() * band.vals.element_size()


@pytest.mark.parametrize("name,budget", [("web", 64 << 10),
                                         ("banded", 24 << 10)])
def test_host_resident_plan_geometry(name, budget):
    """Bands sized by 2-byte values, as the JAX package sizes bf16 bands
    (an f32-sized band would be half as tall, with twice as many bands)."""
    A = _matrix(name)
    jp = jmem.host_resident_plan(A, dtype=JBF16, hbm_budget_bytes=budget)
    tp = tmem.host_resident_plan(_port(A), dtype=BF16,
                                 hbm_budget_bytes=budget, device="cpu")
    t32 = tmem.host_resident_plan(_port(A), dtype=torch.float32,
                                  hbm_budget_bytes=budget, device="cpu")
    assert (tp.kind, tp.band_rows, tp.n_bands) == \
        (jp.kind, jp.band_rows, jp.n_bands)
    assert tp.band_rows > t32.band_rows and tp.n_bands < t32.n_bands
    for jb, tb in zip(jp.bands, tp.bands):
        _same_plan(jb, tb)
        assert _band_vals_bytes(tb) == np.asarray(jb.vals).nbytes


def test_host_resident_shards_and_grid_geometry():
    A = _matrix("web")
    js = jmem.host_resident_shards(A, N, dtype=JBF16,
                                   hbm_budget_bytes=64 << 10)
    ts = tmem.host_resident_shards(_port(A), N, dtype=BF16,
                                   hbm_budget_bytes=64 << 10, device="cpu")
    assert (ts.kind, ts.band_rows, ts.n_bands) == \
        (js.kind, js.band_rows, js.n_bands)
    assert np.array_equal(ts.offsets, js.offsets)
    for s in range(N):
        for b, band in enumerate(ts.shards[s].bands):
            _same_plan(js.bands[b], band, (0, s))
    jg = jmem.host_resident_grid(A, dtype=JBF16, hbm_budget_bytes=96 << 10,
                                 k=8)
    tg = tmem.host_resident_grid(_port(A), dtype=BF16,
                                 hbm_budget_bytes=96 << 10, k=8, device="cpu")
    assert (tg.kind, tg.band_rows, tg.chunk_cols, tg.n_bands, tg.n_chunks) \
        == (jg.kind, jg.band_rows, jg.chunk_cols, jg.n_bands, jg.n_chunks)
    assert sorted(tg.cells) == sorted(jg.cells)
    for key, cell in tg.cells.items():
        _same_plan(jg.cells[key], cell)


# ---- every mode at world 1, against the oracle, the model and JAX ----

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo group of one made through a FileStore, destroyed at
    teardown."""
    store = tmp_path_factory.mktemp("store") / "s"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield tpar.make_mesh(1, device="cpu"), tpar.make_mesh2(
            1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _rounded(A):
    """A with its values rounded to bf16 (through f32), in f64."""
    vals = torch.from_numpy(A.values.astype(np.float32)).to(BF16).double()
    return JCsrMatrix(A.row_ptr, A.col_idx, vals.numpy(), A.shape)


@functools.lru_cache(maxsize=None)
def _operands(name, k):
    """(A, dense operands in f64, the same rounded to bf16 as f64 arrays,
    as port tensors and as JAX arrays; oracle; model)."""
    A = _matrix(name)
    d = dict(x=DenseVector.random(A.width).values,
             y=DenseVector.constant(A.height, 1.0).values,
             B=DenseMatrix.random(A.width, k).values,
             C=DenseMatrix.constant(A.height, k, 1.0).values)
    t = {key: torch.from_numpy(v).float().to(BF16) for key, v in d.items()}
    j = {key: jnp.asarray(v.astype(np.float32), JBF16) for key, v in d.items()}
    r = {key: v.double().numpy() for key, v in t.items()}
    Ar = _rounded(A)
    oracle = dict(
        mv=spmv_cpu(A, DenseVector(d["x"]), ALPHA, BETA, DenseVector(d["y"])),
        mm=spmm_cpu(A, DenseMatrix(d["B"]), ALPHA, BETA, DenseMatrix(d["C"])))
    model = dict(
        mv=spmv_cpu(Ar, DenseVector(r["x"]), ALPHA, BETA, DenseVector(r["y"])),
        mm=spmm_cpu(Ar, DenseMatrix(r["B"]), ALPHA, BETA,
                    DenseMatrix(r["C"])))
    return A, t, j, oracle, model


def _modes():
    """name -> (matrix, op, port(A, t, mesh, mesh2), jax(A, j, mesh,
    mesh2)); op "mm" runs at K = 16."""
    a, b = ALPHA, BETA
    tc, jc = TConfig(**ROUTED), JConfig(**ROUTED)
    kw = dict(dtype=BF16, device="cpu")
    P = _port
    return {
        "mode1_wcoo": ("web", "mm",
                       lambda A, t, m, m2: tpar.spmm_mode1(
                           make_plan(P(A), force="wcoo", **kw), t["B"], a, b,
                           t["C"], m),
                       lambda A, j, m, m2: jpar.spmm_mode1(
                           jops.make_plan(A, dtype=JBF16, force="wcoo"),
                           j["B"], a, b, j["C"], m)),
        "mode1_bsr": ("bell", "mm",
                      lambda A, t, m, m2: tpar.spmm_mode1(
                          make_plan(P(A), force="bsr", **kw), t["B"], a, b,
                          t["C"], m),
                      lambda A, j, m, m2: jpar.spmm_mode1(
                          jops.make_plan(A, dtype=JBF16, force="bsr"),
                          j["B"], a, b, j["C"], m)),
        "mode2_psum_scatter": ("web", "mm",
                               lambda A, t, m, m2: tpar.spmm_mode2(
                                   tpart.partition_nnz_balanced(P(A), 1,
                                                                **kw),
                                   t["B"], a, b, t["C"], m, "psum_scatter"),
                               lambda A, j, m, m2: jpar.spmm_mode2(
                                   j_nnz_balanced(A, 1, dtype=JBF16),
                                   j["B"], a, b, j["C"], m,
                                   reduce="psum_scatter")),
        "dist_psum": ("web", "mv",
                      lambda A, t, m, m2: tpar.spmv_dist(
                          tpart.partition_nnz_balanced(P(A), 1, **kw),
                          t["x"], a, b, t["y"], m),
                      lambda A, j, m, m2: jpar.spmv_dist(
                          j_nnz_balanced(A, 1, dtype=JBF16), j["x"], a, b,
                          j["y"], m)),
        "halo": ("banded", "mv",
                 lambda A, t, m, m2: tpar.spmv_halo(
                     tpart.partition_row_blocks(P(A), 1, **kw), t["x"], a,
                     b, t["y"], m),
                 lambda A, j, m, m2: jpar.spmv_halo(
                     j_row_blocks(A, 1, dtype=JBF16), j["x"], a, b, j["y"],
                     m)),
        **{f"planned_{kind}_spmm": (
            name, "mm",
            lambda A, t, m, m2, kind=kind: tpar.spmm_mode2_planned(
                tpar.partition_row_plans(P(A), 1, kind=kind, **kw), t["B"],
                a, b, t["C"], m),
            lambda A, j, m, m2, kind=kind: jpar.spmm_mode2_planned(
                jpar.partition_row_plans(A, 1, dtype=JBF16, kind=kind),
                j["B"], a, b, j["C"], m))
           for kind, name in (("bsr", "bell"), ("ell", "banded"),
                              ("dia", "banded"), ("wcoo", "web"),
                              ("coo", "web"))},
        "planned_routed_spmv": ("routed", "mv",
                                lambda A, t, m, m2: tpar.spmv_dist_planned(
                                    tpar.partition_row_plans(
                                        P(A), 1, kind="routed", config=tc,
                                        **kw), t["x"], a, b, t["y"], m),
                                lambda A, j, m, m2: jpar.spmv_dist_planned(
                                    jpar.partition_row_plans(
                                        A, 1, dtype=JBF16, kind="routed",
                                        config=jc), j["x"], a, b, j["y"],
                                    m)),
        "hier_spmv": ("web", "mv",
                      lambda A, t, m, m2: tpar.spmv_dist_hier(
                          tpar.partition_row_plans(P(A), 1, op="spmv", **kw),
                          t["x"], a, b, t["y"], m2),
                      lambda A, j, m, m2: jpar.spmv_dist_hier(
                          jpar.partition_row_plans(A, 1, dtype=JBF16,
                                                   op="spmv"),
                          j["x"], a, b, j["y"], m2)),
        "halo_planned_spmm": ("banded", "mm",
                              lambda A, t, m, m2: tpar.spmm_halo_planned(
                                  tpar.partition_halo_dia(P(A), 1, **kw),
                                  t["B"], a, b, t["C"], m),
                              lambda A, j, m, m2: jpar.spmm_halo_planned(
                                  jpar.partition_halo_dia(A, 1, dtype=JBF16),
                                  j["B"], a, b, j["C"], m)),
        "xfoot": ("web", "mv",
                  lambda A, t, m, m2: tpar.spmv_xfoot(
                      tpar.partition_xfoot(P(A), 1, **kw), t["x"], a, b,
                      t["y"], m),
                  lambda A, j, m, m2: jpar.spmv_xfoot(
                      jpar.partition_xfoot(A, 1, dtype=JBF16), j["x"], a, b,
                      j["y"], m)),
        "um_spmv": ("web", "mv",
                    lambda A, t, m, m2: tmem.spmv_um(
                        tmem.host_resident_plan(P(A), hbm_budget_bytes=64
                                                << 10, **kw),
                        t["x"], a, b, t["y"]),
                    lambda A, j, m, m2: jmem.spmv_um(
                        jmem.host_resident_plan(A, dtype=JBF16,
                                                hbm_budget_bytes=64 << 10),
                        j["x"], a, b, j["y"])),
        "um_spmm": ("web", "mm",
                    lambda A, t, m, m2: tmem.spmm_um(
                        tmem.host_resident_plan(P(A), hbm_budget_bytes=64
                                                << 10, **kw),
                        t["B"], a, b, t["C"]),
                    lambda A, j, m, m2: jmem.spmm_um(
                        jmem.host_resident_plan(A, dtype=JBF16,
                                                hbm_budget_bytes=64 << 10),
                        j["B"], a, b, j["C"])),
        "um_spmv_dist": ("web", "mv",
                         lambda A, t, m, m2: tmem.spmv_um_dist(
                             tmem.host_resident_shards(
                                 P(A), 1, hbm_budget_bytes=64 << 10, **kw),
                             t["x"], a, b, t["y"], m),
                         lambda A, j, m, m2: jmem.spmv_um_dist(
                             jmem.host_resident_shards(
                                 A, 1, dtype=JBF16,
                                 hbm_budget_bytes=64 << 10),
                             j["x"], a, b, j["y"], m)),
        "um_spmm_dist": ("web", "mm",
                         lambda A, t, m, m2: tmem.spmm_um_dist(
                             tmem.host_resident_shards(
                                 P(A), 1, hbm_budget_bytes=64 << 10, **kw),
                             t["B"], a, b, t["C"], m),
                         lambda A, j, m, m2: jmem.spmm_um_dist(
                             jmem.host_resident_shards(
                                 A, 1, dtype=JBF16,
                                 hbm_budget_bytes=64 << 10),
                             j["B"], a, b, j["C"], m)),
        "um_mode1": ("banded", "mm",
                     lambda A, t, m, m2: tmem.spmm_um_mode1(
                         tmem.host_resident_plan(P(A), hbm_budget_bytes=24
                                                 << 10, **kw),
                         t["B"], a, b, t["C"], m),
                     lambda A, j, m, m2: jmem.spmm_um_mode1(
                         jmem.host_resident_plan(A, dtype=JBF16,
                                                 hbm_budget_bytes=24 << 10),
                         j["B"], a, b, j["C"], m)),
        "um_hostdense": ("web", "mm",
                         lambda A, t, m, m2: tmem.spmm_um_hostdense(
                             tmem.host_resident_grid(
                                 P(A), hbm_budget_bytes=96 << 10, k=16,
                                 **kw),
                             tmem.HostDense.from_array(t["B"], device="cpu"),
                             a, b,
                             tmem.HostDense.from_array(t["C"], device="cpu")
                         ).values,
                         lambda A, j, m, m2: jmem.spmm_um_hostdense(
                             jmem.host_resident_grid(
                                 A, dtype=JBF16, hbm_budget_bytes=96 << 10,
                                 k=16),
                             jmem.HostDense.from_array(np.asarray(j["B"])),
                             a, b,
                             jmem.HostDense.from_array(np.asarray(j["C"]))
                         ).values),
    }


MODES = _modes()


def _normwise(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_world1_bars(world1, mode):
    """bf16 out; within rtol = atol = 0.15 of the f64 oracle; within 2^-7
    normwise of the f64 product of the bf16-rounded operands, and no
    further from it than the JAX package's bf16 result."""
    mesh, mesh2 = world1
    name, op, port, jax_fn = MODES[mode]
    A, t, j, oracle, model = _operands(name, 16)
    got = port(A, t, mesh, mesh2)
    assert got.dtype == BF16
    got = got.double().numpy()
    want = np.asarray(jax_fn(A, j, jpar.make_mesh(1),
                             jpar.make_mesh2(1, 1)))
    assert want.dtype == JBF16
    want = want.astype(np.float64)
    for v in (got, want):
        assert np.all(np.abs(v - oracle[op]) <= TOL * (1 + np.abs(oracle[op])))
    err, jax_err = _normwise(got, model[op]), _normwise(want, model[op])
    print(f"{mode}: normwise port {err:.3e}, jax {jax_err:.3e}")
    assert err <= NORMWISE
    assert err <= jax_err


# ---- rows that straddle shards: f32 partials ----

def _straddled():
    """Two nnz segments of a matrix whose row 3 holds 2000 entries: the
    segment boundary falls inside it."""
    rng = np.random.RandomState(7)
    m, n = 16, 4096
    counts = np.full(m, 3)
    counts[3] = 2000
    rows = np.repeat(np.arange(m), counts)
    cols = np.concatenate([rng.choice(n, c, replace=False) for c in counts])
    from sblas_tpu.containers import CooMatrix
    return CooMatrix(rows, cols, rng.random_sample(rows.size),
                     (m, n)).to_csr()


def test_mode2_partials_stay_f32_across_a_straddling_row():
    """Each rank's mode-2 partial is f32, summed across the ranks in f32
    and folded once: within 2^-7 normwise of the model, and at the row
    that straddles the two segments closer to it than the JAX package on
    make_mesh(2), whose bf16 partials stop growing along the 2000-entry
    row."""
    A = _straddled()
    segs = tpart.partition_nnz_balanced(_port(A), 2, dtype=BF16,
                                        device="cpu")
    assert segs.stopping_rows[0] == segs.starting_rows[1] == 3
    xv = DenseVector.random(A.width).values.astype(np.float32)
    x, y = torch.from_numpy(xv).to(BF16), torch.ones(A.height, dtype=BF16)
    parts = [tpar.spmv_dist_nocomm(segs, x, Mesh(None, r, 2, "cpu"))
             for r in range(2)]
    assert all(p.dtype == torch.float32 for p in parts)
    from sblas_tpu_torch.ops.plans import fold
    got = fold(ALPHA, parts[0] + parts[1], BETA, y, BF16)
    assert got.dtype == BF16
    got = got.double().numpy()
    exact = spmv_cpu(_rounded(A), DenseVector(x.double().numpy()), ALPHA,
                     BETA, DenseVector(y.double().numpy()))
    assert _normwise(got, exact) <= NORMWISE
    want = np.asarray(jpar.spmv_dist(
        j_nnz_balanced(A, 2, dtype=JBF16), jnp.asarray(xv, JBF16), ALPHA,
        BETA, jnp.ones(A.height, JBF16), jpar.make_mesh(2)))
    assert abs(got[3] - exact[3]) < abs(float(want[3]) - exact[3])


def test_um_dist_partial_is_f32(monkeypatch):
    """`spmv_um_dist`/`spmm_um_dist` sum their bands into an f32 partial,
    which the collective adds, and return bf16."""
    from sblas_tpu_torch.memory import dist as tdist
    seen = []
    monkeypatch.setattr(tdist, "all_reduce",
                        lambda t, mesh: seen.append(t.dtype) or t)
    A, t, _, oracle, _ = _operands("web", 8)
    hs = tmem.host_resident_shards(_port(A), 1, dtype=BF16,
                                   hbm_budget_bytes=64 << 10, device="cpu")
    mesh = Mesh(None, 0, 1, "cpu")
    out = tmem.spmm_um_dist(hs, t["B"], ALPHA, BETA, t["C"], mesh)
    vec = tmem.spmv_um_dist(hs, t["x"], ALPHA, BETA, t["y"], mesh)
    assert seen == [torch.float32, torch.float32]
    assert out.dtype == vec.dtype == BF16


# ---- the kernels the paths reach: bf16 operands, aligned variants ----

def test_routed_shards_hand_k2p_and_k1_bf16(monkeypatch):
    """A routed shard at bf16 values gives K2' bf16 tiles and K1 bf16
    lanes (the `bf16` variants on the card), never K2 (the single-device
    gather)."""
    calls = []
    for mod, name in ((tr, "tile_gather"), (tr, "slab_gather"),
                      (troute, "lane_shuffle")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, _n=name:
                            calls.append((_n, a[0].dtype)) or _f(*a))
    A, t, _, _, _ = _operands("routed", 1)
    sh = tpar.partition_row_plans(_port(A), 1, dtype=BF16, kind="routed",
                                  config=TConfig(**ROUTED), device="cpu")
    tpar.spmv_dist_planned_nocomm(sh, t["x"], Mesh(None, 0, 1, "cpu"))
    assert sorted(set(calls)) == [("lane_shuffle", BF16),
                                  ("tile_gather", BF16)]
    assert calls.count(("tile_gather", BF16)) == 1
    assert len(calls) == 1 + sh.local(0).n_route_gathers


@pytest.mark.parametrize("path", ["planned", "band", "mode1"])
def test_wcoo_paths_hand_k3_bf16_aligned(monkeypatch, path):
    """WCOO shards, streamed bands and mode 1 at K = 64 give K3 bf16
    values with operands its `bf16` variant takes (not `bf16_ragged`)."""
    seen = []
    orig = tw.window_reduce

    def spy(k3, wb, relrow, vals, xblk, lane, B, k0, width, **kw):
        seen.append((vals.dtype, tw.bf16_variant(B, k0, width, kw.get("C"),
                                                 kw.get("out"))))
        return orig(k3, wb, relrow, vals, xblk, lane, B, k0, width, **kw)

    monkeypatch.setattr(tw, "window_reduce", spy)
    A = _port(_matrix("web"))
    B = torch.from_numpy(DenseMatrix.random(A.width, 64).values).to(BF16)
    C = torch.ones((A.height, 64), dtype=BF16)
    mesh = Mesh(None, 0, 1, "cpu")
    if path == "planned":
        sh = tpar.partition_row_plans(A, 1, dtype=BF16, kind="wcoo",
                                      device="cpu")
        tpar.spmm_mode2_planned_nocomm(sh, B, mesh)
    elif path == "band":
        hp = tmem.host_resident_plan(A, dtype=BF16,
                                     hbm_budget_bytes=64 << 10, device="cpu")
        assert hp.kind == "wcoo" and hp.n_bands > 1
        tmem.spmm_um(hp, B, ALPHA, BETA, C)
        assert len(seen) == hp.n_bands
    else:
        tpar.spmm_mode1(make_plan(A, dtype=BF16, force="wcoo", device="cpu"),
                        B, ALPHA, BETA, C, mesh)
    assert seen and set(seen) == {(BF16, "bf16")}


def test_bands_hold_bf16_values():
    """A bf16 band's values are bf16 on the host, so a copy moves bf16
    bytes: the streamed bytes of an untuned call are the bands' bytes."""
    A = _matrix("web")
    tp = tmem.host_resident_plan(_port(A), dtype=BF16,
                                 hbm_budget_bytes=64 << 10, device="cpu")
    assert all(b.vals.dtype == BF16 and b.visit0.dtype == BF16
               for b in tp.bands)
    t = _operands("web", 1)[1]
    tmem.spmv_um(tp, t["x"], ALPHA, BETA, t["y"])
    assert tp.last_stream.bytes == tp.band_bytes


# ---- the plan cache refuses bf16 shards and bands ----

@pytest.mark.parametrize("what", ["row_plans", "xfoot", "host_plan",
                                  "host_shards"])
def test_plancache_refuses_bf16_containers(tmp_path, what):
    A = _port(_matrix("web"))
    kw = dict(dtype=BF16, device="cpu")
    build = {
        "row_plans": lambda: tpar.partition_row_plans(A, 2, **kw),
        "xfoot": lambda: tpar.partition_xfoot(A, 2, **kw),
        "host_plan": lambda: tmem.host_resident_plan(
            A, hbm_budget_bytes=64 << 10, **kw),
        "host_shards": lambda: tmem.host_resident_shards(
            A, 2, hbm_budget_bytes=64 << 10, **kw),
    }[what]
    with pytest.raises(FormatError, match="bfloat16"):
        save_plan(str(tmp_path / "p.npz"), build())
    assert not (tmp_path / "p.npz").exists()


def test_hostdense_takes_bf16_tensors():
    v = torch.arange(6, dtype=torch.float32).reshape(3, 2).to(BF16)
    h = tmem.HostDense.from_array(v, device="cpu")
    assert h.values.dtype == BF16 and h.shape == (3, 2)
    assert h.values.data_ptr() != v.data_ptr()
    assert h.to_numpy().dtype == np.float32
    assert np.array_equal(h.to_numpy(), v.float().numpy())


def test_mode2_comm_needs_a_card_and_a_launcher(monkeypatch):
    from sblas_tpu_torch.tools import mode2_comm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mode2_comm.main() == 1
