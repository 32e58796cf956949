"""The DIA kernels K5 (the SpMM, `ops/dia.py::dia_spmm`) and K6 (the
SpMV, `ops/dia.py::dia_spmv`; both csrc/dia_kernels.cu) on the CPU: K5's
run table, each kernel's schedule run here in torch against the plain
loop, and the dispatch of `spmm_dia` and `spmv_dia`.

The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py).  Here `dia_runs` is checked on
hand-made and shard offsets, K5's decomposition (a tile of rows, a
256-byte column slice, one zero-filled B window a run, the epilogue on
C's tile) and K6's (a tile of rows staged whole, one row a thread, x
read as zero outside [0, n), the epilogue with or without y) are
replayed in torch at the plans the kernels serve, and `spmm_dia` and
`spmv_dia` are driven on a device off the CPU (`meta`: shapes without
storage) with the launcher replaced, to see what they would launch."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas_tpu.containers import CsrMatrix as JCsrMatrix
from sblas_tpu.ops import dia as jdia
from sblas_tpu_torch import _kernels
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.io.generate import fem_banded_like, fem_shell_like
from sblas_tpu_torch.ops import make_plan, spmm, spmv
from sblas_tpu_torch.ops import dia as tdia
from sblas_tpu_torch.ops.plans import fold
from sblas_tpu_torch.parallel import partition_halo_dia, partition_row_plans
from sblas_tpu_torch.utils import trace
from sblas_tpu_torch.utils.errors import KernelError, ShapeError

SOURCE = Path(tdia.__file__).parents[1] / "csrc" / "dia_kernels.cu"
ALPHA, BETA = 3.0, 4.0


def _offsets_matrix(n: int, offsets, seed: int = 3, m: int = None):
    """An m x n CSR matrix holding every in-range entry of `offsets`'
    diagonals, values uniform in [-1, 1)."""
    m = n if m is None else m
    rows, cols = [], []
    for off in offsets:
        r = np.arange(max(0, -off), min(m, n - off))
        rows.append(r)
        cols.append(r + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = np.random.default_rng(seed).uniform(-1, 1, len(rows))
    row_ptr = np.searchsorted(rows, np.arange(m + 1)).astype(np.int64)
    return CsrMatrix(row_ptr, cols.astype(np.int32), vals, (m, n))


@pytest.mark.parametrize("offsets,want", [
    pytest.param((-2, -1, 0, 1, 2), ((-2, 0, 5),), id="one-run"),
    pytest.param(tuple(range(-30, 30)),
                 ((-30, 0, 28), (-2, 28, 28), (26, 56, 4)), id="split"),
    pytest.param(tuple(range(56)), ((0, 0, 28), (28, 28, 28)),
                 id="split-even"),
    pytest.param((5,), ((5, 0, 1),), id="single"),
    pytest.param((-9, -8, -7, -3), ((-9, 0, 3), (-3, 3, 1)),
                 id="negative"),
    pytest.param((1, 2, 4, 5, 6), ((1, 0, 2), (4, 2, 3)), id="positive"),
    pytest.param((-2411, -2410, -11, 0, 11, 1195, 1196, 1197),
                 ((-2411, 0, 2), (-11, 2, 1), (0, 3, 1), (11, 4, 1),
                  (1195, 5, 3)), id="gaps"),
    pytest.param((3, 1, 2), ((3, 0, 1), (1, 1, 2)), id="unsorted"),
])
def test_dia_runs(offsets, want):
    assert tdia.RUN_CAP == 28
    assert tdia.dia_runs(offsets) == want


def _covers(offsets, runs) -> bool:
    """Each diagonal in exactly one run, in order, runs consecutive."""
    got = []
    for lo, j0, w in runs:
        if not 1 <= w <= tdia.RUN_CAP or j0 != len(got):
            return False
        got.extend(range(lo, lo + w))
    return tuple(got) == tuple(offsets)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_dia_runs_cover_shard_plans(n_shards):
    """Mode 2's DIA shards ((band_rows, n), offsets against the global
    columns) and the halo shards ((r, 3r), offsets against the extended
    window): every plan's runs cover its offsets."""
    A = fem_shell_like(nx=16, ny=8, n_target=768, dtype=np.float32)
    rows = partition_row_plans(A, n_shards, kind="dia", device="cpu")
    halo = partition_halo_dia(A, n_shards, device="cpu")
    plans = list(rows.plans) + list(halo.plans)
    assert all(p.shape[0] != p.shape[1] for p in plans)
    for plan in plans:
        runs = tdia.dia_runs(plan.offsets)
        assert _covers(plan.offsets, runs)
        assert len(runs) < len(plan.offsets)


def test_run_cap_is_the_kernels():
    """RUN_CAP is the kernel's `kRunCap`, and the launcher takes the
    arguments `_kernels.LAUNCHERS` declares (and the stream)."""
    src = SOURCE.read_text()
    cap = re.search(r"constexpr int kRunCap = (\d+);", src)
    assert cap and int(cap.group(1)) == tdia.RUN_CAP
    types, variants = _kernels.LAUNCHERS["dia_spmm"]
    assert variants == ("f32", "f64")
    assert "dia_kernels.cu" in _kernels.SOURCES
    for v in variants:
        sig = re.search(rf"int sblas_dia_spmm_{v}\(([^)]*)\)", src)
        assert sig and sig.group(1).count(",") + 1 == len(types) + 1


def _k5_schedule(plan, B, C, alpha, beta, tr: int, kc: int):
    """K5's decomposition in torch: tiles of `tr` rows x `kc` columns;
    per run one window of B rows [r0 + lo, r0 + lo + tr + w - 1), rows
    outside [0, n) and columns past K zero, and the run's values for the
    tile's rows (zero past m); row q of the tile adds vals[q, j0 + d] *
    window[q + d] for d in order; then beta*C + alpha*acc on C's tile."""
    m, n = plan.shape
    k = B.shape[1]
    out = torch.empty((m, k), dtype=plan.dtype)
    runs = tdia.dia_runs(plan.offsets)
    for r0 in range(0, m, tr):
        rows = min(tr, m - r0)
        for c0 in range(0, k, kc):
            cols = min(kc, k - c0)
            acc = torch.zeros((tr, kc), dtype=plan.dtype)
            for lo, j0, w in runs:
                idx = torch.arange(r0 + lo, r0 + lo + tr + w - 1)
                ok = (idx >= 0) & (idx < n)
                win = torch.zeros((tr + w - 1, kc), dtype=plan.dtype)
                win[ok, :cols] = B[idx[ok], c0:c0 + cols]
                vs = torch.zeros((tr, w), dtype=plan.dtype)
                vs[:rows] = plan.vals[r0:r0 + rows, j0:j0 + w]
                for d in range(w):
                    acc.addcmul_(vs[:, d:d + 1], win[d:d + tr])
            out[r0:r0 + rows, c0:c0 + cols] = (
                beta * C[r0:r0 + rows, c0:c0 + cols]
                + alpha * acc[:rows, :cols])
    return out


def _plan_case(name: str, dtype):
    """One of the plans K5 serves, on the CPU."""
    if name == "shell":
        A = fem_shell_like(nx=16, ny=8, n_target=768, dtype=np.float64)
        return make_plan(A, dtype=dtype, force="dia", device="cpu")
    if name == "gaps":   # runs of 6, 7, 1 and 4 with gaps between
        A = _offsets_matrix(200, [*range(-40, -34), *range(-3, 4), 17,
                                  *range(50, 54)])
        return make_plan(A, dtype=dtype, force="dia", device="cpu")
    if name == "wide":   # a run of 61 diagonals: three runs at the cap
        A = fem_banded_like(n=300, half_band=30, dtype=np.float64)
        return make_plan(A, dtype=dtype, force="dia", device="cpu")
    if name == "edges":   # offsets past both edges; values everywhere
        return _random_plan(50, 70, (-53, -2, 0, 5, 71), dtype)
    if name == "many":    # 1001 diagonals: K6 stages fewer than 128 rows
        return _random_plan(300, 1300, tuple(range(-500, 501)), dtype)
    if name == "huge":    # 12001: K6 reads the values in place
        return _random_plan(40, 12040, tuple(range(-6000, 6001)), dtype)
    A = fem_shell_like(nx=16, ny=8, n_target=768, dtype=np.float64)
    if name == "shard":
        return partition_row_plans(A, 3, dtype=dtype, kind="dia",
                                   device="cpu").plans[1]
    return partition_halo_dia(A, 3, dtype=dtype, device="cpu").plans[2]


def _random_plan(m: int, n: int, offsets, dtype, seed: int = 5):
    """An m x n DiaPlan of `offsets` whose every stored value is uniform in
    [-1, 1), those of positions outside the matrix included: only a
    product with x read as zero there leaves them out of the sum."""
    vals = np.random.default_rng(seed).uniform(-1, 1, (m, len(offsets)))
    return tdia.DiaPlan.from_numpy(
        dict(vals=vals), dict(offsets=tuple(offsets), shape=(m, n),
                              nnz=vals.size), "cpu", dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["shell", "gaps", "wide", "shard", "halo"])
@pytest.mark.parametrize("k,tr,alpha,beta", [
    (1, 37, 3.0, 4.0), (63, 128, 3.0, 4.0), (64, 64, -2.5, 0.0),
    (100, 16, 3.0, 4.0)])
def test_k5_schedule_matches_plain(dtype, name, k, tr, alpha, beta):
    """The schedule forms the plain loop's products in its order, so it
    agrees with `spmm_dia_plain` to rounding (the CPU's `addcmul_` may
    fuse the multiply-add in its vector body and not in its tail):
    normwise 1e-12 in f64, 1e-6 in f32.  An Inf in B gives Inf and NaN (a
    stored zero times Inf) in the same places: the windows multiply
    exactly the B rows the diagonals read."""
    plan = _plan_case(name, dtype)
    m, n = plan.shape
    g = torch.Generator().manual_seed(k + tr)
    B = torch.rand((n, k), generator=g, dtype=torch.float64).to(dtype)
    C = torch.rand((m, k), generator=g, dtype=torch.float64).to(dtype)
    kc = 256 // B.element_size()
    want = tdia.spmm_dia_plain(plan, B, alpha, beta, C)
    got = _k5_schedule(plan, B, C, alpha, beta, tr, kc)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale
    B[n // 2, 0] = float("inf")
    want = tdia.spmm_dia_plain(plan, B, alpha, beta, C)
    got = _k5_schedule(plan, B, C, alpha, beta, tr, kc)
    assert torch.equal(want.isnan(), got.isnan())
    assert torch.equal(want.isinf(), got.isinf())
    assert not bool(want.isfinite().all())


def _no_launch(*args):
    raise AssertionError(f"unexpected launch {args[0]}")


def test_spmm_dia_on_cpu_is_the_plain_loop(monkeypatch):
    monkeypatch.setattr(_kernels, "launch", _no_launch)
    plan = _plan_case("shell", torch.float32)
    m, n = plan.shape
    B, C = torch.rand((n, 8)), torch.rand((m, 8))
    with trace.recording() as rec:
        got = spmm(plan, B, 3.0, 4.0, C)
    assert torch.equal(got, tdia.spmm_dia_plain(plan, B, 3.0, 4.0, C))
    assert "dia_loop_calls" not in rec.counters


def _recorded_launches(monkeypatch) -> list:
    calls = []
    monkeypatch.setattr(_kernels, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    return calls


def test_spmm_dia_bf16_off_the_cpu_takes_the_loop(monkeypatch):
    """A bf16 plan off the CPU runs the loop (its bf16 running sum) and
    counts `dia_loop_calls`; K5 is not launched."""
    monkeypatch.setattr(_kernels, "launch", _no_launch)
    plan = _plan_case("shell", torch.bfloat16).to("meta")
    m, n = plan.shape
    B = torch.empty((n, 64), dtype=torch.bfloat16, device="meta")
    C = torch.empty((m, 64), dtype=torch.bfloat16, device="meta")
    with trace.recording() as rec:
        out = spmm(plan, B, 3.0, 4.0, C)
        spmm(plan, B, 3.0, 4.0, C)
    assert rec.counters["dia_loop_calls"] == 2
    assert out.shape == (m, 64) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["shell", "shard", "halo"])
def test_spmm_dia_off_the_cpu_launches_k5_once(monkeypatch, dtype, name):
    """f32 and f64 plans off the CPU: one K5 launch a call with the run
    table and the operands' row strides (a column block of B, as mode 1
    hands it, is taken as a view), an `empty` result and nothing else."""
    calls = _recorded_launches(monkeypatch)
    plan = _plan_case(name, dtype).to("meta")
    (m, n), nd = plan.shape, len(plan.offsets)
    B_full = torch.empty((n, 96), dtype=dtype, device="meta")
    B = B_full[:, 32:96]
    C = torch.empty((m, 64), dtype=dtype, device="meta")
    tdia.dia_spmm.launches = 0
    with trace.recording() as rec:
        out = spmm(plan, B, -2.5, 0.0, C)
    assert len(calls) == 1 and tdia.dia_spmm.launches == 1
    name_, args = calls[0]
    assert name_ == f"sblas_dia_spmm_{_kernels.SUFFIX[dtype]}"
    vals, table, b, c, o = args[:5]
    runs = tdia.dia_runs(plan.offsets)
    assert vals is plan.vals and b is B and c is C and o is out
    assert table.dtype == torch.int32 and tuple(table.shape) == (len(runs), 3)
    assert args[5:] == (len(runs), nd, max(w for _, _, w in runs), m, n, 64,
                        96, 64, -2.5, 0.0)
    assert out.shape == (m, 64) and out.dtype == dtype
    assert "dia_loop_calls" not in rec.counters
    assert tdia._run_table(plan.offsets, plan.vals.device)[0] is table


def test_dia_spmm_refuses_what_k5_does_not_take(monkeypatch):
    monkeypatch.setattr(_kernels, "launch", _no_launch)
    plan = _plan_case("shell", torch.float32).to("meta")
    m, n = plan.shape
    B = torch.empty((n, 8), device="meta")
    C = torch.empty((m, 8), device="meta")
    for bad, err in (((B.double(), C), KernelError),
                     ((B, C[:-1]), ShapeError),
                     ((B[:, ::2], C[:, :4]), KernelError),
                     ((B, torch.empty((m, 8))), KernelError)):
        with pytest.raises(err):
            tdia.dia_spmm(plan, *bad, 1.0, 1.0)


# ---- K6 (dia_spmv) ----

K6_THREADS = 128
K6_SMEM = 232448   # the H100's shared memory a block may opt into


def _k6_tile_rows(offsets, itemsize: int) -> int:
    """A K6 tile's rows, as the launcher picks them: 128, or as many as
    fit beside the run table (a row: its values padded to an odd stride
    and one element of each run's x window; the windows w - 1 more each),
    a multiple of 4; 0 where 4 do not fit and the values are read in
    place."""
    nd, n_runs = len(offsets), len(tdia.dia_runs(tuple(offsets)))
    head = (n_runs * 12 + 15) // 16 * 16 + (nd - n_runs) * itemsize
    row = ((nd | 1) + n_runs) * itemsize
    if head + K6_THREADS * row <= K6_SMEM:
        return K6_THREADS
    return (K6_SMEM - head) // row // 4 * 4 if head < K6_SMEM else 0


def _k6_schedule(plan, x, y, alpha, beta, tr: int):
    """K6's decomposition in torch: tiles of `tr` rows, each tile's values
    the contiguous stretch vals[r0 * nd:(r0 + rows) * nd]; for each run
    (lo, j0, w) of `dia_runs` one window of x, x[r0 + lo + e] for e <
    rows + w - 1, zero outside [0, n); row q adds vals[q, j0 + d] *
    window[q + d] for the runs and d in order; then beta*y + alpha*acc,
    or alpha*acc where y is None."""
    m, n = plan.shape
    nd = len(plan.offsets)
    flat = plan.vals.reshape(-1)
    out = torch.empty(m, dtype=plan.dtype)
    for r0 in range(0, m, tr):
        rows = min(tr, m - r0)
        tile = flat[r0 * nd:(r0 + rows) * nd].view(rows, nd)
        acc = torch.zeros(rows, dtype=plan.dtype)
        for lo, j0, w in tdia.dia_runs(plan.offsets):
            c = torch.arange(r0 + lo, r0 + lo + rows + w - 1)
            ok = (c >= 0) & (c < n)
            win = torch.zeros(rows + w - 1, dtype=plan.dtype)
            win[ok] = x[c[ok]]
            for d in range(w):
                acc.addcmul_(tile[:, j0 + d], win[d:d + rows])
        out[r0:r0 + rows] = (alpha * acc if y is None else
                             beta * y[r0:r0 + rows] + alpha * acc)
    return out


def test_k6_threads_are_the_kernels():
    """The schedule's tile rows are the kernel's (`kSpmvThreads`), and
    the launcher takes the arguments `_kernels.LAUNCHERS` declares."""
    src = SOURCE.read_text()
    threads = re.search(r"constexpr int kSpmvThreads = (\d+);", src)
    assert threads and int(threads.group(1)) == K6_THREADS
    types, variants = _kernels.LAUNCHERS["dia_spmv"]
    assert variants == ("f32", "f64")
    for v in variants:
        sig = re.search(rf"int sblas_dia_spmv_{v}\(([^)]*)\)", src)
        assert sig and sig.group(1).count(",") + 1 == len(types) + 1


@pytest.mark.parametrize("name,rows", [
    ("shell", (128, 128)), ("gaps", (128, 128)), ("many", (52, 24)),
    ("huge", (0, 0))])
def test_k6_tile_rows(name, rows):
    """128 rows a tile while they fit; fewer, a multiple of 4, at 1001
    diagonals; none at 12001 (the values read in place)."""
    plan = _plan_case(name, torch.float32)
    assert (_k6_tile_rows(plan.offsets, 4),
            _k6_tile_rows(plan.offsets, 8)) == rows


K6_NAMES = ["shell", "gaps", "wide", "shard", "halo", "edges", "many"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", K6_NAMES)
@pytest.mark.parametrize("alpha,beta,with_y,tr", [
    (3.0, 4.0, True, None), (-2.5, 0.0, True, 36), (1.0, 0.0, False, None)])
def test_k6_schedule_matches_plain(dtype, name, alpha, beta, with_y, tr):
    """The schedule forms the plain loop's products in its order, so it
    agrees with `spmv_dia_plain` to rounding: normwise 1e-12 in f64,
    1e-6 in f32, at the kernel's tile rows and at 36 (a ragged last
    tile), on plans with m != n and offsets past both edges.  An Inf in x
    gives Inf and NaN in the same places, and a NaN in y at beta = 0
    reaches its row."""
    plan = _plan_case(name, dtype)
    m, n = plan.shape
    tr = tr or _k6_tile_rows(plan.offsets, plan.vals.element_size())
    g = torch.Generator().manual_seed(m + n)
    x = torch.rand(n, generator=g, dtype=torch.float64).to(dtype)
    y = torch.rand(m, generator=g, dtype=torch.float64).to(dtype)
    want = tdia.spmv_dia_plain(plan, x, alpha, beta,
                               y if with_y else torch.zeros_like(y))
    got = _k6_schedule(plan, x, y if with_y else None, alpha, beta, tr)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale
    x[n // 2] = float("inf")
    y[m // 3] = float("nan")
    want = tdia.spmv_dia_plain(plan, x, alpha, beta,
                               y if with_y else torch.zeros_like(y))
    got = _k6_schedule(plan, x, y if with_y else None, alpha, beta, tr)
    assert torch.equal(want.isnan(), got.isnan())
    assert torch.equal(want.isinf(), got.isinf())
    assert bool(got[m // 3].isnan()) == with_y


def test_k6_schedule_reads_huge_plans_in_place():
    """12001 diagonals: no 4 rows fit in shared memory, so K6 reads the
    values and x in place, one row a thread, run by run; the same sums."""
    plan = _plan_case("huge", torch.float32)
    m, n = plan.shape
    g = torch.Generator().manual_seed(1)
    x, y = torch.rand(n, generator=g), torch.rand(m, generator=g)
    want = tdia.spmv_dia_plain(plan, x, 3.0, 4.0, y)
    got = _k6_schedule(plan, x, y, 3.0, 4.0, K6_THREADS)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_spmv_dia_on_cpu_is_the_plain_loop(monkeypatch):
    monkeypatch.setattr(_kernels, "launch", _no_launch)
    plan = _plan_case("shell", torch.float32)
    m, n = plan.shape
    x, y = torch.rand(n), torch.rand(m)
    with trace.recording() as rec:
        got = spmv(plan, x, 3.0, 4.0, y)
    assert torch.equal(got, tdia.spmv_dia_plain(plan, x, 3.0, 4.0, y))
    assert rec.counters == {"dia_spmv_loop_calls": 1}


def test_spmv_dia_bf16_off_the_cpu_takes_the_loop(monkeypatch):
    """A bf16 plan off the CPU runs the loop (its bf16 running sum),
    counted as `dia_spmv_loop_calls`; K6 is not launched."""
    monkeypatch.setattr(_kernels, "launch", _no_launch)
    plan = _plan_case("shell", torch.bfloat16).to("meta")
    m, n = plan.shape
    x = torch.empty(n, dtype=torch.bfloat16, device="meta")
    y = torch.empty(m, dtype=torch.bfloat16, device="meta")
    with trace.recording() as rec:
        out = spmv(plan, x, 3.0, 4.0, y)
        spmv(plan, x, 3.0, 4.0, y)
    assert rec.counters == {"dia_spmv_loop_calls": 2}
    assert out.shape == (m,) and out.dtype == torch.bfloat16


def _dispatched(fn) -> tuple:
    """fn()'s result and the ATen ops it dispatched."""
    from torch.utils._python_dispatch import TorchDispatchMode
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Record():
        out = fn()
    return out, ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["shell", "shard", "halo", "many"])
def test_spmv_dia_off_the_cpu_launches_k6_once(monkeypatch, dtype, name):
    """f32 and f64 plans off the CPU: one K6 launch a call with the
    offsets' table, x, y and an `empty` result, counted as
    `dia_spmv_kernel_calls`; no pad of x, no accumulator fill, no
    epilogue op is dispatched beside it."""
    calls = _recorded_launches(monkeypatch)
    plan = _plan_case(name, dtype).to("meta")
    (m, n), nd = plan.shape, len(plan.offsets)
    x = torch.empty(n, dtype=dtype, device="meta")
    y = torch.empty(m, dtype=dtype, device="meta")
    tdia.dia_spmv.launches = 0
    table = tdia._run_table(plan.offsets, plan.vals.device)[0]
    with trace.recording() as rec:
        out, ops = _dispatched(lambda: spmv(plan, x, -2.5, 0.0, y))
    assert len(calls) == 1 and tdia.dia_spmv.launches == 1
    assert set(ops) == {"empty"}, ops
    name_, args = calls[0]
    assert name_ == f"sblas_dia_spmv_{_kernels.SUFFIX[dtype]}"
    assert all(a is b for a, b in zip(args[:5], (plan.vals, table, x, y,
                                                  out)))
    n_runs = len(tdia.dia_runs(plan.offsets))
    assert tuple(table.shape) == (n_runs, 3)
    assert args[5:] == (n_runs, nd, m, n, -2.5, 0.0)
    assert out.shape == (m,) and out.dtype == dtype
    assert rec.counters == {"dia_spmv_kernel_calls": 1}


def test_run_table_is_kept_for_captured_graphs():
    """The run table K5 and K6 read is made once per offsets and device
    and never evicted (a captured graph keeps its address)."""
    plan = _plan_case("edges", torch.float32)
    table, wmax = tdia._run_table(plan.offsets, plan.vals.device)
    assert table.tolist() == [[-53, 0, 1], [-2, 1, 1], [0, 2, 1],
                              [5, 3, 1], [71, 4, 1]] and wmax == 1
    assert tdia._run_table.cache_info().maxsize is None
    assert tdia._run_table(plan.offsets, plan.vals.device)[0] is table


def test_dia_spmv_refuses_what_k6_does_not_take(monkeypatch):
    monkeypatch.setattr(_kernels, "launch", _no_launch)
    plan = _plan_case("shell", torch.float32).to("meta")
    m, n = plan.shape
    x = torch.empty(n, device="meta")
    y = torch.empty(m, device="meta")
    for bad, err in (((x.double(), y), KernelError),
                     ((x, y[:-1]), ShapeError),
                     ((x[:-1], y), ShapeError),
                     ((torch.empty(2 * n, device="meta")[::2], y),
                      KernelError),
                     ((x, torch.empty(m)), KernelError),
                     ((x, y.double()), KernelError)):
        with pytest.raises(err):
            tdia.dia_spmv(plan, *bad, 1.0, 1.0)
    bf = _plan_case("shell", torch.bfloat16).to("meta")
    with pytest.raises(KernelError):
        tdia.dia_spmv(bf, x.bfloat16(), y.bfloat16(), 1.0, 1.0)


def test_spmv_dia_takes_x_in_the_plans_dtype(monkeypatch):
    """An x of another dtype or stride is taken in the plan's dtype with
    unit stride, and K6 launched once."""
    calls = _recorded_launches(monkeypatch)
    plan = _plan_case("shell", torch.float32).to("meta")
    m, n = plan.shape
    x = torch.empty(2 * n, dtype=torch.float64, device="meta")[::2]
    y = torch.empty(m, device="meta")
    out = spmv(plan, x, 3.0, 4.0, y)
    assert len(calls) == 1 and out.dtype == torch.float32
    xa = calls[0][1][2]
    assert xa.dtype == torch.float32 and xa.stride() == (1,)


@pytest.mark.parametrize("plan_dtype,y_dtype,jax_dtypes,bar", [
    (torch.float32, torch.float64, (jnp.float32, jnp.float64), 1e-5),
    (torch.float64, torch.float32, (jnp.float64, jnp.float32), 1e-6)])
def test_spmv_dia_keeps_a_wider_y(monkeypatch, plan_dtype, y_dtype,
                                  jax_dtypes, bar):
    """y of another dtype than the plan: the result has the dtype
    `beta*y + alpha*(A@x)` has, and a wider y is never rounded to the
    plan's dtype.  On the CPU that is the plain loop, which meets the JAX
    package's spmv_dia (which keeps y in its dtype) at the plan dtype's
    error.  Off the CPU K6 forms A@x alone (no y, alpha 1, beta 0) and the
    epilogue runs in the result's dtype (`plans.fold`): K6's schedule
    folded so equals the plain loop to the result dtype's rounding."""
    A = _offsets_matrix(200, [*range(-40, -34), *range(-3, 4), 17,
                              *range(50, 54)])
    rng = np.random.RandomState(0)
    x = rng.rand(A.width)
    y = rng.rand(A.height) * 1000 + 1
    plan = make_plan(A, dtype=plan_dtype, force="dia", device="cpu")
    yt = torch.from_numpy(y).to(y_dtype)
    xt = torch.from_numpy(x).to(plan_dtype)
    got = spmv(plan, xt, ALPHA, BETA, yt)
    res = torch.promote_types(plan_dtype, y_dtype)
    assert got.dtype == res
    if res == y_dtype:
        assert not torch.equal(got, got.to(plan_dtype).to(y_dtype))
    folded = fold(ALPHA, _k6_schedule(plan, xt, None, 1.0, 0.0, 128), BETA,
                  yt, plan_dtype)
    assert folded.dtype == res
    tol = 1e-12 if plan_dtype == torch.float64 else 1e-6
    assert float((folded - got).abs().max()) <= tol * float(got.abs().max())
    jp = jdia.DiaPlan.from_csr(
        JCsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape),
        dtype=jax_dtypes[0])
    want = np.asarray(jdia.spmv_dia(jp, jnp.asarray(x, jax_dtypes[0]),
                                    ALPHA, BETA,
                                    jnp.asarray(y, jax_dtypes[1])))
    assert want.dtype == got.numpy().dtype
    rel = np.abs(got.numpy() - want) / np.abs(want)
    assert rel.max() <= bar, rel.max()
    calls = _recorded_launches(monkeypatch)
    mp = plan.to("meta")
    out = spmv(mp, xt.to("meta"), ALPHA, BETA, yt.to("meta"))
    assert out.dtype == res and len(calls) == 1
    args = calls[0][1]
    assert args[3] is None and args[-2:] == (1.0, 0.0)
