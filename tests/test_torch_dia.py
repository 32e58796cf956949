"""The DIA SpMM's kernel K5 (`ops/dia.py::dia_spmm`,
csrc/dia_kernels.cu) on the CPU: its run table, its schedule run here in
torch against the plain loop, and the dispatch of `spmm_dia`.

K5 itself runs only on the card (tests/test_torch_kernels_cuda.py).  Here
`dia_runs` is checked on hand-made and shard offsets, K5's decomposition
(a tile of rows, a 256-byte column slice, one zero-filled B window a
run, the epilogue on C's tile) is replayed in torch at the plans the
kernel serves, and `spmm_dia` is driven on a device off the CPU (`meta`:
shapes without storage) with the launcher replaced, to see what it would
launch."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sblas_tpu_torch import _kernels
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.io.generate import fem_banded_like, fem_shell_like
from sblas_tpu_torch.ops import make_plan, spmm
from sblas_tpu_torch.ops import dia as tdia
from sblas_tpu_torch.parallel import partition_halo_dia, partition_row_plans
from sblas_tpu_torch.utils import trace
from sblas_tpu_torch.utils.errors import KernelError, ShapeError

SOURCE = Path(tdia.__file__).parents[1] / "csrc" / "dia_kernels.cu"


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
    A = fem_shell_like(nx=16, ny=8, n_target=768, dtype=np.float64)
    if name == "shard":
        return partition_row_plans(A, 3, dtype=dtype, kind="dia",
                                   device="cpu").plans[1]
    return partition_halo_dia(A, 3, dtype=dtype, device="cpu").plans[2]


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
