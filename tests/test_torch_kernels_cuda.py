"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`: each test skips without a CUDA device.  This file imports
no jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

(`--noconftest` skips tests/conftest.py, which configures jax for the
JAX package's tests.)"""

import dataclasses

import numpy as np
import pytest
import torch

from sblas_tpu_torch.containers import DenseVector
from sblas_tpu_torch.io.generate import webbase_like
from sblas_tpu_torch.ops import make_plan, spmv
from sblas_tpu_torch.ops import route as troute
from sblas_tpu_torch.ops import rspmv as tr
# K1's variants: (value dtype, index dtype); K2's: (value dtype, stored)
from sblas_tpu_torch.ops.route import LANE_SHUFFLE_VARIANTS as K1_VARIANTS
from sblas_tpu_torch.ops.rspmv import SLAB_GATHER_VARIANTS as K2_VARIANTS
from sblas_tpu_torch.utils.errors import KernelError, ShapeError

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _reset_k1() -> None:
    troute.lane_shuffle.launches = 0
    troute.lane_shuffle_transposed.launches = 0


def _k1_launches() -> int:
    """K1 launches of both bodies (the row body and the transposed
    store, each counted by its own wrapper) since `_reset_k1`."""
    return (troute.lane_shuffle.launches
            + troute.lane_shuffle_transposed.launches)


def _launched_of(kernel: str) -> dict:
    """Launches of K1 (`lane_shuffle`) or K2 (`slab_gather`) by variant
    since `_kernels.LAUNCHED` was last cleared."""
    from sblas_tpu_torch import _kernels
    pre = f"sblas_{kernel}_"
    return {k[len(pre):]: v for k, v in _kernels.LAUNCHED.items()
            if k.startswith(pre)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 37, 2048, 32768])
def test_lane_shuffle_kernel_matches_plain(dev, dtype, rows):
    from sblas_tpu_torch import _kernels
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn((rows, 128), generator=g, device=dev, dtype=dtype)
    idx = torch.randint(0, 128, (rows, 128), generator=g, device=dev,
                        dtype=torch.int32)
    before = troute.lane_shuffle.launches
    _kernels.LAUNCHED.clear()
    got = troute.lane_shuffle(x, idx)
    torch.cuda.synchronize()
    assert troute.lane_shuffle.launches == before + 1
    assert _launched_of("lane_shuffle") == {_kernels.SUFFIX[dtype]: 1}
    assert torch.equal(got, troute.lane_shuffle_plain(x, idx))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_tiles,n_slabs", [(1, 1), (5, 3), (14, 12),
                                             (188, 62)])
def test_slab_gather_kernel_matches_plain(dev, dtype, n_tiles, n_slabs):
    g = torch.Generator(device=dev).manual_seed(n_tiles)
    x_slabs = torch.randn((n_slabs, 128, 128), generator=g, device=dev,
                          dtype=dtype)
    gslab = torch.randint(0, n_slabs, (n_tiles,), generator=g, device=dev,
                          dtype=torch.int32)
    gidx = torch.randint(0, 128, (n_tiles, 128, 128), generator=g,
                         device=dev, dtype=torch.int32)
    gvals = torch.randn((n_tiles, 128, 128), generator=g, device=dev,
                        dtype=dtype)
    from sblas_tpu_torch import _kernels
    before = tr.slab_gather.launches
    _kernels.LAUNCHED.clear()
    got = tr.slab_gather(gslab, x_slabs, gidx, gvals)
    torch.cuda.synchronize()
    assert tr.slab_gather.launches == before + 1
    assert _launched_of("slab_gather") == {_kernels.SUFFIX[dtype]: 1}
    assert torch.equal(got, tr.slab_gather_plain(gslab, x_slabs, gidx,
                                                 gvals))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 128), device=dev)
    idx = torch.zeros((4, 128), device=dev, dtype=torch.int32)
    with pytest.raises(KernelError):
        troute.lane_shuffle(x, idx.long())
    with pytest.raises(KernelError):
        troute.lane_shuffle(x.half(), idx)
    with pytest.raises(KernelError):
        troute.lane_shuffle(torch.zeros((128, 4), device=dev).t(), idx)
    with pytest.raises(ShapeError):
        troute.lane_shuffle(x, idx[:2])
    with pytest.raises(KernelError):
        troute.lane_shuffle(x, idx.cpu())
    slabs = torch.zeros((1, 128, 128), device=dev)
    tiles = torch.zeros((2, 128, 128), device=dev)
    gslab = torch.zeros(2, device=dev, dtype=torch.int32)
    with pytest.raises(KernelError):
        tr.slab_gather(gslab, slabs, tiles.int(), tiles.double())
    with pytest.raises(ShapeError):
        tr.slab_gather(gslab[:1], slabs, tiles.int(), tiles)


@pytest.mark.parametrize("dtype,np_dtype", [(torch.float64, np.float64),
                                            (torch.float32, np.float32)])
def test_spmv_routed_on_card_matches_cpu(dev, dtype, np_dtype):
    A = webbase_like(n=100_000, avg_deg=4.0, dtype=np_dtype)
    plan = make_plan(A, dtype=dtype, op="spmv", device="cpu")
    assert isinstance(plan, tr.RoutedPlan)
    x = torch.from_numpy(DenseVector.random(A.width, dtype=np_dtype).values)
    y = torch.ones(A.height, dtype=dtype)
    want = spmv(plan, x, 3.0, 4.0, y)
    on_card = plan.to(dev)
    _reset_k1()
    tr.slab_gather.launches = 0
    got = spmv(on_card, x.to(dev), 3.0, 4.0, y.to(dev)).cpu()
    assert _k1_launches() == plan.n_route_gathers
    assert tr.slab_gather.launches == 1
    # the card may sum in another order than the CPU
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    coo = make_plan(A, dtype=dtype, force="coo", device=dev)
    torch.testing.assert_close(spmv(coo, x.to(dev), 3.0, 4.0,
                                    y.to(dev)).cpu(), want,
                               rtol=tol, atol=tol)


# ---- K1's transposed store: a route's gather and the transpose after it

# the transposes of the webbase-1M PageRank plan's routes: the main route
# (4,194,304 elements), then the x relabel and the unrank (1,048,576)
CELL_TRANSPOSES = [(1, 32768, 128), (128, 256, 128), (128, 128, 256),
                   (1, 128, 32768), (1, 8192, 128), (128, 64, 128),
                   (128, 128, 64), (1, 128, 8192)]
_rng = np.random.RandomState(24)
SMALL_TRANSPOSES = [(1, 16, 128), (3, 16, 128), (2, 128, 16),
                    (1, 128, 32), (5, 48, 128), (2, 128, 384),
                    (1, 384, 128), (7, 64, 64), (1, 1040, 128)] + [
    (int(_rng.randint(1, 5)), 16 * int(_rng.randint(1, 40)),
     int(_rng.choice([16, 32, 64, 128, 256, 384]))) for _ in range(6)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes, for a bitwise comparison."""
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("shape", CELL_TRANSPOSES + SMALL_TRANSPOSES)
@pytest.mark.parametrize("variant", list(K1_VARIANTS))
def test_lane_shuffle_transposed_matches_unfused(dev, variant, shape):
    """K1 with the transposed store: one launch, bitwise the row body
    followed by `permute().contiguous()` and the plain version."""
    from sblas_tpu_torch import _kernels
    dt, it = K1_VARIANTS[variant]
    nb, P, Q = shape
    rows = nb * P * Q // 128
    g = torch.Generator(device=dev).manual_seed(rows + P)
    x = torch.randn((rows, 128), generator=g, device=dev).to(dt)
    idx = torch.randint(0, 128, (rows, 128), generator=g, device=dev,
                        dtype=torch.int32).to(it)
    before = (troute.lane_shuffle.launches,
              troute.lane_shuffle_transposed.launches)
    _kernels.LAUNCHED.clear()
    got = troute.lane_shuffle_transposed(x, idx, shape)
    torch.cuda.synchronize()
    assert (troute.lane_shuffle.launches,
            troute.lane_shuffle_transposed.launches) == (before[0],
                                                         before[1] + 1)
    assert dict(_kernels.LAUNCHED) == {
        f"sblas_lane_shuffle_transposed_{variant}": 1}
    assert got.shape == (nb, Q, P) and got.is_contiguous()
    unfused = troute.lane_shuffle(x, idx).reshape(shape).permute(
        0, 2, 1).contiguous()
    assert torch.equal(_bits(got), _bits(unfused))
    assert torch.equal(_bits(got), _bits(
        troute.lane_shuffle_transposed_plain(x, idx, shape)))


def test_lane_shuffle_transposed_refuses_what_it_cannot_store(dev):
    x = torch.zeros((64, 128), device=dev)
    idx = torch.zeros((64, 128), device=dev, dtype=torch.int32)
    with pytest.raises(ShapeError):
        troute.lane_shuffle_transposed(x, idx, (1, 8, 1024))
    with pytest.raises(ShapeError):
        troute.lane_shuffle_transposed(x, idx, (2, 16, 128))
    with pytest.raises(KernelError):
        troute.lane_shuffle_transposed(x, idx.long(), (1, 64, 128))
    with pytest.raises(KernelError):
        troute.lane_shuffle_transposed(x.half(), idx, (1, 64, 128))


_ROUTES = {}


def _route(n: int):
    """A route of a seeded random permutation of n, and the permutation."""
    if n not in _ROUTES:
        perm = np.random.RandomState(n).permutation(n)
        _ROUTES[n] = (perm, troute.build_route(perm))
    return _ROUTES[n]


# 300 -> a mix layer only; 16384 -> A = 128; 40000 -> 128^2 * 3, a mix
# level inside; 81920 = 128^2 * 5; 262144 -> two transpose levels; 1M ->
# the cell's x relabel; 128^3 * 2 -> the cell's main route
@pytest.mark.parametrize("n", [300, 16384, 40000, 81920, 262144, 1_000_000,
                               2 * 128 ** 3])
@pytest.mark.parametrize("variant", list(K1_VARIANTS))
def test_apply_route_fused_matches_numpy(dev, variant, n):
    """`apply_route` on the card stores every transpose inside K1: one K1
    launch a gather, one transposed store a transpose, no copy, and the
    numpy mirror's answer bitwise (int16 tables under `bf16_i16`)."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.utils import trace
    dt, it = K1_VARIANTS[variant]
    perm, prog = _route(n)
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(n)
                         ).to(dt)
    x_pad = torch.nn.functional.pad(x, (0, prog.n - n)).to(dev)
    tables = troute.route_tables(
        prog, dev, np.int16 if it == torch.int16 else np.int32)
    n_vt = sum(op[0] == "view_transpose" for op in prog.ops)
    _reset_k1()
    _kernels.LAUNCHED.clear()
    with trace.recording() as rec:
        got = troute.apply_route(prog.schedule, x_pad, tables)
    torch.cuda.synchronize()
    assert troute.lane_shuffle.launches == prog.n_gathers - n_vt
    assert troute.lane_shuffle_transposed.launches == n_vt
    assert _kernels.LAUNCHED[f"sblas_lane_shuffle_transposed_{variant}"
                             ] == n_vt
    assert _kernels.LAUNCHED[f"sblas_lane_shuffle_{variant}"
                             ] == prog.n_gathers - n_vt
    assert rec.counters.get("route_transposes_fused", 0) == n_vt
    assert "route_transpose_copies" not in rec.counters
    wide = torch.float32 if dt == BF16 else dt
    want = troute.apply_route_np(prog, x.to(wide).numpy())
    assert np.array_equal(got[:n].cpu().to(wide).numpy(), want)
    assert torch.equal(_bits(got[:n].cpu()), _bits(x[perm]))


def _pagerank_cell_plan(dev):
    """P^T of `webbase_like()` (1M pages, f32) on a routed plan: the
    PageRank cell's matrix as `examples.pagerank.transition` builds it."""
    from sblas_tpu_torch.examples.pagerank import transition
    PT, _ = transition(webbase_like(), np.float32)
    return make_plan(PT, dtype=torch.float32, op="spmv", device=dev)


def _fusions(plan) -> tuple:
    """(gathers, transposes) over the plan's three routes."""
    scheds = (plan.xroute_schedule, plan.schedule, plan.unrank_schedule)
    return (sum(op[0] == "gather" for s in scheds for op in s),
            sum(op[0] == "view_transpose" for s in scheds for op in s))


def test_routed_spmv_fuses_every_transpose(dev):
    """The PageRank cell's routed SpMV: 16 K1 launches, 12 of them with
    the transposed store, no permute (so no copy kernel) for a transpose;
    `route_transposes_fused` 12, `route_transpose_copies` 0."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.utils import trace

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    plan = _pagerank_cell_plan(dev)
    assert isinstance(plan, tr.RoutedPlan)
    assert _fusions(plan) == (16, 12) == (plan.n_route_gathers, 12)
    x = torch.rand(plan.shape[1], device=dev)
    y = torch.rand(plan.shape[0], device=dev)
    spmv(plan, x, 0.85, 0.0, y)
    torch.cuda.synchronize()
    _reset_k1()
    _kernels.LAUNCHED.clear()
    with trace.recording() as rec, Ops() as ops:
        spmv(plan, x, 0.85, 0.0, y)
    torch.cuda.synchronize()
    assert _k1_launches() == 16
    assert (troute.lane_shuffle.launches,
            troute.lane_shuffle_transposed.launches) == (4, 12)
    assert _kernels.LAUNCHED["sblas_lane_shuffle_transposed_f32"] == 12
    assert _kernels.LAUNCHED["sblas_lane_shuffle_f32"] == 4
    assert rec.counters.get("route_transposes_fused") == 12
    assert rec.counters.get("route_transpose_copies", 0) == 0
    assert not [op for op in ops.seen if "permute" in op]


def _unfused(schedule, x, tables):
    """`apply_route` with every transpose a copy: the route as K1's row
    body and the permute copies ran it before the transposed store."""
    return troute.execute_steps(troute.route_steps(tuple(schedule), False),
                                x, tables)


def _routed_case(dev, case: str):
    """A routed plan of webbase 100k on the card and its operands: f32,
    f64 and bf16 values, or f32 under the bf16 route transport."""
    dt = {"f64": torch.float64, "bf16": BF16}.get(case, torch.float32)
    A = webbase_like(n=100_000, avg_deg=4.0,
                     dtype=np.float64 if case == "f64" else np.float32)
    plan = make_plan(A, dtype=dt, op="spmv", device=dev)
    assert isinstance(plan, tr.RoutedPlan)
    if case == "transport":
        plan = plan.with_transport("bf16")
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(A.width, generator=g, device=dev).to(dt)
    y = torch.randn(A.height, generator=g, device=dev).to(dt)
    return plan, x, y


@pytest.mark.parametrize("case", ["f32", "f64", "bf16", "transport"])
def test_routed_spmv_fused_is_bitwise_unfused(dev, case, monkeypatch):
    """The routed SpMV with the transposed store gives the bits of the
    route run as K1 and permute copies, in every value type and under
    the bf16 transport."""
    plan, x, y = _routed_case(dev, case)
    assert _fusions(plan)[1] > 0
    fused = spmv(plan, x, 3.0, 4.0, y)
    monkeypatch.setattr(tr, "apply_route", _unfused)
    unfused = spmv(plan, x, 3.0, 4.0, y)
    torch.cuda.synchronize()
    assert torch.equal(_bits(fused), _bits(unfused))


@pytest.mark.parametrize("case", ["f32", "transport"])
def test_routed_spmv_graph_replay_is_bitwise_eager(dev, case):
    """The routed SpMV captured in a CUDA graph (the transposed stores'
    PDL launches become programmatic edges) replays the eager bits, and
    again after new input."""
    plan, x, y = _routed_case(dev, case)
    want = spmv(plan, x, 3.0, 4.0, y)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        spmv(plan, x, 3.0, 4.0, y)      # warm-up off the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = spmv(plan, x, 3.0, 4.0, y)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    x.copy_(torch.flip(x, (0,)))
    want = spmv(plan, x, 3.0, 4.0, y)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


# ---- K2' (tile_gather) and the distributed routed SpMV ----

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_tiles", [1, 7, 188])
def test_tile_gather_kernel_matches_plain(dev, dtype, n_tiles):
    g = torch.Generator(device=dev).manual_seed(n_tiles)
    shape = (n_tiles, 128, 128)
    x_tiles = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    gidx = torch.randint(0, 128, shape, generator=g, device=dev,
                         dtype=torch.int32)
    gvals = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    before = tr.tile_gather.launches
    got = tr.tile_gather(x_tiles, gidx, gvals)
    torch.cuda.synchronize()
    assert tr.tile_gather.launches == before + 1
    assert torch.equal(got, tr.tile_gather_plain(x_tiles, gidx, gvals))
    with pytest.raises(KernelError):
        tr.tile_gather(x_tiles, gidx.long(), gvals)
    with pytest.raises(ShapeError):
        tr.tile_gather(x_tiles, gidx[:, :64], gvals)


@pytest.mark.parametrize("dtype,np_dtype", [(torch.float64, np.float64),
                                            (torch.float32, np.float32)])
def test_distributed_routed_shards_on_card(dev, dtype, np_dtype):
    """Four routed shards of one matrix, each rank's compute run on the
    card (no process group): K2' once per shard, K2 never, and each
    shard's local product equals the CPU's."""
    from sblas_tpu_torch.config import SBlasConfig
    from sblas_tpu_torch.parallel import (partition_row_plans,
                                          spmv_dist_planned_nocomm)
    from sblas_tpu_torch.parallel.mesh import Mesh
    A = webbase_like(n=100_000, avg_deg=4.0, dtype=np_dtype)
    cfg = SBlasConfig(routed_min_nnz=1000, routed_min_width=512)
    cpu = partition_row_plans(A, 4, dtype=dtype, kind="routed", config=cfg,
                              device="cpu")
    sh = dataclasses.replace(cpu, plans=tuple(p.to(dev) for p in cpu.plans))
    x = torch.from_numpy(DenseVector.random(A.width, dtype=np_dtype).values)
    tr.tile_gather.launches = tr.slab_gather.launches = 0
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for s in range(4):
        got = spmv_dist_planned_nocomm(sh, x.to(dev), Mesh(None, s, 4, dev))
        want = spmv_dist_planned_nocomm(cpu, x, Mesh(None, s, 4, "cpu"))
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
    assert (tr.tile_gather.launches, tr.slab_gather.launches) == (4, 0)


# ---- K3 (window_reduce) and K4 (bell_spmm) ----

def _wcoo_plan(dev, dtype, n=20_000, seed=5):
    from sblas_tpu_torch.ops.wcoo import WcooPlan
    A = webbase_like(n=n, avg_deg=4.0, seed=seed,
                     dtype=np.float64 if dtype == torch.float64 else
                     np.float32)
    return A, WcooPlan.from_csr(A, dtype=dtype, device=dev)


def _long_row(A, row=777, length=10_000, seed=3):
    """A with row `row` replaced by `length` entries in distinct columns."""
    from sblas_tpu_torch.containers import CooMatrix
    c = A.to_coo()
    keep = c.row_idx != row
    rng = np.random.RandomState(seed)
    cols = rng.choice(A.shape[1], size=length, replace=False)
    return CooMatrix(
        np.concatenate([c.row_idx[keep], np.full(length, row)]),
        np.concatenate([c.col_idx[keep], cols]),
        np.concatenate([c.values[keep],
                        rng.random_sample(length).astype(c.values.dtype)]),
        A.shape).to_csr()


def _k3_case(dev, dtype, case):
    """(plan, columns of B) of each K3 case: webbase proxies of 3k, 20k
    and 200k rows; the 20k one with a row of 10,000 entries; a shard
    plan padded by `min_tiles` (pad tiles at the last window)."""
    from sblas_tpu_torch.ops.wcoo import WcooPlan, wcoo_tile_count
    n = {"web3k": 3_000, "web200k": 200_000}.get(case, 20_000)
    A, plan = _wcoo_plan(dev, dtype, n=n)
    if case == "long_row":
        A = _long_row(A)
        assert int(A.row_nnz.max()) == 10_000
        plan = WcooPlan.from_csr(A, dtype=dtype, device=dev)
    elif case == "min_tiles":
        plan = WcooPlan.from_csr(A, dtype=dtype, device=dev,
                                 min_tiles=wcoo_tile_count(A) + 5)
    return plan, {"web3k": 45}.get(case, 80)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,k0,width", [
    ("web20k", 0, 64), ("web3k", 13, 31), ("web200k", 0, 64),
    ("web20k", 13, 1), ("web20k", 13, 31), ("web20k", 13, 64),
    ("web20k", 13, 65), ("long_row", 0, 64), ("long_row", 13, 65),
    ("min_tiles", 13, 64), ("min_tiles", 2, 78)])
def test_window_reduce_kernel_matches_plain(dev, dtype, case, k0, width):
    from sblas_tpu_torch.ops import wcoo as tw
    plan, k = _k3_case(dev, dtype, case)
    g = torch.Generator(device=dev).manual_seed(k0 + width)
    B = torch.rand((plan.shape[1], k), generator=g, device=dev, dtype=dtype)
    args = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk,
            plan.lane, B, k0, width)
    before = tw.window_reduce.launches
    got = tw.window_reduce(*args)
    again = tw.window_reduce(*args)
    torch.cuda.synchronize()
    assert tw.window_reduce.launches == before + 2
    assert torch.equal(got, again)            # deterministic: no atomics
    want = tw.window_reduce_plain(*args)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# K4's cases: (dtype, n, half_band, K, case).  Every dtype at the plain
# shapes; f64 also at odd K (an 8K-byte row stride off 16 bytes), B, C and
# out as views one element into their storage, a plan without slots,
# alpha = 0 and beta = 0, and values and B spread over 2^-40 .. 2^40
_K4_SHAPES = [(700, 9, 17), (3000, 36, 128), (3000, 36, 256),
              (20_000, 36, 300)]
_K4_CASES = ([(dt, *shape, "plain") for dt in DTYPES for shape in _K4_SHAPES]
             + [(torch.float64, n, hb, k, case) for n, hb, k, case in (
                 (700, 9, 1, "plain"), (700, 9, 7, "plain"),
                 (3000, 36, 63, "plain"), (3000, 36, 256, "offset"),
                 (3000, 36, 63, "offset"), (3000, 36, 256, "no_slots"),
                 (700, 9, 7, "no_slots"), (3000, 36, 256, "alpha0"),
                 (3000, 36, 256, "beta0"), (3000, 36, 256, "mixed"),
                 (3000, 36, 63, "mixed"))])


def _offset_copy(t: torch.Tensor) -> torch.Tensor:
    """t's values in a view one element into its storage."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("dtype,n,half_band,k,case", _K4_CASES)
def test_bell_spmm_kernel_matches_plain(dev, dtype, n, half_band, k, case):
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops.bsr import BsrPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    A = fem_banded_like(n=n, half_band=half_band)
    rng = np.random.RandomState(n + k)
    if case == "mixed":
        A.values[:] = (rng.uniform(-1, 1, A.nnz)
                       * np.exp2(rng.uniform(-40, 40, A.nnz)))
    plan = BsrPlan.from_csr(A, dtype=dtype, device=dev)
    vals, bcol = plan.vals, plan.bcol
    if case == "no_slots":
        vals, bcol = vals[:, :0].contiguous(), bcol[:, :0].contiguous()
    g = torch.Generator(device=dev).manual_seed(n)
    B = torch.rand((n, k), generator=g, device=dev, dtype=dtype)
    C = torch.rand((n, k), generator=g, device=dev, dtype=dtype)
    if case == "mixed":
        B = torch.from_numpy(rng.uniform(-1, 1, (n, k))
                             * np.exp2(rng.uniform(-40, 40, (n, k)))
                             ).to(dev, dtype)
    out = None
    if case == "offset":
        B, C, out = _offset_copy(B), _offset_copy(C), _offset_copy(C)
    alpha, beta = {"alpha0": (0.0, 4.0), "beta0": (3.0, 0.0)}.get(
        case, (3.0, 4.0))
    args = (vals, bcol, B, C, alpha, beta)
    before = tb.bell_spmm.launches
    _kernels.LAUNCHED.clear()
    _kernels.BODIES.clear()
    got = tb.bell_spmm(*args, out=out)
    again = tb.bell_spmm(*args)
    torch.cuda.synchronize()
    assert tb.bell_spmm.launches == before + 2
    assert torch.equal(got, again)
    if out is not None:
        assert got.data_ptr() == out.data_ptr()
    want = tb.bell_spmm_plain(*args)
    if dtype == torch.float64:
        # both launches went through K4[f64]'s mma.sync f64 body: paired
        # 16-byte feeds where K is even and B, C, out start on 16 bytes
        assert dict(_kernels.LAUNCHED) == {"sblas_bell_spmm_f64": 2}
        body = ("dmma" if k % 2 == 0 and case != "offset"
                else "dmma_unpaired")
        assert dict(_kernels.BODIES) == {f"bell_spmm_f64.{body}": 2}
        assert tb.f64_mma_shape() in ("m8n8k4", "m16n8k4", "m16n8k8",
                                      "m16n8k16")
    if case == "mixed":
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        assert rel <= 1e-13, rel
        return
    if case == "alpha0":
        torch.testing.assert_close(got, beta * C, rtol=0, atol=0)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("path", ["mode1", "planned", "bands"])
def test_bell_parts_take_k4(dev, path):
    """A mode-1 block, a planned shard and the streamed bands of a BELL
    plan with 128 x 128 blocks at K = 256 each run K4 (`ops.spmm`'s one
    gate): one f32 launch a block, shard or band, within 1e-5 normwise of
    the batched matmuls (`spmm_bsr_plain`) over the whole plan."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.memory import host_resident_plan, spmm_um
    from sblas_tpu_torch.ops.bsr import BsrPlan, spmm_bsr_plain
    from sblas_tpu_torch.parallel import (Mesh, partition_row_plans,
                                          spmm_mode1,
                                          spmm_mode2_planned_nocomm)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    A = fem_banded_like(n=3000, half_band=36)
    k, mesh = 256, Mesh(None, 0, 1, dev)
    plan = BsrPlan.from_csr(A, device=dev)
    g = torch.Generator(device=dev).manual_seed(256)
    B = torch.rand((A.shape[1], k), generator=g, device=dev)
    C = torch.rand((A.shape[0], k), generator=g, device=dev)
    alpha, beta = 3.0, 4.0
    if path == "mode1":
        run, launches = (lambda: spmm_mode1(plan, B, alpha, beta, C, mesh)), 1
    elif path == "planned":
        sh = partition_row_plans(A, 1, kind="bsr", device=dev)
        assert tuple(sh.local(0).block) == (128, 128)
        C = torch.zeros_like(C)
        alpha, beta = 1.0, 0.0
        run, launches = (lambda: spmm_mode2_planned_nocomm(sh, B, mesh)
                         [: A.shape[0]]), 1
    else:
        hp = host_resident_plan(A, kind="bsr", hbm_budget_bytes=2 << 20,
                                device=dev)
        assert hp.n_bands > 1
        run = lambda: spmm_um(hp, B, alpha, beta, C)   # noqa: E731
        launches = hp.n_bands
    _kernels.LAUNCHED.clear()
    got = run()
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHED) == {"sblas_bell_spmm_f32": launches}
    want = spmm_bsr_plain(plan, B, alpha, beta, C)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel <= 1e-5, rel


def test_bell_spmm_f64_has_no_spill(dev):
    """The build's `-Xptxas -v` report: both K4[f64] bodies (the DMMA
    kernel at each feed) use no local memory for spills."""
    from sblas_tpu_torch import _kernels
    _kernels.library()
    report = _kernels.ptxas_report()
    assert report is not None
    found = _kernels.kernel_resources(report, "bell_spmm_dmma_kernel")
    assert len(found) == 2, found
    for r in found:
        assert (r["spill_stores"], r["spill_loads"]) == (0, 0), r
        assert r["registers"] <= 255, r


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away), as
    cvt.rna.tf32.f32 rounds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("k", [17, 256])
def test_bell_spmm_3xtf32_holds_mixed_magnitudes(dev, k):
    """Values and B spanning about 2^-20 .. 2^20: K4's 3xTF32 stays
    within 1e-5 normwise of the f64 product, where one TF32 product of
    the same operands (both rounded to TF32) does not."""
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops.bsr import BsrPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    A = fem_banded_like(n=3000, half_band=36)
    rng = np.random.RandomState(11)
    A.values[:] = (rng.uniform(-1, 1, A.nnz)
                   * np.exp2(rng.uniform(-20, 20, A.nnz)))
    plan = BsrPlan.from_csr(A, dtype=torch.float32, device=dev)
    B = torch.from_numpy((rng.uniform(-1, 1, (3000, k))
                          * np.exp2(rng.uniform(-20, 20, (3000, k))))
                         .astype(np.float32)).to(dev)
    C = torch.zeros((3000, k), device=dev)
    got = tb.bell_spmm(plan.vals, plan.bcol, B, C, 1.0, 0.0)
    want = tb.bell_spmm_plain(plan.vals.double(), plan.bcol, B.double(),
                              C.double(), 1.0, 0.0)
    one = tb.bell_spmm_plain(_tf32(plan.vals).double(), plan.bcol,
                             _tf32(B).double(), C.double(), 1.0, 0.0)

    def rel(x):
        return float(torch.linalg.norm(x.double() - want)
                     / torch.linalg.norm(want))

    assert rel(got) <= 1e-5, rel(got)
    assert rel(one) > 1e-5, rel(one)


def test_bell_spmm_gate_on_k(dev):
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops import spmm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    A = fem_banded_like(n=1000, half_band=9)
    plan = make_plan(A, dtype=torch.float64, op="spmm", device=dev)
    for k, launches in ((255, 0), (256, 1)):
        B = torch.rand((1000, k), device=dev, dtype=torch.float64)
        tb.bell_spmm.launches = 0
        out = spmm(plan, B, 2.0)
        torch.cuda.synchronize()
        assert tb.bell_spmm.launches == launches
        want = spmm(plan.to("cpu"), B.cpu(), 2.0)
        torch.testing.assert_close(out.cpu(), want, rtol=1e-12, atol=1e-12)


def test_bell_path_refuses_tf32(dev):
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops import spmm
    A = fem_banded_like(n=1000, half_band=9)
    plan = make_plan(A, dtype=torch.float32, op="spmm", device=dev)
    B = torch.rand((1000, 8), device=dev)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(KernelError, match="TF32"):
            spmm(plan, B)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_k3_k4_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops import wcoo as tw
    _, plan = _wcoo_plan(dev, torch.float32, n=3000)
    B = torch.rand((plan.shape[1], 8), device=dev)
    args = [plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk,
            plan.lane, B, 0, 8]
    for i, bad in ((6, B.cpu()), (6, B.double()),
                   (6, torch.rand((8, plan.shape[1]), device=dev).t()),
                   (4, plan.xblk.long())):
        with pytest.raises(KernelError):
            tw.window_reduce(*args[:i], bad, *args[i + 1:])
    with pytest.raises(KernelError):
        tw.window_reduce(*args[:7], 4, 8)          # columns past B's width
    with pytest.raises(ShapeError):
        tw.window_reduce(*args[:2], plan.relrow[:-1], *args[3:])
    vals = torch.zeros((2, 1, 128, 128), device=dev)
    bcol = torch.zeros((2, 1), device=dev, dtype=torch.int32)
    Bb = torch.zeros((256, 4), device=dev)
    Cb = torch.zeros((200, 4), device=dev)
    for bad in ((vals, bcol, Bb.cpu(), Cb), (vals, bcol, Bb, Cb.double()),
                (vals, bcol.long(), Bb, Cb),
                (vals, bcol, torch.zeros((4, 256), device=dev).t(), Cb),
                (vals[:, :, :64, :64].contiguous(), bcol, Bb, Cb),
                (vals, bcol, Bb, Cb[:100])):
        with pytest.raises((KernelError, ShapeError)):
            tb.bell_spmm(*bad, 1.0, 0.0)


@pytest.mark.parametrize("dtype,np_dtype", [(torch.float64, np.float64),
                                            (torch.float32, np.float32)])
def test_spmm_paths_on_card_match_cpu(dev, dtype, np_dtype):
    """Each SpMM plan kind on the card against the same plan on the CPU
    (plain versions), with the launch counts of the kernels on each."""
    from sblas_tpu_torch.containers import DenseMatrix
    from sblas_tpu_torch.io.generate import fem_banded_like, fem_shell_like
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops import spmm
    from sblas_tpu_torch.ops import wcoo as tw
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cases = [(webbase_like(n=50_000, avg_deg=4.0, dtype=np_dtype), "wcoo",
              64, (1, 0)),
             (fem_banded_like(n=5000, dtype=np_dtype), "bsr", 256, (0, 1)),
             (fem_shell_like(nx=40, ny=20, n_target=4800, dtype=np_dtype), "dia", 64,
              (0, 0)),
             (webbase_like(n=5000, dtype=np_dtype), "ell", 16, (0, 0)),
             (webbase_like(n=5000, dtype=np_dtype), "coo", 16, (0, 0))]
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for A, kind, k, (k3, k4) in cases:
        plan = make_plan(A, dtype=dtype, force=kind, device="cpu")
        B = torch.from_numpy(DenseMatrix.random(A.width, k,
                                                dtype=np_dtype).values)
        C = torch.ones((A.height, k), dtype=dtype)
        want = spmm(plan, B, 3.0, 4.0, C)
        tw.window_reduce.launches = tb.bell_spmm.launches = 0
        got = spmm(plan.to(dev), B.to(dev), 3.0, 4.0, C.to(dev)).cpu()
        assert (tw.window_reduce.launches, tb.bell_spmm.launches) == (k3, k4)
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol * scale, kind


# ---- K5 (dia_spmm) ----

def _dia_operands(plan, k, dev, seed=0):
    """B (n, k) and C (m, k) in [-1, 1) in the plan's dtype on `dev`."""
    m, n = plan.shape
    g = torch.Generator(device=dev).manual_seed(seed + k)
    B, C = (torch.rand(shape, generator=g, device=dev, dtype=torch.float64)
            .mul(2).sub(1).to(plan.dtype) for shape in ((n, k), (m, k)))
    return B, C


def _dia_checked(plan, B, C, alpha, beta):
    """K5 twice through `spmm_dia` and the plain loop on the same card
    tensors: one launch a call, the two calls bitwise equal, and K5
    normwise within 1e-5 (f32) / 1e-12 (f64) of the loop, which forms the
    same products in the same order but rounds each product before its
    add where K5 fuses the two.  Returns (K5's result, the loop's)."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import dia as tdia
    name = f"sblas_dia_spmm_{_kernels.SUFFIX[plan.dtype]}"
    _kernels.LAUNCHED.clear()
    got = tdia.spmm_dia(plan, B, alpha, beta, C)
    assert dict(_kernels.LAUNCHED) == {name: 1}
    again = tdia.spmm_dia(plan, B, alpha, beta, C)
    assert dict(_kernels.LAUNCHED) == {name: 2}
    want = tdia.spmm_dia_plain(plan, B, alpha, beta, C)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, again, rtol=0, atol=0, equal_nan=True)
    tol = 1e-12 if plan.dtype == torch.float64 else 1e-5
    fin = want.isfinite()
    scale = max(1.0, float(want[fin].abs().max()))
    assert float((got[fin] - want[fin]).abs().max()) <= tol * scale
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    return got, want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["shell", "gaps", "wide", "shard", "halo"])
@pytest.mark.parametrize("k,alpha,beta", [
    (1, 3.0, 4.0), (63, 3.0, 4.0), (64, 3.0, 4.0), (64, -2.5, 0.0),
    (100, 3.0, 4.0)])
def test_dia_spmm_kernel_matches_plain(dev, dtype, name, k, alpha, beta):
    """K5 against the plain loop on the plans it serves
    (tests/test_torch_dia.py::_plan_case): a small FEM shell, runs with
    gaps between, a run wider than the cap, a rectangular mode 2 shard
    and a halo shard's extended window; K past one column slice with a
    masked edge; beta = 0 and alpha != 1."""
    from test_torch_dia import _plan_case
    plan = _plan_case(name, dtype).to(dev)
    B, C = _dia_operands(plan, k, dev)
    _dia_checked(plan, B, C, alpha, beta)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b_cols,c_cols", [
    pytest.param((32, 96), (0, 64), id="aligned-views"),
    pytest.param((1, 65), (3, 67), id="unaligned-views")])
def test_dia_spmm_kernel_takes_views_and_non_finite(dev, dtype, b_cols,
                                                    c_cols):
    """Column blocks of wider B and C (mode 1's operands), on and off 16
    bytes, are read in place through their row strides; an Inf in B and a
    NaN in C at beta = 0 reach the same outputs as in the loop."""
    from test_torch_dia import _plan_case
    plan = _plan_case("shell", dtype).to(dev)
    Bw, Cw = _dia_operands(plan, 100, dev, seed=1)
    B, C = Bw[:, slice(*b_cols)], Cw[:, slice(*c_cols)]
    _dia_checked(plan, B, C, 3.0, 4.0)
    B[plan.shape[1] // 2, 5] = float("inf")
    C[7, 9] = float("nan")
    got, _ = _dia_checked(plan, B, C, 3.0, 0.0)
    assert bool(got[7, 9].isnan()) and not bool(got.isfinite().all())


def test_spmm_dia_is_k5_alone(dev):
    """The DIA SpMM on the card is one K5 launch: nothing but the result's
    allocation is dispatched beside it (no pad of B, no accumulator fill,
    no epilogue ops), and no copy to the device once the run table is
    made."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.io.generate import fem_shell_like
    from sblas_tpu_torch.ops import spmm
    S = fem_shell_like(nx=40, ny=20, n_target=4800, dtype=np.float32)
    plan = make_plan(S, dtype=torch.float32, force="dia", device=dev)
    B, C = _dia_operands(plan, 64, dev)
    spmm(plan, B, 1.0, 1.0, C)
    _kernels.LAUNCHED.clear()
    got, ops = _aten_ops(lambda: spmm(plan, B, 1.0, 1.0, C))
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHED) == {"sblas_dia_spmm_f32": 1}
    assert set(ops) <= {"empty"}, ops
    want = spmm(plan.to("cpu"), B.cpu(), 1.0, 1.0, C.cpu())
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale


# ---- K6 (dia_spmv) ----

def _dia_vectors(plan, dev, seed=0):
    """x (n,) and y (m,) in [-1, 1) in the plan's dtype on `dev`."""
    m, n = plan.shape
    g = torch.Generator(device=dev).manual_seed(seed + m)
    x, y = (torch.rand(k, generator=g, device=dev, dtype=torch.float64)
            .mul(2).sub(1).to(plan.dtype) for k in (n, m))
    return x, y


def _spmv_checked(plan, x, y, alpha, beta):
    """K6 twice through `spmv_dia` and the plain loop on the same card
    tensors: one launch a call, the two calls bitwise equal, and K6
    normwise within 1e-5 (f32) / 1e-12 (f64) of the loop (the same
    products in the same order; K6 fuses each multiply-add), with NaN and
    Inf in the same places.  Returns (K6's result, the loop's)."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import dia as tdia
    name = f"sblas_dia_spmv_{_kernels.SUFFIX[plan.dtype]}"
    _kernels.LAUNCHED.clear()
    got = tdia.spmv_dia(plan, x, alpha, beta, y)
    assert dict(_kernels.LAUNCHED) == {name: 1}
    again = tdia.spmv_dia(plan, x, alpha, beta, y)
    assert dict(_kernels.LAUNCHED) == {name: 2}
    want = tdia.spmv_dia_plain(plan, x, alpha, beta, y)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, again, rtol=0, atol=0, equal_nan=True)
    tol = 1e-12 if plan.dtype == torch.float64 else 1e-5
    fin = want.isfinite()
    scale = max(1.0, float(want[fin].abs().max()))
    assert float((got[fin] - want[fin]).abs().max()) <= tol * scale
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    return got, want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["shell", "gaps", "wide", "shard", "halo",
                                  "edges", "many", "huge"])
@pytest.mark.parametrize("alpha,beta", [(3.0, 4.0), (-2.5, 0.0),
                                        (1.0, 1.0)])
def test_dia_spmv_kernel_matches_plain(dev, dtype, name, alpha, beta):
    """K6 against the plain loop on the plans it serves
    (tests/test_torch_dia.py::_plan_case): a small FEM shell, an even
    count of diagonals (`gaps`: one value a copy, rows padded), a
    rectangular mode 2 shard and a halo shard's extended window (m !=
    n), offsets past both edges with values stored there, 1001 diagonals
    (fewer rows a tile) and 12001 (values read in place); beta = 0 and
    beta != 0."""
    from test_torch_dia import _plan_case
    plan = _plan_case(name, dtype).to(dev)
    x, y = _dia_vectors(plan, dev)
    _spmv_checked(plan, x, y, alpha, beta)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_spmv_kernel_at_the_shell(dev, dtype):
    """The full shell's SpMV plan (90,449 rows, 91 diagonals: 16-byte
    copies) and its values at an offset of one element (one value a
    copy)."""
    from sblas_tpu_torch.io.generate import fem_shell_like
    S = fem_shell_like(dtype=np.float64)
    plan = make_plan(S, dtype=dtype, force="dia", device=dev)
    assert len(plan.offsets) == 91
    x, y = _dia_vectors(plan, dev)
    got, _ = _spmv_checked(plan, x, y, 3.0, 4.0)
    buf = torch.empty(plan.vals.numel() + 1, dtype=dtype, device=dev)
    buf[1:] = plan.vals.reshape(-1)
    moved = dataclasses.replace(plan, vals=buf[1:].view(plan.vals.shape))
    again, _ = _spmv_checked(moved, x, y, 3.0, 4.0)
    assert torch.equal(got, again)


def test_dia_spmv_kernel_non_finite(dev):
    """An Inf in x and a NaN in y at beta = 0 reach the outputs they
    reach in the loop."""
    from test_torch_dia import _plan_case
    plan = _plan_case("shell", torch.float32).to(dev)
    x, y = _dia_vectors(plan, dev, seed=1)
    x[plan.shape[1] // 2] = float("inf")
    y[7] = float("nan")
    got, _ = _spmv_checked(plan, x, y, 3.0, 0.0)
    assert bool(got[7].isnan()) and not bool(got.isfinite().all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_spmv_dia_is_k6_alone(dev, dtype):
    """The DIA SpMV on the card is one K6 launch: nothing but the
    result's allocation is dispatched beside it (no pad of x, no
    accumulator fill, no epilogue ops); a y of another dtype adds the
    epilogue in the result's dtype and keeps it unrounded."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.io.generate import fem_shell_like
    from sblas_tpu_torch.ops import spmv
    S = fem_shell_like(nx=40, ny=20, n_target=4800, dtype=np.float64)
    plan = make_plan(S, dtype=dtype, force="dia", device=dev)
    x, y = _dia_vectors(plan, dev)
    spmv(plan, x, 1.0, 1.0, y)
    _kernels.LAUNCHED.clear()
    got, ops = _aten_ops(lambda: spmv(plan, x, 1.0, 1.0, y))
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHED) == {
        f"sblas_dia_spmv_{_kernels.SUFFIX[dtype]}": 1}
    assert set(ops) <= {"empty"}, ops
    cpu = plan.to("cpu")
    want = spmv(cpu, x.cpu(), 1.0, 1.0, y.cpu())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= tol * scale
    other = torch.float32 if dtype == torch.float64 else torch.float64
    y2 = y.to(other) * 1000
    got = spmv(plan, x, 3.0, 4.0, y2)
    want = spmv(cpu, x.cpu(), 3.0, 4.0, y2.cpu())
    assert got.dtype == want.dtype == torch.float64
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_spmv_kernel_replays_in_a_graph(dev, dtype):
    """K6 captured in a CUDA graph and replayed on new x and y equals its
    eager launch on them, bitwise."""
    from test_torch_dia import _plan_case
    from sblas_tpu_torch.ops import spmv
    plan = _plan_case("shell", dtype).to(dev)
    x, y = _dia_vectors(plan, dev)
    spmv(plan, x, 3.0, 4.0, y)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = spmv(plan, x, 3.0, 4.0, y)
    x2, y2 = _dia_vectors(plan, dev, seed=5)
    x.copy_(x2)
    y.copy_(y2)
    graph.replay()
    want = spmv(plan, x2, 3.0, 4.0, y2)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_cg_on_the_shell_through_k6_meets_the_reference(dev, strict_capture):
    """Jacobi-CG in f32 on a small SPD shell (the `s3dkq4m2.cg` values,
    tests/reference_pcg.py) through its graph: K6 once per matvec (the
    eager initial residual, the capture's warm-up step, the 16 captured
    iterations), no loop; the solution within the cell's limits of the
    float64 reference: relative residual and error under 5e-4."""
    import reference_pcg as ref
    from test_torch_cg_shell import _rhs, _shell
    from sblas_tpu_torch.ops import DiaPlan
    from sblas_tpu_torch.ops import dia as tdia
    from sblas_tpu_torch.utils import trace
    solvers = strict_capture
    A = _shell(7)
    b = _rhs(A.shape[0], 7)
    plan = make_plan(A, torch.float32, op="spmv", device=dev)
    assert isinstance(plan, DiaPlan)
    M = solvers.jacobi_inv_diag(A, torch.float32, device=dev)
    tdia.dia_spmv.launches = 0
    with trace.recording() as rec:
        res = solvers.cg(plan, b.to(dev, torch.float32), tol=1e-6,
                         maxiter=2000, M=M, chunk=16, graph=True)
    assert res.converged and res.iterations > 16
    assert tdia.dia_spmv.launches == 2 + 16
    assert rec.counters["dia_spmv_kernel_calls"] == 2 + 16
    assert "dia_spmv_loop_calls" not in rec.counters
    K = ref.csr_tensor(A.row_ptr, A.col_idx, A.values)
    star, _, _ = ref.pcg(K, b, ref.inv_diag(A.row_ptr, A.col_idx, A.values),
                         1e-12, 4000)
    x = res.x.cpu().to(torch.float64)
    assert float((b - K @ x).norm() / b.norm()) <= 5e-4
    assert float((x - star).norm() / star.norm()) <= 5e-4


# ---- P1 (stage_fuse_gather), P2 (window_lane_gather) and xfoot ----

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_tiles,n_slabs,dups", [
    pytest.param(1, 1, False, id="1-1"),
    pytest.param(5, 3, False, id="5-3"),
    pytest.param(14, 12, False, id="14-12"),     # the n=16 xfoot shard
    pytest.param(188, 62, False, id="188-62"),   # the full webbase-1M plan
    pytest.param(6, 4, True, id="dups-6-4")])
def test_stage_fuse_gather_kernel_matches_plain(dev, dtype, n_tiles,
                                                n_slabs, dups):
    from sblas_tpu_torch.experiments import stage_fuse_probe as sf
    g = torch.Generator(device=dev).manual_seed(n_tiles)
    shape, slots = (n_tiles, 128, 128), n_tiles * 128 * 128
    x_slabs = torch.randn((n_slabs, 128, 128), generator=g, device=dev,
                          dtype=dtype)
    gslab = torch.randint(0, n_slabs, (n_tiles,), generator=g, device=dev,
                          dtype=torch.int32)
    gidx, i1 = (torch.randint(0, 128, shape, generator=g, device=dev,
                              dtype=torch.int32) for _ in range(2))
    if dups:
        # slabs repeated and out of order; each row's i1 names 3 lanes
        gslab = torch.tensor([3, 1, 3, 0, 2, 1], device=dev,
                             dtype=torch.int32)
        i1 = torch.tensor([0, 127, 64], device=dev, dtype=torch.int32)[
            torch.randint(0, 3, shape, generator=g, device=dev)]
    # one spare value, for a view that starts off 16 bytes
    gvals_flat = torch.randn(slots + 1, generator=g, device=dev, dtype=dtype)
    gvals = gvals_flat[:slots].view(shape)
    before = sf.stage_fuse_gather.launches
    got = sf.stage_fuse_gather(gslab, x_slabs, gidx, gvals, i1)
    torch.cuda.synchronize()
    assert sf.stage_fuse_gather.launches == before + 1
    want = sf.stage_fuse_gather_plain(gslab, x_slabs, gidx, gvals, i1)
    assert torch.equal(got, want)
    # x_slabs is read one value at a time: a view one value in launches
    x_off = torch.cat([x_slabs.view(-1)[:1], x_slabs.view(-1)])[1:]
    assert torch.equal(sf.stage_fuse_gather(
        gslab, x_off.view(x_slabs.shape), gidx, gvals, i1), want)
    with pytest.raises(KernelError):
        sf.stage_fuse_gather(gslab, x_slabs, gidx, gvals, i1.long())
    with pytest.raises(ShapeError):
        sf.stage_fuse_gather(gslab, x_slabs, gidx, gvals, i1[:, :64])
    # gvals and i1 are read as 16-byte vectors: a view one value in raises
    with pytest.raises(KernelError, match="16 bytes"):
        sf.stage_fuse_gather(gslab, x_slabs, gidx,
                             gvals_flat[1:1 + slots].view(shape), i1)
    with pytest.raises(KernelError, match="16 bytes"):
        sf.stage_fuse_gather(gslab, x_slabs, gidx, gvals,
                             torch.cat([i1[0, 0, :1], i1.view(-1)])[1:]
                             .view(shape))
    assert sf.stage_fuse_gather.launches == before + 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb,T,k", [(1, 1, 64), (7, 20, 64), (5, 9, 45)])
def test_window_lane_gather_kernel_matches_plain(dev, dtype, nb, T, k):
    from sblas_tpu_torch.experiments import wcoo_gather_probe as wg
    g = torch.Generator(device=dev).manual_seed(T)
    B = torch.randn((nb * 128, k), generator=g, device=dev, dtype=dtype)
    wblk = torch.randint(0, nb, (T,), generator=g, device=dev,
                         dtype=torch.int32)
    idx = torch.randint(0, 128, (T, 1, 128), generator=g, device=dev,
                        dtype=torch.int32)
    before = wg.window_lane_gather.launches
    got = wg.window_lane_gather(B, wblk, idx)
    torch.cuda.synchronize()
    assert wg.window_lane_gather.launches == before + 1
    assert torch.equal(got, wg.window_lane_gather_plain(B, wblk, idx))
    with pytest.raises(KernelError):
        wg.window_lane_gather(B[:100], wblk, idx)
    with pytest.raises(ShapeError):
        wg.window_lane_gather(B, wblk, idx[:, :, :64])


@pytest.mark.parametrize("dtype,np_dtype", [(torch.float64, np.float64),
                                            (torch.float32, np.float32)])
def test_spmv_routed_fused1_on_card(dev, dtype, np_dtype):
    """The fused SpMV on the card: P1 once, its pass-1 tiles bitwise equal
    to K2 then K1's first layer, and the result equal to the CPU's."""
    from sblas_tpu_torch.experiments import stage_fuse_probe as sf
    from sblas_tpu_torch.parallel.xfoot import xfoot_worst_local
    A = webbase_like(n=100_000, avg_deg=4.0, dtype=np_dtype)
    local, (tg, srs, prs, sks) = xfoot_worst_local(A, 4)
    cpu = tr.RoutedPlan.from_csr(local, dtype=dtype, min_gtiles=tg,
                                 min_srows=srs, min_prows=prs,
                                 min_sranks=sks, device="cpu")
    plan = cpu.to(dev)
    x = torch.from_numpy(DenseVector.random(local.shape[1],
                                            dtype=np_dtype).values)
    y = torch.zeros(local.shape[0], dtype=dtype)
    sf.stage_fuse_gather.launches = 0
    got = sf.spmv_routed_fused1(plan, x.to(dev), 1.0, 0.0, y.to(dev))
    torch.cuda.synchronize()
    assert sf.stage_fuse_gather.launches == 1
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got.cpu(), sf.spmv_routed_fused1(
        cpu, x, 1.0, 0.0, y), rtol=tol, atol=tol)
    xd = x.to(dev)
    assert torch.equal(sf.stage_fuse_gather(*sf.pass1_operands(plan, xd)),
                       sf.pass1_tiles_stock(plan, xd))


@pytest.mark.parametrize("engine", ["flat", "route"])
def test_xfoot_ranks_on_card(dev, engine):
    """Each of four xfoot ranks' compute (no process group) on the card
    equals the CPU's, through both extraction engines."""
    from sblas_tpu_torch.io.plancache import place
    from sblas_tpu_torch.parallel import (partition_xfoot,
                                          spmv_xfoot_nocomm)
    from sblas_tpu_torch.parallel.mesh import Mesh
    A = webbase_like(n=100_000, avg_deg=4.0, dtype=np.float64)
    cpu = partition_xfoot(A, 4, dtype=torch.float64, kind="coo",
                          extract=engine, device="cpu")
    on_card = place(cpu, dev)
    x = torch.from_numpy(DenseVector.random(A.width).values)
    for s in range(4):
        got = spmv_xfoot_nocomm(on_card, x.to(dev), Mesh(None, s, 4, dev))
        want = spmv_xfoot_nocomm(cpu, x, Mesh(None, s, 4, "cpu"))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-12, atol=1e-12)


# ---- the K4 gate on the block shape ----

def test_bell_spmm_gate_on_block_shape(dev):
    """A BELL plan of (8, 128) blocks at K = 256 takes the batched
    matmuls, not K4 (which takes 128 x 128 blocks only)."""
    from sblas_tpu_torch.containers import DenseMatrix
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops import BsrPlan, spmm
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops.cpu_reference import spmm_cpu
    from sblas_tpu_torch.utils.verify import check_equal
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    A = fem_banded_like(n=2000, half_band=5, dtype=np.float32)
    plan = BsrPlan.from_csr(A, dtype=torch.float32, block=(8, 128),
                            device=dev)
    B = DenseMatrix.random(2000, 256, dtype=np.float32)
    C = DenseMatrix.constant(2000, 256, 1.0, dtype=np.float32)
    tb.bell_spmm.launches = 0
    out = spmm(plan, torch.from_numpy(B.values).to(dev), 3.0, 4.0,
               torch.from_numpy(C.values).to(dev))
    torch.cuda.synchronize()
    assert tb.bell_spmm.launches == 0
    assert check_equal(out.cpu().numpy(), spmm_cpu(A, B, 3.0, 4.0, C),
                       relative=True).ok


# ---- solvers: a chunk of iterations captured as one CUDA graph ----

def _spd_system(dev, dtype, n=3000):
    from sblas_tpu_torch.examples.cg import build_spd
    A = build_spd(n, np.float64 if dtype == torch.float64 else np.float32)
    plan = make_plan(A, dtype=dtype, op="spmv", device=dev)
    x_true = torch.from_numpy(
        np.random.RandomState(7).standard_normal(A.shape[0])).to(dev, dtype)
    return A, plan, spmv(plan, x_true, 1.0, 0.0)


def _pagerank_system(dev):
    """webbase P^T (100k pages) on a routed plan: K1 and K2 per matvec."""
    from sblas_tpu_torch.examples.pagerank import transition
    G = webbase_like(n=100_000, avg_deg=4.0)
    PT, dangling = transition(G, np.float32)
    plan = make_plan(PT, dtype=torch.float32, force="routed", device=dev)
    return plan, torch.from_numpy(dangling).to(dev)


@pytest.fixture
def strict_capture(monkeypatch):
    """Every capture (and its warm-up step) under
    `set_sync_debug_mode("error")`: a host sync inside raises."""
    from sblas_tpu_torch import solvers
    solvers.clear_programs()
    capture = solvers._Program._capture

    def strict(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            capture(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(solvers._Program, "_capture", strict)
    yield solvers
    solvers.clear_programs()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("jacobi", [False, True])
def test_cg_graph_equals_eager_bitwise(dev, strict_capture, dtype, jacobi):
    solvers = strict_capture
    A, plan, b = _spd_system(dev, dtype)
    M = solvers.jacobi_inv_diag(A, dtype, device=dev) if jacobi else None
    tol = 1e-10 if dtype == torch.float64 else 1e-6
    g = solvers.cg(plan, b, tol=tol, maxiter=500, M=M, graph=True)
    e = solvers.cg(plan, b, tol=tol, maxiter=500, M=M, graph=False)
    assert solvers.captures() == 1
    assert g.converged and g.iterations == e.iterations
    assert g.residual == e.residual and torch.equal(g.x, e.x)


def test_bicgstab_graph_equals_eager_bitwise(dev, strict_capture):
    solvers = strict_capture
    _, plan, b = _spd_system(dev, torch.float64)
    g = solvers.bicgstab(plan, b, tol=1e-10, maxiter=500, graph=True)
    e = solvers.bicgstab(plan, b, tol=1e-10, maxiter=500, graph=False)
    assert g.converged and g.iterations == e.iterations
    assert torch.equal(g.x, e.x)


def test_pagerank_graph_through_k1_k2_equals_eager(dev, strict_capture):
    solvers = strict_capture
    plan, dang = _pagerank_system(dev)
    n = plan.shape[0]
    _reset_k1()
    tr.slab_gather.launches = 0
    g = solvers.pagerank(plan, n, dangling=dang, tol=1e-7, maxiter=200,
                         graph=True, chunk=16)
    # the warm-up step and the 16 captured iterations call the wrappers;
    # the replays run on the card alone
    assert tr.slab_gather.launches == 17
    assert _k1_launches() == 17 * plan.n_route_gathers
    e = solvers.pagerank(plan, n, dangling=dang, tol=1e-7, maxiter=200,
                         graph=False)
    assert g.converged and g.iterations == e.iterations > 16
    assert torch.equal(g.x, e.x)


def test_second_solve_replays_the_captured_graph(dev, strict_capture):
    solvers = strict_capture
    plan, dang = _pagerank_system(dev)
    n = plan.shape[0]
    first = solvers.pagerank(plan, n, dangling=dang, tol=1e-7, maxiter=200)
    assert solvers.captures() == 1
    _reset_k1()
    tr.slab_gather.launches = 0
    again = solvers.pagerank(plan, n, dangling=dang, tol=1e-7, maxiter=200)
    assert solvers.captures() == 1
    assert _k1_launches() == tr.slab_gather.launches == 0
    assert again.iterations == first.iterations
    assert torch.equal(again.x, first.x)
    _, splan, b = _spd_system(dev, torch.float64)
    r1 = solvers.cg(splan, b, tol=1e-10, maxiter=500)
    r2 = solvers.cg(splan, 2.0 * b, tol=1e-10, maxiter=500)
    assert solvers.captures() == 2 and r1.iterations == r2.iterations
    torch.testing.assert_close(r2.x, 2.0 * r1.x, rtol=1e-12, atol=1e-12)


def test_graph_cache_follows_its_plans(dev, strict_capture):
    """Solving over fresh plans keeps one capture per live plan and none
    once the plans are gone; a raw CsrMatrix's capture is not kept."""
    import gc
    solvers = strict_capture
    A, plan, b = _spd_system(dev, torch.float64)
    ref = solvers.cg(plan, b, tol=1e-10, maxiter=500, graph=True)
    for _ in range(3):
        plan = make_plan(A, dtype=torch.float64, op="spmv", device=dev)
        r = solvers.cg(plan, b, tol=1e-10, maxiter=500, graph=True)
        gc.collect()
        assert len(solvers._PROGRAMS) == solvers.captures() == 1
        assert torch.equal(r.x, ref.x)
    del plan
    gc.collect()
    assert not solvers._PROGRAMS
    r = solvers.cg(A, b, tol=1e-10, maxiter=500, graph=True)
    assert not solvers._PROGRAMS and r.iterations == ref.iterations


def test_graph_true_with_shards_raises(dev):
    from sblas_tpu_torch import solvers
    from sblas_tpu_torch.parallel import partition_row_plans
    from sblas_tpu_torch.parallel.mesh import Mesh
    from sblas_tpu_torch.utils.errors import PartitionError
    A = webbase_like(n=20_000, avg_deg=4.0)
    sh = partition_row_plans(A, 1, dtype=torch.float64, device=dev)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    with pytest.raises(PartitionError, match="graph=True"):
        solvers.cg(sh, b, mesh=Mesh(None, 0, 1, dev), graph=True)


# ---- host-streamed execution (the UM analog) ----

def _um_case(dev, kind):
    """A matrix whose host-resident f32 plan for `dev` has `kind` bands,
    more of them than the in-flight window."""
    from sblas_tpu_torch.io.generate import fem_shell_like
    from sblas_tpu_torch.memory import host_resident_plan
    from sblas_tpu_torch.memory.host import _INFLIGHT
    if kind == "wcoo":
        A, budget = webbase_like(n=200_000, dtype=np.float32), 2 << 20
    else:
        A = fem_shell_like(nx=51, ny=25, dof=6, n_target=51 * 25 * 6 - 1,
                           dtype=np.float32)
        budget = 1 << 20
    hp = host_resident_plan(A, dtype=torch.float32,
                            hbm_budget_bytes=budget, device=dev)
    assert hp.kind == kind and hp.n_bands > _INFLIGHT
    return A, hp


def _slowed(monkeypatch, hp, dev, delay: str, cycles: int = 2_000_000):
    """Hold the stream of every band `delay` ("copy" or "compute") busy
    for about a millisecond first, so a missing event wait or an early
    slot refill shows as a wrong result."""
    import contextlib
    from sblas_tpu_torch.utils import trace
    real = trace.span
    side = hp.copy_stream() if hp is not None else None

    @contextlib.contextmanager
    def slow(name, **attrs):
        if name == "sblas.um." + delay:
            stream = (side if delay == "copy"
                      else torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                torch.cuda._sleep(cycles)
        with real(name, **attrs):
            yield

    monkeypatch.setattr(trace, "span", slow)


@pytest.mark.parametrize("kind", ["wcoo", "ell"])
@pytest.mark.parametrize("delay", ["copy", "compute"])
def test_streamed_spmm_equals_tuned_under_delays(dev, kind, delay,
                                                 monkeypatch):
    """Untuned (streamed) spmm_um is bitwise the tuned loop for K3 and ELL
    bands, with the copy or the compute stream delayed before each band;
    so is spmv_um over ELL bands (WCOO SpMV adds with index_add_)."""
    from sblas_tpu_torch.memory import host as thost
    A, hp = _um_case(dev, kind)
    g = torch.Generator(device=dev).manual_seed(7)
    B = torch.rand((A.shape[1], 64), generator=g, device=dev)
    C = torch.rand((A.shape[0], 64), generator=g, device=dev)
    x, y = B[:, 0].contiguous(), C[:, 0].contiguous()
    want = thost.spmm_um(hp, B, 3.0, 4.0, C, tuning=True)
    want_v = thost.spmv_um(hp, x, 3.0, 4.0, y, tuning=True)
    hp.remove_gpu_tuning()
    _slowed(monkeypatch, hp, dev, delay)
    got = thost.spmm_um(hp, B, 3.0, 4.0, C)
    got_v = thost.spmv_um(hp, x, 3.0, 4.0, y)
    torch.cuda.synchronize()
    assert hp.last_stream.peak_resident == thost._INFLIGHT
    assert torch.equal(got, want)
    if kind == "ell":
        assert torch.equal(got_v, want_v)
    else:
        torch.testing.assert_close(got_v, want_v, rtol=1e-5, atol=1e-5)


def test_um_operands_are_pinned(dev, tmp_path):
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.io.plancache import load_plan, save_plan
    from sblas_tpu_torch.memory import (HostDense, host_resident_grid,
                                        host_resident_plan,
                                        host_resident_shards)
    from sblas_tpu_torch.memory.host import tensor_fields
    A = fem_banded_like(n=3000, half_band=10)
    kw = dict(dtype=torch.float64, hbm_budget_bytes=64 << 10, device=dev)
    hp = host_resident_plan(A, **kw)
    save_plan(str(tmp_path / "um.npz"), hp)
    plans = [*hp.bands, *load_plan(str(tmp_path / "um.npz"), dev).bands,
             *host_resident_shards(A, 2, rank=1, **kw).local(1).bands,
             *host_resident_grid(A, k=8, **kw).cells.values()]
    assert all(getattr(p, f).is_pinned() for p in plans
               for f in tensor_fields(p))
    assert HostDense.from_array(np.ones((5, 3)), device=dev).values \
        .is_pinned()


def test_hostdense_result_is_ready_on_return(dev, monkeypatch):
    """spmm_um_hostdense's result is read straight after the call, with
    every band's compute delayed: the call waits for its last copy."""
    from sblas_tpu_torch.containers import DenseMatrix
    from sblas_tpu_torch.io.generate import fem_shell_like
    from sblas_tpu_torch.memory import (HostDense, host_resident_grid,
                                        spmm_um_hostdense)
    from sblas_tpu_torch.ops.cpu_reference import spmm_cpu
    from sblas_tpu_torch.utils.verify import check_equal
    A = fem_shell_like(nx=51, ny=25, dof=6, n_target=51 * 25 * 6 - 1,
                       dtype=np.float64)
    grid = host_resident_grid(A, dtype=torch.float64,
                              hbm_budget_bytes=1 << 20, k=16, device=dev)
    assert grid.n_bands > 3
    B = DenseMatrix.random(A.width, 16)
    C = DenseMatrix.constant(A.height, 16, 1.0)
    _slowed(monkeypatch, None, dev, "compute")
    got = spmm_um_hostdense(grid, HostDense.from_array(B.values, device=dev),
                            3.0, 4.0,
                            HostDense.from_array(C.values, device=dev))
    assert got.values.is_pinned()
    assert check_equal(got.to_numpy(), spmm_cpu(A, B, 3.0, 4.0, C)).ok


def test_spmm_um_wcoo_counts_k3_per_band_and_chunk(dev):
    """A streamed spmm_um over WCOO bands calls K3 once per band per
    K-chunk (K = 600: two chunks of at most 512)."""
    from sblas_tpu_torch.memory import host as thost
    from sblas_tpu_torch.ops import wcoo as tw
    A, hp = _um_case(dev, "wcoo")
    k = 600
    kc = tw.k_chunk_width(hp.bands[0].n_tiles, k)
    B = torch.rand((A.shape[1], k), device=dev)
    C = torch.zeros((A.shape[0], k), device=dev)
    tw.window_reduce.launches = 0
    got = thost.spmm_um(hp, B, 1.0, 0.0, C)
    torch.cuda.synchronize()
    assert tw.window_reduce.launches == hp.n_bands * -(-k // kc) \
        == hp.n_bands * 2
    assert torch.equal(got, thost.spmm_um(hp, B, 1.0, 0.0, C, tuning=True))


# ---- the 16-bit variants: K1 on bf16 lanes, K2/K2' storing bf16, K3 and
# K4 in bf16, and the paths that take them ----

def _ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-element distance in bf16 ulps (ordered bit patterns)."""
    def key(t):
        b = t.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)
    return (key(got) - key(want)).abs()


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("rows", [1, 37, 2048, 32768])
def test_lane_shuffle_bf16_kernel_matches_plain(dev, idx_dtype, rows):
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn((rows, 128), generator=g, device=dev).to(BF16)
    idx = torch.randint(0, 128, (rows, 128), generator=g, device=dev,
                        dtype=torch.int32).to(idx_dtype)
    from sblas_tpu_torch import _kernels
    before = troute.lane_shuffle.launches
    _kernels.LAUNCHED.clear()
    got = troute.lane_shuffle(x, idx)
    torch.cuda.synchronize()
    assert troute.lane_shuffle.launches == before + 1
    assert _launched_of("lane_shuffle") == {
        "bf16_i16" if idx_dtype == torch.int16 else "bf16": 1}
    assert torch.equal(got, troute.lane_shuffle_plain(x, idx))


def test_lane_shuffle_refuses_int16_with_wide_values(dev):
    x = torch.zeros((4, 128), device=dev)
    idx = torch.zeros((4, 128), device=dev, dtype=torch.int16)
    with pytest.raises(KernelError):
        troute.lane_shuffle(x, idx)


@pytest.mark.parametrize("variant", ["f32_bf16", "bf16"])
@pytest.mark.parametrize("n_tiles,n_slabs", [(1, 1), (5, 3), (14, 12),
                                             (188, 62)])
def test_gather_bf16_kernels_match_plain(dev, variant, n_tiles, n_slabs):
    """K2 and K2' storing bf16 (from f32 or bf16 operands): bitwise
    their plain versions."""
    dt = torch.float32 if variant == "f32_bf16" else BF16
    g = torch.Generator(device=dev).manual_seed(n_tiles)
    shape = (n_tiles, 128, 128)
    x_slabs = torch.randn((n_slabs, 128, 128), generator=g,
                          device=dev).to(dt)
    gslab = torch.randint(0, n_slabs, (n_tiles,), generator=g, device=dev,
                          dtype=torch.int32)
    gidx = torch.randint(0, 128, shape, generator=g, device=dev,
                         dtype=torch.int32)
    gvals = torch.randn(shape, generator=g, device=dev).to(dt)
    from sblas_tpu_torch import _kernels
    before = (tr.slab_gather.launches, tr.tile_gather.launches)
    _kernels.LAUNCHED.clear()
    got = tr.slab_gather(gslab, x_slabs, gidx, gvals, BF16)
    tiles = torch.index_select(x_slabs, 0, gslab)
    got_t = tr.tile_gather(tiles, gidx, gvals, BF16)
    torch.cuda.synchronize()
    assert (tr.slab_gather.launches, tr.tile_gather.launches) == (
        before[0] + 1, before[1] + 1)
    assert _launched_of("slab_gather") == {variant: 1}
    assert got.dtype == got_t.dtype == BF16
    assert torch.equal(got, tr.slab_gather_plain(gslab, x_slabs, gidx,
                                                 gvals, BF16))
    assert torch.equal(got_t, tr.tile_gather_plain(tiles, gidx, gvals,
                                                   BF16))
    with pytest.raises(KernelError):      # no f64 -> bf16 variant
        tr.slab_gather(gslab, x_slabs.double(), gidx, gvals.double(), BF16)


@pytest.mark.parametrize("case,k0,width", [
    ("web20k", 0, 64), ("web3k", 13, 31), ("web20k", 13, 65),
    ("long_row", 0, 64), ("min_tiles", 2, 78)])
def test_window_reduce_bf16_kernel_within_one_ulp(dev, case, k0, width):
    """K3 in bf16 sums in f32 and rounds once, as its plain version does:
    the two agree within one bf16 ulp (positive operands: no
    cancellation), and two launches bitwise."""
    from sblas_tpu_torch.ops import wcoo as tw
    plan, k = _k3_case(dev, BF16, case)
    assert plan.vals.dtype == BF16
    g = torch.Generator(device=dev).manual_seed(k0 + width)
    B = torch.rand((plan.shape[1], k), generator=g, device=dev).to(BF16)
    args = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk,
            plan.lane, B, k0, width)
    got, again = tw.window_reduce(*args), tw.window_reduce(*args)
    torch.cuda.synchronize()
    assert got.dtype == BF16 and torch.equal(got, again)
    assert int(_ulps(got, tw.window_reduce_plain(*args)).max()) <= 1


# ---- K3's fused store path (beta*C + alpha*sum on rows below m) and its
# two bf16 variants ----

_K3_CASES = [("web20k", 0, 64), ("web3k", 13, 31), ("web3k", 8, 32),
             ("web200k", 0, 64), ("web20k", 13, 1), ("web20k", 8, 8),
             ("web20k", 13, 65), ("web20k", 16, 64), ("long_row", 0, 64),
             ("long_row", 13, 65), ("min_tiles", 13, 64),
             ("min_tiles", 2, 78), ("min_tiles", 0, 80)]


def _k3_fused(plan, k, k0, width, dtype, seed, alpha=3.0, beta=4.0):
    """K3 in the fused form twice, on one chunk of random B, C of `k`
    columns, into `out` views of buffers that hold 7 guard rows after
    row m and a sentinel everywhere: the two buffers, the plain version's
    result on a third, and the launches by variant."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import wcoo as tw
    dev = plan.vals.device
    m, n = plan.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    B = torch.rand((n, k), generator=g, device=dev).to(dtype)
    C = torch.rand((m, k), generator=g, device=dev).to(dtype)
    bufs = [torch.full((m + 7, k), -7.0, device=dev, dtype=dtype)
            for _ in range(3)]
    args = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk, plan.lane,
            B, k0, width)
    _kernels.LAUNCHED.clear()
    before = tw.window_reduce.launches
    for buf in bufs[:2]:
        got = tw.window_reduce(*args, C=C, alpha=alpha, beta=beta,
                               out=buf[:m])
        assert got.data_ptr() == buf.data_ptr()
    torch.cuda.synchronize()
    assert tw.window_reduce.launches == before + 2
    launched = {k[len("sblas_window_reduce_"):]: v
                for k, v in _kernels.LAUNCHED.items()}
    tw.window_reduce_plain(*args, C=C, alpha=alpha, beta=beta,
                           out=bufs[2][:m])
    return bufs, launched


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,k0,width", _K3_CASES)
def test_window_reduce_fused_matches_plain(dev, dtype, case, k0, width):
    """f32 and f64: out[:, k0:k0+width] = beta*C + alpha*sum for the rows
    below m, at 1e-5 (f32) or 1e-12 (f64) of the plain version; the other
    columns and the guard rows after m are never written; two launches
    agree bitwise."""
    plan, k = _k3_case(dev, dtype, case)
    (got, again, want), launched = _k3_fused(plan, k, k0, width, dtype,
                                             seed=k0 + width)
    assert launched == {"f32" if dtype == torch.float32 else "f64": 2}
    assert torch.equal(got, again)
    outside = torch.ones_like(got, dtype=torch.bool)
    outside[:plan.shape[0], k0:k0 + width] = False
    assert bool((got[outside] == -7.0).all())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("form", ["grid", "fused"])
@pytest.mark.parametrize("case,k0,width", _K3_CASES)
def test_window_reduce_bf16_variants_within_one_ulp(dev, case, k0, width,
                                                    form):
    """bf16 takes `bf16` (16-byte loads on 8-lane groups) where B's
    stride, k0 and width are multiples of 8, else `bf16_ragged`; either
    stays within one bf16 ulp of the plain version in both store forms,
    and two launches agree bitwise."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import wcoo as tw
    plan, k = _k3_case(dev, BF16, case)
    variant = ("bf16" if k % 8 == 0 and k0 % 8 == 0 and width % 8 == 0
               else "bf16_ragged")
    if form == "fused":
        (got, again, want), launched = _k3_fused(plan, k, k0, width, BF16,
                                                 seed=k0 + width)
    else:
        g = torch.Generator(device=dev).manual_seed(k0 + width)
        B = torch.rand((plan.shape[1], k), generator=g, device=dev).to(BF16)
        args = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk,
                plan.lane, B, k0, width)
        _kernels.LAUNCHED.clear()
        got, again = tw.window_reduce(*args), tw.window_reduce(*args)
        torch.cuda.synchronize()
        launched = {k[len("sblas_window_reduce_"):]: v
                    for k, v in _kernels.LAUNCHED.items()}
        want = tw.window_reduce_plain(*args)
    assert launched == {variant: 2}
    assert got.dtype == BF16 and torch.equal(got, again)
    assert int(_ulps(got, want).max()) <= 1


def test_window_reduce_bf16_unaligned_operand_takes_ragged(dev):
    """A B, C or out starting 2 bytes past 16 takes `bf16_ragged`; the
    `bf16` launcher itself refuses such operands."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import wcoo as tw
    plan, k = _k3_case(dev, BF16, "web3k")
    m, n = plan.shape
    g = torch.Generator(device=dev).manual_seed(1)
    B = torch.rand(1 + n * 64, generator=g, device=dev).to(BF16)
    B = B[1:].view(n, 64)
    C = torch.rand((m, 64), generator=g, device=dev).to(BF16)
    args = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk, plan.lane,
            B, 0, 64)
    assert tw.bf16_variant(B, 0, 64, C) == "bf16_ragged"
    _kernels.LAUNCHED.clear()
    got = tw.window_reduce(*args, C=C, alpha=3.0, beta=4.0)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHED) == {"sblas_window_reduce_bf16_ragged": 1}
    want = tw.window_reduce_plain(*args, C=C, alpha=3.0, beta=4.0)
    assert int(_ulps(got, want).max()) <= 1
    out = torch.empty((m, 64), device=dev, dtype=BF16)
    carry = torch.empty((plan.k3_units.shape[0], 2, 64), device=dev)
    with pytest.raises(KernelError):
        _kernels.launch("sblas_window_reduce_bf16", dev, plan.k3_units,
                        plan.k3_rows, plan.wb, plan.relrow, plan.vals,
                        plan.xblk, plan.lane, B, C, out, carry,
                        plan.k3_units.shape[0], plan.k3_rows.shape[0], 64,
                        0, 64, 64, m, 3.0, 4.0)


def test_window_reduce_fused_refuses_bad_c_and_out(dev):
    from sblas_tpu_torch.ops import wcoo as tw
    _, plan = _wcoo_plan(dev, torch.float32, n=3000)
    m, n = plan.shape
    B = torch.rand((n, 8), device=dev)
    C = torch.rand((m, 8), device=dev)
    args = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk, plan.lane,
            B, 0, 8)
    for bad in (dict(C=C.double()), dict(C=C[:, :4]), dict(C=C.cpu()),
                dict(C=torch.rand((8, m), device=dev).t()),
                dict(C=torch.rand((plan.n_row_blocks * 128 + 1, 8),
                                  device=dev)),
                dict(C=C, out=torch.empty((m, 8), device=dev).double()),
                dict(C=C, out=torch.empty((m - 1, 8), device=dev)),
                dict(out=torch.empty((m, 8), device=dev))):
        with pytest.raises((KernelError, ShapeError)):
            tw.window_reduce(*args, **bad)


def _aten_ops(fn):
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


@pytest.mark.parametrize("dtype,k,k_chunk", [
    (torch.float32, 80, 32), (torch.float64, 64, None), (BF16, 64, None),
    (BF16, 80, 24), (BF16, 40, 13), (BF16, 63, None), (BF16, 100, 81)])
def test_spmm_wcoo_is_k3_alone(dev, dtype, k, k_chunk):
    """The WCOO SpMM on the card is K3's calls, one per K-chunk, all
    writing one result: no slice copy, concatenation or elementwise
    epilogue runs (only allocations and views are dispatched beside
    K3), and the result matches the CPU plan's at 1e-5 / 1e-12 / one
    bf16 ulp."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import wcoo as tw
    plan, _ = _k3_case(dev, dtype, "web20k")
    m, n = plan.shape
    g = torch.Generator(device=dev).manual_seed(k)
    B = torch.rand((n, k), generator=g, device=dev).to(dtype)
    C = torch.rand((m, k), generator=g, device=dev).to(dtype)
    kc = k_chunk or tw.k_chunk_width(plan.n_tiles, k)
    _kernels.LAUNCHED.clear()
    tw.window_reduce.launches = 0
    got, ops = _aten_ops(lambda: tw.spmm_wcoo(plan, B, 3.0, 4.0, C,
                                              k_chunk=k_chunk))
    torch.cuda.synchronize()
    assert tw.window_reduce.launches == -(-k // kc)
    assert sum(_kernels.LAUNCHED.values()) == -(-k // kc)
    assert all(name.startswith("sblas_window_reduce_")
               for name in _kernels.LAUNCHED)
    assert set(ops) <= {"empty", "empty_like", "empty_strided", "slice",
                        "alias", "view", "promote_types"}, ops
    assert got.dtype == dtype and got.shape == (m, k)
    want = tw.spmm_wcoo(plan.to("cpu"), B.cpu(), 3.0, 4.0, C.cpu(),
                        k_chunk=k_chunk)
    if dtype == BF16:
        assert int(_ulps(got.cpu(), want).max()) <= 1
    else:
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


def test_spmm_wcoo_keeps_the_promoted_dtype_on_card(dev):
    """C in another dtype than the plan's: K3 runs in the plan's, and the
    result has the dtype `beta*C + alpha*(A@B)` has."""
    from sblas_tpu_torch.ops import wcoo as tw
    plan, _ = _k3_case(dev, BF16, "web3k")
    m, n = plan.shape
    B = torch.rand((n, 16), device=dev)
    C = torch.rand((m, 16), device=dev)
    tw.window_reduce.launches = 0
    got = tw.spmm_wcoo(plan, B, 3.0, 4.0, C)
    assert tw.window_reduce.launches == 1
    assert got.dtype == torch.float32
    want = tw.spmm_wcoo(plan.to("cpu"), B.cpu(), 3.0, 4.0, C.cpu())
    assert want.dtype == torch.float32
    assert int(_ulps(got.cpu().to(BF16), want.to(BF16)).max()) <= 1


def _k4_bf16_call(plan, k, seed, alpha=3.0, beta=4.0, offset=0):
    """K4[bf16] twice on `plan` with random B, C of `k` columns (B
    starting `offset` elements into its storage): the two results, the
    plain version's and the launches by variant."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import bsr_pallas as tb
    dev = plan.vals.device
    n, m = plan.shape[1], plan.shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    B = torch.rand(offset + n * k, generator=g, device=dev).to(BF16)
    B = B[offset:].view(n, k)
    C = torch.rand((m, k), generator=g, device=dev).to(BF16)
    args = (plan.vals, plan.bcol, B, C, alpha, beta)
    _kernels.LAUNCHED.clear()
    got, again = tb.bell_spmm(*args), tb.bell_spmm(*args)
    torch.cuda.synchronize()
    launched = dict(_kernels.LAUNCHED)
    return got, again, tb.bell_spmm_plain(*args), launched


@pytest.mark.parametrize("n,half_band,k", [(700, 9, 17), (3000, 36, 256),
                                           (20_000, 36, 300),
                                           (3000, 36, 264),
                                           (20_000, 36, 512),
                                           (100, 9, 264),
                                           (700, 9, 8), (3000, 36, 32)])
def test_bell_spmm_bf16_kernel_within_one_ulp(dev, n, half_band, k):
    """K4[bf16] on the tensor cores sums exact products in f32 and rounds
    once, as its plain version does: within one bf16 ulp, two launches
    bitwise, and the variant K calls for (wgmma fed by TMA at K % 8 == 0).
    Block rows 1 to 157 and 1 to 4 column tiles: the persistent blocks'
    tile walk leaves no output tile unwritten.  At K = 8 and 32 the TMA
    boxes (64 columns) are wider than B, C and out: zero-filled on load,
    clipped on store."""
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops.bsr import BsrPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    A = fem_banded_like(n=n, half_band=half_band)
    plan = BsrPlan.from_csr(A, dtype=BF16, device=dev)
    got, again, want, launched = _k4_bf16_call(plan, k, n)
    assert got.dtype == BF16 and torch.equal(got, again)
    assert int(_ulps(got, want).max()) <= 1
    variant = "bf16" if k % 8 == 0 else "bf16_ragged"
    assert launched == {f"sblas_bell_spmm_{variant}": 2}


def _uneven_block_rows(m=700, n=900, seed=9):
    """A sparse matrix whose 128-row block rows hold 1 to 4 nonzero
    128 x 128 blocks, so its BELL plan pads the short rows with slots."""
    from sblas_tpu_torch.containers import CooMatrix
    rng = np.random.RandomState(seed)
    rows, cols = [], []
    for bi in range(-(-m // 128)):
        for bj in rng.choice(-(-n // 128), size=bi % 4 + 1, replace=False):
            r = rng.randint(bi * 128, min(m, bi * 128 + 128), size=300)
            c = rng.randint(bj * 128, min(n, bj * 128 + 128), size=300)
            rows.append(r)
            cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    key = np.unique(rows * n + cols)
    return CooMatrix(key // n, key % n,
                     rng.random_sample(len(key)).astype(np.float32),
                     (m, n)).to_csr()


@pytest.mark.parametrize("k", [17, 200])
def test_bell_spmm_bf16_pads_uneven_block_rows(dev, k):
    """Rows of 1 to 4 blocks (padding slots: bcol 0, zero values), m and
    n not multiples of 128, a second column tile cut short at K = 200."""
    from sblas_tpu_torch.ops.bsr import BsrPlan
    plan = BsrPlan.from_csr(_uneven_block_rows(), dtype=BF16, device=dev)
    nz = (plan.vals != 0).flatten(2).any(-1).sum(1).cpu()
    assert plan.slots == 4 and set(nz.tolist()) == {1, 2, 3, 4}
    got, again, want, launched = _k4_bf16_call(plan, k, k)
    assert torch.equal(got, again) and int(_ulps(got, want).max()) <= 1
    assert sum(launched.values()) == 2


@pytest.mark.parametrize("alpha,beta", [(0.0, 4.0), (3.0, 0.0)])
def test_bell_spmm_bf16_alpha_or_beta_zero(dev, alpha, beta):
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops.bsr import BsrPlan
    plan = BsrPlan.from_csr(fem_banded_like(n=3000, half_band=36),
                            dtype=BF16, device=dev)
    got, again, want, _ = _k4_bf16_call(plan, 256, 1, alpha, beta)
    assert torch.equal(got, again) and int(_ulps(got, want).max()) <= 1


def test_bell_spmm_bf16_unaligned_operand_takes_ragged(dev):
    """K = 256 but B two bytes off a 16-byte boundary: the `bf16_ragged`
    variant runs, within one ulp."""
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops.bsr import BsrPlan
    plan = BsrPlan.from_csr(fem_banded_like(n=3000, half_band=36),
                            dtype=BF16, device=dev)
    got, again, want, launched = _k4_bf16_call(plan, 256, 2, offset=1)
    assert launched == {"sblas_bell_spmm_bf16_ragged": 2}
    assert torch.equal(got, again) and int(_ulps(got, want).max()) <= 1


def test_bell_spmm_bf16_without_slots_is_beta_c(dev):
    """A BELL layout with no slots: the ragged variant writes beta * C."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import bsr_pallas as tb
    vals = torch.zeros((2, 0, 128, 128), dtype=BF16, device=dev)
    bcol = torch.zeros((2, 0), dtype=torch.int32, device=dev)
    B = torch.rand((100, 256), device=dev).to(BF16)
    C = torch.rand((200, 256), device=dev).to(BF16)
    _kernels.LAUNCHED.clear()
    got = tb.bell_spmm(vals, bcol, B, C, 3.0, 4.0)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHED) == {"sblas_bell_spmm_bf16_ragged": 1}
    assert torch.equal(got, (4.0 * C.float()).to(BF16))


def test_spmv_routed_bf16_transport_on_card(dev):
    """The bf16 transport on the card: K2 stores bf16, K1 runs on 16-bit
    lanes with int16 tables, and y meets the CPU run to f32 order and the
    oracle at the transport's 1e-2."""
    import dataclasses

    from sblas_tpu_torch.config import DEFAULT
    from sblas_tpu_torch.ops.cpu_reference import spmv_cpu
    from sblas_tpu_torch.utils.verify import check_equal
    A = webbase_like(n=100_000, avg_deg=4.0, dtype=np.float32)
    cfg = dataclasses.replace(DEFAULT, routed_transport="bf16")
    plan = make_plan(A, dtype=torch.float32, op="spmv", config=cfg,
                     device="cpu")
    assert plan.transport == "bf16"
    xh = DenseVector.random(A.width, dtype=np.float32)
    x = torch.from_numpy(xh.values)
    y = torch.ones(A.height)
    want = spmv(plan, x, 3.0, 4.0, y)
    on_card = plan.to(dev)
    _reset_k1()
    tr.slab_gather.launches = 0
    got = spmv(on_card, x.to(dev), 3.0, 4.0, y.to(dev)).cpu()
    assert _k1_launches() == plan.n_route_gathers
    assert tr.slab_gather.launches == 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert check_equal(got.numpy(), spmv_cpu(
        A, xh, 3.0, 4.0, DenseVector.constant(A.height, 1.0)),
        error_bar=1e-2, relative=True).ok


@pytest.mark.parametrize("kind", ["routed", "wcoo", "bsr", "ell", "coo",
                                  "dia"])
def test_bf16_plans_on_card_match_cpu(dev, kind):
    """bf16-valued plans of every kind on the card: SpMV (and SpMM, K=256
    so BELL takes K4) against the same plan on the CPU at the JAX bf16
    test's bound, and the kernels each path runs counted."""
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops import spmm
    from sblas_tpu_torch.ops import wcoo as tw
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    A = (webbase_like(n=20_000, avg_deg=4.0, dtype=np.float32)
         if kind in ("routed", "wcoo")
         else fem_banded_like(n=3000, half_band=36))
    plan = make_plan(A, dtype=BF16, force=kind, device="cpu")
    on_card = plan.to(dev)
    x = torch.rand(A.width).to(BF16)
    y = torch.ones(A.height, dtype=BF16)
    torch.testing.assert_close(
        spmv(on_card, x.to(dev), 1.0, 1.0, y.to(dev)).cpu().float(),
        spmv(plan, x, 1.0, 1.0, y).float(), rtol=0.15, atol=0.15)
    if kind == "routed":
        return
    B = torch.rand((A.width, 256)).to(BF16)
    C = torch.ones((A.height, 256), dtype=BF16)
    tw.window_reduce.launches = tb.bell_spmm.launches = 0
    got = spmm(on_card, B.to(dev), 1.0, 1.0, C.to(dev)).cpu()
    assert tw.window_reduce.launches == (kind == "wcoo")
    assert tb.bell_spmm.launches == (kind == "bsr")
    torch.testing.assert_close(got.float(),
                               spmm(plan, B, 1.0, 1.0, C).float(),
                               rtol=0.15, atol=0.15)


# ---- bf16 values through the distributed and host-streamed containers ----

@pytest.fixture(scope="module")
def nccl1(tmp_path_factory):
    """A world-1 NCCL group through a FileStore, its mesh and 1x1 two-tier
    mesh; destroyed at teardown."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import torch.distributed as dist
    from sblas_tpu_torch import parallel as tpar
    dev = torch.device("cuda", 0)
    store = tmp_path_factory.mktemp("nccl") / "s"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=dev)
    try:
        yield tpar.make_mesh(1, device=dev), tpar.make_mesh2(1, 1, device=dev)
    finally:
        dist.destroy_process_group()


def _bf16_dist_case(name, dev, mesh, mesh2):
    """(matrix, op, run(A, x or B, y or C), the launches by variant it
    must make, or None to count them from the built container)."""
    from sblas_tpu_torch import memory as tmem
    from sblas_tpu_torch import parallel as tpar
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.partition import partition_nnz_balanced
    kw = dict(dtype=BF16, device=dev)
    a, b = 3.0, 4.0
    web = webbase_like(n=20_000, avg_deg=4.0, dtype=np.float64)
    band = fem_banded_like(n=3000, half_band=36)
    return {
        "mode1_wcoo": (web, "mm", lambda A, B, C: tpar.spmm_mode1(
            make_plan(A, force="wcoo", **kw), B, a, b, C, mesh)),
        "mode1_bsr": (band, "mm", lambda A, B, C: tpar.spmm_mode1(
            make_plan(A, force="bsr", **kw), B, a, b, C, mesh)),
        "mode2": (web, "mm", lambda A, B, C: tpar.spmm_mode2(
            partition_nnz_balanced(A, 1, **kw), B, a, b, C, mesh)),
        "dist": (web, "mv", lambda A, x, y: tpar.spmv_dist(
            partition_nnz_balanced(A, 1, **kw), x, a, b, y, mesh)),
        "planned_routed": (web, "mv", lambda A, x, y: tpar.spmv_dist_planned(
            tpar.partition_row_plans(A, 1, kind="routed", **kw), x, a, b, y,
            mesh)),
        "hier_routed": (web, "mv", lambda A, x, y: tpar.spmv_dist_hier(
            tpar.partition_row_plans(A, 1, kind="routed", **kw), x, a, b, y,
            mesh2)),
        "xfoot_routed": (web, "mv", lambda A, x, y: tpar.spmv_xfoot(
            tpar.partition_xfoot(A, 1, kind="routed", **kw), x, a, b, y,
            mesh)),
        "planned_wcoo": (web, "mm", lambda A, B, C: tpar.spmm_mode2_planned(
            tpar.partition_row_plans(A, 1, kind="wcoo", **kw), B, a, b, C,
            mesh)),
        "halo_planned": (band, "mm", lambda A, B, C: tpar.spmm_halo_planned(
            tpar.partition_halo_dia(A, 1, **kw), B, a, b, C, mesh)),
        "um": (web, "mm", lambda A, B, C: tmem.spmm_um(
            tmem.host_resident_plan(A, hbm_budget_bytes=1 << 20, **kw), B,
            a, b, C)),
        "um_dist": (web, "mm", lambda A, B, C: tmem.spmm_um_dist(
            tmem.host_resident_shards(A, 1, hbm_budget_bytes=1 << 20, **kw),
            B, a, b, C, mesh)),
        "um_mode1": (web, "mm", lambda A, B, C: tmem.spmm_um_mode1(
            tmem.host_resident_plan(A, hbm_budget_bytes=1 << 20, **kw), B,
            a, b, C, mesh)),
        "um_spmv_dist": (web, "mv", lambda A, x, y: tmem.spmv_um_dist(
            tmem.host_resident_shards(A, 1, hbm_budget_bytes=1 << 20, **kw),
            x, a, b, y, mesh)),
    }[name]


BF16_DIST = {   # the kernels each path may launch, by variant
    "mode1_wcoo": {"window_reduce_bf16"}, "mode1_bsr": {"bell_spmm_bf16"},
    "mode2": set(), "dist": set(),
    "planned_routed": {"tile_gather_bf16", "lane_shuffle_bf16",
                       "lane_shuffle_transposed_bf16"},
    "hier_routed": {"tile_gather_bf16", "lane_shuffle_bf16",
                    "lane_shuffle_transposed_bf16"},
    "xfoot_routed": {"tile_gather_bf16", "lane_shuffle_bf16",
                     "lane_shuffle_transposed_bf16"},
    "planned_wcoo": {"window_reduce_bf16"}, "halo_planned": set(),
    "um": {"window_reduce_bf16"}, "um_dist": {"window_reduce_bf16"},
    "um_mode1": {"window_reduce_bf16"}, "um_spmv_dist": set(),
}


@pytest.mark.parametrize("name", sorted(BF16_DIST))
def test_bf16_dist_and_streamed_paths_on_card(dev, nccl1, name):
    """Each distributed and streamed path over bf16 containers on the
    card: a bf16 result within the JAX package's bound of the f64 oracle
    (rtol = atol = 0.15), launching only the bf16 variants named (K3's
    `bf16`, never `bf16_ragged`, at K = 64; K2', never K2; K4 `bf16` on
    the BELL mode-1 block at K = 256) and each of them."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.containers import DenseMatrix
    from sblas_tpu_torch.ops.cpu_reference import spmm_cpu, spmv_cpu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mesh, mesh2 = nccl1
    A, op, run = _bf16_dist_case(name, dev, mesh, mesh2)
    k = 256 if name == "mode1_bsr" else (64 if op == "mm" else 1)
    X = DenseMatrix.random(A.width, k).values.astype(np.float32)
    Y = np.ones((A.height, k), np.float32)
    if op == "mv":
        X, Y = X[:, 0].copy(), Y[:, 0].copy()
    Xd, Yd = (torch.from_numpy(v).to(BF16).to(dev) for v in (X, Y))
    _kernels.LAUNCHED.clear()
    got = run(A, Xd, Yd)
    torch.cuda.synchronize()
    ran = {key[len("sblas_"):] for key in _kernels.LAUNCHED}
    assert ran == BF16_DIST[name], ran
    assert got.dtype == BF16
    got = got.double().cpu().numpy()
    if op == "mm":
        want = spmm_cpu(A, DenseMatrix(X.astype(np.float64)), 3.0, 4.0,
                        DenseMatrix(Y.astype(np.float64)))
    else:
        want = spmv_cpu(A, DenseVector(X.astype(np.float64)), 3.0, 4.0,
                        DenseVector(Y.astype(np.float64)))
    assert np.all(np.abs(got - want) <= 0.15 * (1 + np.abs(want)))


def test_bf16_bands_pinned_as_bf16(dev):
    """A bf16 host-resident plan pins bf16 values, so a streamed call
    copies bf16 bytes: half the f32 plan's value bytes per band slot."""
    from sblas_tpu_torch import memory as tmem
    from sblas_tpu_torch.memory.host import tensor_fields
    A = webbase_like(n=20_000, avg_deg=4.0, dtype=np.float64)
    hp = tmem.host_resident_plan(A, dtype=BF16, hbm_budget_bytes=1 << 20,
                                 device=dev)
    assert all(b.vals.dtype == BF16 and b.vals.is_pinned()
               and all(getattr(b, f).is_pinned() for f in tensor_fields(b))
               for b in hp.bands)
    x = torch.rand(A.width, device=dev).to(BF16)
    y = torch.ones(A.height, device=dev, dtype=BF16)
    out = tmem.spmv_um(hp, x, 3.0, 4.0, y)
    torch.cuda.synchronize()
    assert out.dtype == BF16
    assert hp.last_stream.bytes == hp.band_bytes
    grid = tmem.host_resident_grid(A, dtype=BF16, hbm_budget_bytes=1 << 20,
                                   k=8, device=dev)
    assert all(c.vals.dtype == BF16 and c.vals.is_pinned()
               for c in grid.cells.values())
    hd = tmem.HostDense.from_array(torch.ones((4, 2), dtype=BF16),
                                   device=dev)
    assert hd.values.dtype == BF16 and hd.values.is_pinned()


@pytest.mark.parametrize("plan_dtype,c_dtype", [
    (BF16, torch.float32), (torch.float32, torch.float64)])
def test_spmm_wcoo_keeps_a_wider_c_on_card(dev, plan_dtype, c_dtype):
    """A C wider than the plan on the card: K3 forms A@B in the plan's
    dtype (one call per chunk, its grid form) and the epilogue runs in C's,
    so the result is off the plan's grid and equals beta*C + alpha*(K3's
    grid-form product on the card) to C's own rounding."""
    from sblas_tpu_torch.ops import wcoo as tw
    A = webbase_like(n=20_000, avg_deg=4.0, dtype=np.float64)
    plan = make_plan(A, dtype=plan_dtype, force="wcoo", device="cpu")
    g = torch.Generator().manual_seed(0)
    B = torch.rand((A.width, 64), generator=g, dtype=torch.float64)
    C = torch.rand((A.height, 64), generator=g, dtype=torch.float64) * 1000
    B, C = B.to(c_dtype), (C + 1).to(c_dtype)
    tw.window_reduce.launches = 0
    got = tw.spmm_wcoo(plan.to(dev), B.to(dev), 3.0, 4.0, C.to(dev)).cpu()
    assert tw.window_reduce.launches == -(-64 // tw.k_chunk_width(
        plan.n_tiles, 64))
    assert got.dtype == c_dtype
    assert not torch.equal(got, got.to(plan_dtype).to(c_dtype))
    p = plan.to(dev)
    ab = tw.window_reduce(p.k3, p.wb, p.relrow, p.vals, p.xblk, p.lane,
                          B.to(plan_dtype).to(dev), 0, 64)[:A.height].cpu()
    kept = 4.0 * C.double() + 3.0 * ab.double()
    rel = ((got.double() - kept).abs() / kept.abs()).max()
    assert rel <= torch.finfo(c_dtype).eps, rel


# ---- the two ragged bf16 kernels over strides, offsets, widths and tails:
# within one bf16 ulp of their plain versions, two launches bitwise ----

def _at_offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of `t` starting `off` elements (2 off bytes for
    bf16) past a 16-byte boundary."""
    buf = torch.empty(off + t.numel(), dtype=t.dtype, device=t.device)
    return buf[off:].view(t.shape).copy_(t)


@pytest.mark.parametrize("offs", [(0, 0, 0), (0, 1, 7), (3, 5, 2)])
@pytest.mark.parametrize("case,k", [("uneven", 257), ("uneven", 263),
                                    ("uneven", 300), ("uneven", 383),
                                    ("band20k", 263), ("band20k", 383)])
def test_bell_spmm_bf16_ragged_within_one_ulp(dev, case, k, offs):
    """K4[bf16_ragged] at K % 8 != 0 on m = 700, n = 900 (padding slots,
    both dimensions' tails) and on a 157-block-row band (more tiles than
    SMs: each persistent block walks several), with vals, B and C
    starting 0 to 14 bytes past 16 (a vals off 16 bytes is copied to
    fresh storage by the wrapper)."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops.bsr import BsrPlan
    A = (_uneven_block_rows() if case == "uneven"
         else fem_banded_like(n=20_000, half_band=36))
    plan = BsrPlan.from_csr(A, dtype=BF16, device=dev)
    m, n = A.shape
    g = torch.Generator(device=dev).manual_seed(k)
    ov, ob, oc = offs
    vals = _at_offset(plan.vals, ov)
    B = _at_offset(torch.rand((n, k), generator=g, device=dev).to(BF16), ob)
    C = _at_offset(torch.rand((m, k), generator=g, device=dev).to(BF16), oc)
    args = (vals, plan.bcol, B, C, 3.0, 4.0)
    _kernels.LAUNCHED.clear()
    got, again = tb.bell_spmm(*args), tb.bell_spmm(*args)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHED) == {"sblas_bell_spmm_bf16_ragged": 2}
    assert torch.equal(got, again)
    assert int(_ulps(got, tb.bell_spmm_plain(*args)).max()) <= 1


@pytest.mark.parametrize("k,off", [(263, 0), (300, 3)])
def test_bell_spmm_bf16_ragged_without_slots_is_beta_c(dev, k, off):
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import bsr_pallas as tb
    vals = torch.zeros((3, 0, 128, 128), dtype=BF16, device=dev)
    bcol = torch.zeros((3, 0), dtype=torch.int32, device=dev)
    B = torch.rand((100, k), device=dev).to(BF16)
    C = _at_offset(torch.rand((300, k), device=dev).to(BF16), off)
    _kernels.LAUNCHED.clear()
    got = tb.bell_spmm(vals, bcol, B, C, 3.0, 4.0)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHED) == {"sblas_bell_spmm_bf16_ragged": 1}
    assert torch.equal(got, (4.0 * C.float()).to(BF16))


@pytest.mark.parametrize("ob", [0, 1])
def test_bell_spmm_bf16_ragged_every_column_tiling(dev, ob):
    """K4[bf16_ragged] at every K from 1 to 776 (B one element off 16
    bytes, or at K % 8 != 0, so the ragged variant runs at every K):
    within one ulp of its plain version, so every column-tile schedule
    the kernel cuts from K (`ragged_tile_width`) covers K's columns."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops.bsr import BsrPlan
    plan = BsrPlan.from_csr(_uneven_block_rows(), dtype=BF16, device=dev)
    m, n = plan.shape
    g = torch.Generator(device=dev).manual_seed(ob)
    Bw = torch.rand((n, 776), generator=g, device=dev).to(BF16)
    Cw = torch.rand((m, 776), generator=g, device=dev).to(BF16)
    worst, launched = {}, 0
    for k in range(1, 777):
        if ob == 0 and k % 8 == 0:
            continue
        B = _at_offset(Bw[:, :k].contiguous(), ob)
        args = (plan.vals, plan.bcol, B, Cw[:, :k].contiguous(), 3.0, 4.0)
        _kernels.LAUNCHED.clear()
        got = tb.bell_spmm(*args)
        launched += _kernels.LAUNCHED["sblas_bell_spmm_bf16_ragged"]
        worst[k] = int(_ulps(got, tb.bell_spmm_plain(*args)).max())
    torch.cuda.synchronize()
    assert launched == len(worst)
    assert {k: u for k, u in worst.items() if u > 1} == {}


# K3[bf16_ragged]'s two bodies: `masked` (the `bf16` sub-warp rows on whole
# words) where the row strides are multiples of 8 and B at k0, C and out
# share one 16-byte offset, `ring` (the same sub-warp rows fed by a
# shared-memory ring of each entry's covering words, shifted on the read)
# otherwise; each test names the body it reaches and checks it by
# `_kernels.BODIES`.

def _bodies():
    from sblas_tpu_torch import _kernels
    return {k[len("window_reduce_bf16_ragged."):]: v
            for k, v in _kernels.BODIES.items()
            if k.startswith("window_reduce_bf16_ragged.")}


# stride: "odd" (every entry's B row at its own offset), "even" (K % 8 !=
# 0), "x8" (K % 8 == 0: the masked body, in the grid form where its width
# is a multiple of 8); k0 = 0 at width 64 and "x8" is the `bf16` variant's
_K3_RAGGED = [(k0, width, stride) for k0 in (0, 1, 3, 7)
              for width in (1, 7, 47, 63, 64, 81)
              for stride in ("odd", "even", "x8")
              if (k0, width, stride) != (0, 64, "x8")]


@pytest.mark.parametrize("form", ["grid", "fused"])
@pytest.mark.parametrize("k0,width,stride", _K3_RAGGED)
def test_window_reduce_bf16_ragged_grid_of_shapes(dev, k0, width, stride,
                                                  form):
    """K3[bf16_ragged] at k0 in {0, 1, 3, 7}, width in {1, 7, 47, 63, 64,
    81} and an odd, an even or a multiple-of-8 row stride: within one ulp,
    bitwise across launches, and in the fused form nothing written
    outside its columns and rows.  In the grid form (out at its own 16
    bytes) B starts -k0 elements off 16 bytes at the multiple-of-8
    stride, so B at k0 and out share an offset."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import wcoo as tw
    plan, _ = _k3_case(dev, BF16, "web3k")
    k = k0 + width + 2
    if stride == "x8":
        k = -(-k // 8) * 8
    else:
        k += (k % 2 == 1) != (stride == "odd")
        k += 2 * (k % 8 == 0)
    _kernels.BODIES.clear()
    if form == "fused":
        (got, again, want), launched = _k3_fused(plan, k, k0, width, BF16,
                                                 seed=k0 + width)
        outside = torch.ones_like(got, dtype=torch.bool)
        outside[:plan.shape[0], k0:k0 + width] = False
        assert bool((got[outside] == -7.0).all())
        masked = stride == "x8"
    else:
        g = torch.Generator(device=dev).manual_seed(k0 + width)
        B = torch.rand((plan.shape[1], k), generator=g, device=dev).to(BF16)
        if stride == "x8":
            B = _at_offset(B, -k0 % 8)
        args = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk,
                plan.lane, B, k0, width)
        _kernels.LAUNCHED.clear()
        got, again = tw.window_reduce(*args), tw.window_reduce(*args)
        torch.cuda.synchronize()
        launched = {n[len("sblas_window_reduce_"):]: v
                    for n, v in _kernels.LAUNCHED.items()}
        want = tw.window_reduce_plain(*args)
        masked = stride == "x8" and width % 8 == 0
    assert launched == {"bf16_ragged": 2}
    assert _bodies() == {"masked" if masked else "ring": 2}
    assert torch.equal(got, again)
    assert int(_ulps(got, want).max()) <= 1


# the row strides of the bf16 WCOO SpMM at K = 63 (one chunk) and K = 100
# (webbase-1M's chunks of 81 + 19 columns): k0 in {0, 1, 3, 7}, widths
# from one column to the row's end
_K3_RING = [(k, k0, width) for k in (63, 100) for k0 in (0, 1, 3, 7)
            for width in (1, 19, 47, k - k0)]


@pytest.mark.parametrize("form", ["grid", "fused", "offsets"])
@pytest.mark.parametrize("case", ["web3k", "long_row"])
@pytest.mark.parametrize("k,k0,width", _K3_RING)
def test_window_reduce_bf16_ragged_ring_at_spmm_strides(dev, case, k, k0,
                                                        width, form):
    """The ring body at row strides 63 and 100 (every entry's B segment at
    its own offset in its 16-byte words, and C's and out's rows too):
    within one ulp of the plain version, bitwise across launches, in the
    fused form nothing written outside its columns and rows, also with B,
    C and out each starting at its own offset past 16 bytes ("offsets");
    the long row (10,000 entries) spans dozens of units (carries)."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import wcoo as tw
    plan, _ = _k3_case(dev, BF16, case)
    _kernels.BODIES.clear()
    if form == "offsets":
        m, n = plan.shape
        g = torch.Generator(device=dev).manual_seed(k + k0 + width)
        B = _at_offset(torch.rand((n, k), generator=g, device=dev).to(BF16),
                       3)
        C = _at_offset(torch.rand((m, k), generator=g, device=dev).to(BF16),
                       5)
        outs = [_at_offset(torch.full((m, k), -7.0, device=dev, dtype=BF16),
                           1) for _ in range(2)]
        args = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk,
                plan.lane, B, k0, width)
        _kernels.LAUNCHED.clear()
        for out in outs:
            tw.window_reduce(*args, C=C, alpha=3.0, beta=4.0, out=out)
        torch.cuda.synchronize()
        launched = {n[len("sblas_window_reduce_"):]: v
                    for n, v in _kernels.LAUNCHED.items()}
        got, again = outs
        want = tw.window_reduce_plain(*args, C=C, alpha=3.0, beta=4.0,
                                      out=torch.full((m, k), -7.0,
                                                     device=dev, dtype=BF16))
        outside = torch.ones_like(got, dtype=torch.bool)
        outside[:, k0:k0 + width] = False
        assert bool((got[outside] == -7.0).all())
    elif form == "fused":
        (got, again, want), launched = _k3_fused(plan, k, k0, width, BF16,
                                                 seed=k + k0 + width)
        outside = torch.ones_like(got, dtype=torch.bool)
        outside[:plan.shape[0], k0:k0 + width] = False
        assert bool((got[outside] == -7.0).all())
    else:
        g = torch.Generator(device=dev).manual_seed(k + k0 + width)
        B = torch.rand((plan.shape[1], k), generator=g, device=dev).to(BF16)
        args = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk,
                plan.lane, B, k0, width)
        _kernels.LAUNCHED.clear()
        got, again = tw.window_reduce(*args), tw.window_reduce(*args)
        torch.cuda.synchronize()
        launched = {n[len("sblas_window_reduce_"):]: v
                    for n, v in _kernels.LAUNCHED.items()}
        want = tw.window_reduce_plain(*args)
    assert launched == {"bf16_ragged": 2}
    assert _bodies() == {"ring": 2}
    assert torch.equal(got, again)
    assert int(_ulps(got, want).max()) <= 1


@pytest.mark.parametrize("k,offs", [
    (90, (1, 0, 0)), (90, (0, 3, 5)), (90, (7, 7, 1)), (90, (2, 6, 4)),
    (96, (1, 1, 1)), (96, (3, 3, 3)), (96, (6, 6, 6)), (96, (7, 7, 7)),
    (91, (1, 0, 0)), (91, (0, 3, 5)), (100, (7, 7, 1)), (100, (2, 6, 4))])
@pytest.mark.parametrize("case,k0,width", [("web3k", 0, 64),
                                           ("web3k", 3, 47),
                                           ("long_row", 1, 81)])
def test_window_reduce_bf16_ragged_offset_operands(dev, case, k0, width, k,
                                                   offs):
    """B, C and out starting 0 to 14 bytes past 16: at 90, 91 and 100
    columns each at its own offset (the ring body, C's and out's rows at
    their own offsets), at 96 all at one offset (the masked body); the
    long row spans dozens of units (carries)."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import wcoo as tw
    plan, _ = _k3_case(dev, BF16, case)
    m, n = plan.shape
    ob, oc, oo = offs
    g = torch.Generator(device=dev).manual_seed(sum(offs))
    B = _at_offset(torch.rand((n, k), generator=g, device=dev).to(BF16), ob)
    C = _at_offset(torch.rand((m, k), generator=g, device=dev).to(BF16), oc)
    outs = [_at_offset(torch.full((m, k), -7.0, device=dev, dtype=BF16), oo)
            for _ in range(2)]
    args = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk, plan.lane,
            B, k0, width)
    _kernels.BODIES.clear()
    for out in outs:
        tw.window_reduce(*args, C=C, alpha=3.0, beta=4.0, out=out)
    torch.cuda.synchronize()
    want = tw.window_reduce_plain(*args, C=C, alpha=3.0, beta=4.0,
                                  out=torch.full((m, k), -7.0, device=dev,
                                                 dtype=BF16))
    assert _bodies() == {"masked" if k % 8 == 0 else "ring": 2}
    assert torch.equal(outs[0], outs[1])
    assert int(_ulps(outs[0], want).max()) <= 1


@pytest.mark.parametrize("k,k0,width,body", [
    (128, 0, 81, "masked"), (128, 81, 47, "masked"), (100, 0, 81, "ring"),
    (100, 81, 19, "ring"), (63, 0, 63, "ring")])
@pytest.mark.parametrize("case", ["web20k", "long_row"])
def test_window_reduce_bf16_ragged_spmm_chunks(dev, case, k, k0, width,
                                               body):
    """The chunks a bf16 WCOO SpMM runs at webbase-1M's chunk width of 81:
    at K = 128 (k0 = 0, 81 columns; k0 = 81, 47 columns) the masked body,
    at K = 100 (81 + 19 columns) and K = 63 (one chunk) the ring body;
    within one ulp and bitwise across launches; the long row spans dozens
    of units (carries)."""
    from sblas_tpu_torch import _kernels
    plan, _ = _k3_case(dev, BF16, case)
    _kernels.BODIES.clear()
    (got, again, want), launched = _k3_fused(plan, k, k0, width, BF16,
                                             seed=k0)
    assert launched == {"bf16_ragged": 2}
    assert _bodies() == {body: 2}
    assert torch.equal(got, again)
    assert int(_ulps(got, want).max()) <= 1


@pytest.mark.parametrize("k", [72, 63])
@pytest.mark.parametrize("form", ["grid", "fused"])
@pytest.mark.parametrize("case", ["web20k", "long_row", "min_tiles"])
def test_window_reduce_bf16_ragged_gives_the_bf16_bits(dev, case, form, k):
    """Where `bf16` can run (the same 56 columns copied to aligned,
    8-column-multiple operands) it and `bf16_ragged` at k0 = 1 (the ring
    body in the grid form, whose out starts on 16 bytes, and at the odd
    row stride 63 in both forms; the masked body in the fused form at
    72) sum in one order and round once alike: the results are bitwise
    equal."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import wcoo as tw
    plan, _ = _k3_case(dev, BF16, case)
    m, n = plan.shape
    g = torch.Generator(device=dev).manual_seed(56)
    B = torch.rand((n, k), generator=g, device=dev).to(BF16)
    C = torch.rand((m, k), generator=g, device=dev).to(BF16)
    Ba, Ca = B[:, 1:57].contiguous(), C[:, 1:57].contiguous()
    tabs = (plan.k3, plan.wb, plan.relrow, plan.vals, plan.xblk, plan.lane)
    epi = dict(C=C, alpha=3.0, beta=4.0) if form == "fused" else {}
    epi_a = dict(epi, C=Ca) if epi else {}
    _kernels.LAUNCHED.clear()
    _kernels.BODIES.clear()
    got = tw.window_reduce(*tabs, B, 1, 56, **epi)
    want = tw.window_reduce(*tabs, Ba, 0, 56, **epi_a)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHED) == {"sblas_window_reduce_bf16_ragged": 1,
                                       "sblas_window_reduce_bf16": 1}
    assert _bodies() == {"masked" if epi and k % 8 == 0 else "ring": 1}
    assert torch.equal(got[:, 1:57] if epi else got, want)


@pytest.mark.parametrize("width,off,k", [(47, 0, 90), (81, 5, 90),
                                         (47, 0, 96), (81, 0, 96),
                                         (60, 3, 63), (81, 1, 100)])
def test_window_reduce_bf16_ragged_without_entries(dev, width, off, k):
    """A plan with no entries (no units): every row of the fused form is
    beta * C, written by the carry combine alone, behind either body (the
    masked one at 96 columns with C on 16 bytes, the ring one else)."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.containers import CsrMatrix
    from sblas_tpu_torch.ops import wcoo as tw
    m, n = 300, 200
    A = CsrMatrix(np.zeros(m + 1, dtype=np.int64), np.zeros(0, np.int64),
                  np.zeros(0, np.float32), (m, n))
    plan = tw.WcooPlan.from_csr(A, dtype=BF16, device=dev)
    B = torch.rand((n, k), device=dev).to(BF16)
    C = _at_offset(torch.rand((m, k), device=dev).to(BF16), off)
    _kernels.BODIES.clear()
    out = tw.window_reduce(plan.k3, plan.wb, plan.relrow, plan.vals,
                           plan.xblk, plan.lane, B, 3, width, C=C,
                           alpha=3.0, beta=4.0)
    torch.cuda.synchronize()
    assert _bodies() == {"masked" if k % 8 == 0 else "ring": 1}
    assert torch.equal(out[:, 3:3 + width],
                       (4.0 * C[:, 3:3 + width].float()).to(BF16))


# ---- K1 and K2: unaligned operands, and PDL launches back to back ----


def _one_in(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` whose base is one element past an allocation's."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _launch_bases(monkeypatch) -> list:
    """Every launch's tensor operands' base addresses mod 16, recorded by
    a `_kernels.launch` that then launches as before."""
    from sblas_tpu_torch import _kernels
    seen, launch = [], _kernels.launch

    def recording(fn_name, device, *args):
        seen.append([a.data_ptr() % 16 for a in args
                     if isinstance(a, torch.Tensor)])
        return launch(fn_name, device, *args)
    monkeypatch.setattr(_kernels, "launch", recording)
    return seen


@pytest.mark.parametrize("operand", ["x", "idx"])
@pytest.mark.parametrize("variant", list(K1_VARIANTS))
def test_lane_shuffle_unaligned_base_runs_scalar_body(dev, variant,
                                                      operand,
                                                      monkeypatch):
    """An x or idx one element off the row body's vector (K1's one body)
    reaches the kernel copied to fresh storage, every base on 16 bytes:
    one launch, bitwise the plain version."""
    from sblas_tpu_torch import _kernels
    dt, it = K1_VARIANTS[variant]
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((37, 128), generator=g, device=dev).to(dt)
    idx = torch.randint(0, 128, (37, 128), generator=g, device=dev,
                        dtype=torch.int32).to(it)
    if operand == "x":
        x = _one_in(x)
    else:
        idx = _one_in(idx)
    bases = _launch_bases(monkeypatch)
    _kernels.LAUNCHED.clear()
    got = troute.lane_shuffle(x, idx)
    torch.cuda.synchronize()
    assert bases == [[0, 0, 0]]
    assert dict(_kernels.LAUNCHED) == {f"sblas_lane_shuffle_{variant}": 1}
    assert torch.equal(got, troute.lane_shuffle_plain(x, idx))


@pytest.mark.parametrize("operand", ["gidx", "gvals", "x_slabs"])
@pytest.mark.parametrize("variant", list(K2_VARIANTS))
def test_slab_gather_unaligned_base_runs_scalar_body(dev, variant,
                                                     operand, monkeypatch):
    """A gidx or gvals one element off the row body's vector (K2's one
    body) reaches the kernel copied to fresh storage, on 16 bytes; x_slabs
    is read by element, so an offset x_slabs is passed as it is.  One
    launch, bitwise the plain version."""
    from sblas_tpu_torch import _kernels
    dt, ot = K2_VARIANTS[variant]
    g = torch.Generator(device=dev).manual_seed(4)
    shape = (5, 128, 128)
    x_slabs = torch.randn((3, 128, 128), generator=g, device=dev).to(dt)
    gslab = torch.randint(0, 3, (5,), generator=g, device=dev,
                          dtype=torch.int32)
    gidx = torch.randint(0, 128, shape, generator=g, device=dev,
                         dtype=torch.int32)
    gvals = torch.randn(shape, generator=g, device=dev).to(dt)
    ops = dict(x_slabs=x_slabs, gidx=gidx, gvals=gvals)
    ops[operand] = _one_in(ops[operand])
    bases = _launch_bases(monkeypatch)
    _kernels.LAUNCHED.clear()
    got = tr.slab_gather(gslab, ops["x_slabs"], ops["gidx"], ops["gvals"],
                         ot)
    torch.cuda.synchronize()
    x_at = ops["x_slabs"].data_ptr() % 16
    assert bases == [[0, x_at, 0, 0, 0]]
    assert dict(_kernels.LAUNCHED) == {f"sblas_slab_gather_{variant}": 1}
    assert torch.equal(got, tr.slab_gather_plain(
        gslab, ops["x_slabs"], ops["gidx"], ops["gvals"], ot))


def _k1_k2_chain(variant: str, dev, n_slabs=62, n_tiles=188, seed=8):
    """A K1 -> K1 -> K2 chain in which each kernel reads what the kernel
    just before wrote: K1 twice on x viewed as (n_slabs * 128, 128) rows,
    K2 on the result as its slabs; under `transport` (f32 values, the
    bf16 route transport) K2 stores bf16 and K1 `bf16_i16` runs twice on
    its products.  Returns (run, x): `run(True)` launches the kernels,
    `run(False)` their plain versions, both on the tensor x."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = {"f64": torch.float64, "bf16": BF16}.get(variant, torch.float32)
    rows = n_slabs * 128
    x = torch.randn((rows, 128), generator=g, device=dev).to(dt)
    idx = [torch.randint(0, 128, (rows, 128), generator=g, device=dev,
                         dtype=torch.int32) for _ in range(2)]
    gslab = torch.randint(0, n_slabs, (n_tiles,), generator=g, device=dev,
                          dtype=torch.int32)
    shape = (n_tiles, 128, 128)
    gidx = torch.randint(0, 128, shape, generator=g, device=dev,
                         dtype=torch.int32)
    gvals = torch.randn(shape, generator=g, device=dev).to(dt)
    idx16 = [torch.randint(0, 128, (n_tiles * 128, 128), generator=g,
                           device=dev, dtype=torch.int16) for _ in range(2)]
    ot = BF16 if variant == "transport" else None

    def run(kernels: bool):
        k1 = troute.lane_shuffle if kernels else troute.lane_shuffle_plain
        k2 = tr.slab_gather if kernels else tr.slab_gather_plain
        a = k1(k1(x, idx[0]), idx[1])
        out = k2(gslab, a.view(n_slabs, 128, 128), gidx, gvals, ot)
        if variant == "transport":
            out = k1(k1(out.view(-1, 128), idx16[0]), idx16[1])
        return out
    return run, x


@pytest.mark.parametrize("variant", ["f32", "f64", "bf16", "transport"])
def test_k1_k2_chain_back_to_back_bitwise(dev, variant):
    """K1 -> K1 -> K2 (-> K1 -> K1), each launched with programmatic
    dependent launch on what the one before wrote: eagerly, 8 chains back
    to back, and replayed from a CUDA graph (its edges programmatic), each
    bitwise the plain chain; the graph again after new input."""
    from sblas_tpu_torch import _kernels
    run, x = _k1_k2_chain(variant, dev)
    want = run(False)
    _kernels.LAUNCHED.clear()
    outs = [run(True) for _ in range(8)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    assert all(k.startswith(("sblas_lane_shuffle_", "sblas_slab_gather_"))
               for k in _kernels.LAUNCHED)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        run(True)                       # warm-up off the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run(True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    x.copy_(torch.flip(x, (0,)))
    want = run(False)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["f32", "bf16"])
def test_slab_gather_after_a_device_cast_of_gvals(dev, variant):
    """`_gathered_contrib`'s order: gvals cast on the device (f64 to the
    values' dtype) right before K2, whose PDL launch must wait for the
    cast: bitwise the plain product, 8 times back to back."""
    dt = torch.float32 if variant == "f32" else BF16
    g = torch.Generator(device=dev).manual_seed(9)
    shape = (188, 128, 128)
    x_slabs = torch.randn((62, 128, 128), generator=g, device=dev).to(dt)
    gslab = torch.randint(0, 62, (188,), generator=g, device=dev,
                          dtype=torch.int32)
    gidx = torch.randint(0, 128, shape, generator=g, device=dev,
                         dtype=torch.int32)
    g64 = torch.randn(shape, generator=g, device=dev, dtype=torch.float64)
    want = tr.slab_gather_plain(gslab, x_slabs, gidx, g64.to(dt))
    outs = [tr.slab_gather(gslab, x_slabs, gidx, g64.to(dt))
            for _ in range(8)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def test_span_holds_its_kernel_on_the_device_clock(dev):
    """A span of the recorder (`utils/trace.py`) around a
    `torch.cuda._sleep` kernel and a synchronise contains the kernel's
    device interval as `torch.profiler` stamps it: spans and device
    events lie on one clock, which labelling idle gaps by span needs."""
    from sblas_tpu_torch.utils import trace
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with trace.recording() as rec:
            with trace.span("sblas.test"):
                torch.cuda._sleep(20_000_000)   # about 10 ms
                torch.cuda.synchronize(dev)
    (_, start, end, _, _), = rec.spans
    long = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CPU
            and e.duration_ns() > 5_000_000]
    assert len(long) == 1
    kernel = long[0]
    assert start <= kernel.start_ns()
    assert kernel.start_ns() + kernel.duration_ns() <= end
