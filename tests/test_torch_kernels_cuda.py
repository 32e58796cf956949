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
from sblas_tpu_torch.utils.errors import KernelError, ShapeError

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 37, 32768])
def test_lane_shuffle_kernel_matches_plain(dev, dtype, rows):
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn((rows, 128), generator=g, device=dev, dtype=dtype)
    idx = torch.randint(0, 128, (rows, 128), generator=g, device=dev,
                        dtype=torch.int32)
    before = troute.lane_shuffle.launches
    got = troute.lane_shuffle(x, idx)
    torch.cuda.synchronize()
    assert troute.lane_shuffle.launches == before + 1
    assert torch.equal(got, troute.lane_shuffle_plain(x, idx))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_tiles,n_slabs", [(1, 1), (5, 3), (188, 62)])
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
    before = tr.slab_gather.launches
    got = tr.slab_gather(gslab, x_slabs, gidx, gvals)
    torch.cuda.synchronize()
    assert tr.slab_gather.launches == before + 1
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
    troute.lane_shuffle.launches = 0
    tr.slab_gather.launches = 0
    got = spmv(on_card, x.to(dev), 3.0, 4.0, y.to(dev)).cpu()
    assert troute.lane_shuffle.launches == plan.n_route_gathers
    assert tr.slab_gather.launches == 1
    # the card may sum in another order than the CPU
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    coo = make_plan(A, dtype=dtype, force="coo", device=dev)
    torch.testing.assert_close(spmv(coo, x.to(dev), 3.0, 4.0,
                                    y.to(dev)).cpu(), want,
                               rtol=tol, atol=tol)


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,half_band,k", [(700, 9, 17), (3000, 36, 128),
                                           (3000, 36, 256),
                                           (20_000, 36, 300)])
def test_bell_spmm_kernel_matches_plain(dev, dtype, n, half_band, k):
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops.bsr import BsrPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    A = fem_banded_like(n=n, half_band=half_band)
    plan = BsrPlan.from_csr(A, dtype=dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(n)
    B = torch.rand((n, k), generator=g, device=dev, dtype=dtype)
    C = torch.rand((n, k), generator=g, device=dev, dtype=dtype)
    args = (plan.vals, plan.bcol, B, C, 3.0, 4.0)
    before = tb.bell_spmm.launches
    got = tb.bell_spmm(*args)
    again = tb.bell_spmm(*args)
    torch.cuda.synchronize()
    assert tb.bell_spmm.launches == before + 2
    assert torch.equal(got, again)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, tb.bell_spmm_plain(*args), rtol=tol,
                               atol=tol)


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


# ---- P1 (stage_fuse_gather), P2 (window_lane_gather) and xfoot ----

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_tiles,n_slabs", [(1, 1), (5, 3), (188, 62)])
def test_stage_fuse_gather_kernel_matches_plain(dev, dtype, n_tiles,
                                                n_slabs):
    from sblas_tpu_torch.experiments import stage_fuse_probe as sf
    g = torch.Generator(device=dev).manual_seed(n_tiles)
    shape = (n_tiles, 128, 128)
    x_slabs = torch.randn((n_slabs, 128, 128), generator=g, device=dev,
                          dtype=dtype)
    gslab = torch.randint(0, n_slabs, (n_tiles,), generator=g, device=dev,
                          dtype=torch.int32)
    gidx, i1 = (torch.randint(0, 128, shape, generator=g, device=dev,
                              dtype=torch.int32) for _ in range(2))
    gvals = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    before = sf.stage_fuse_gather.launches
    got = sf.stage_fuse_gather(gslab, x_slabs, gidx, gvals, i1)
    torch.cuda.synchronize()
    assert sf.stage_fuse_gather.launches == before + 1
    assert torch.equal(got, sf.stage_fuse_gather_plain(gslab, x_slabs, gidx,
                                                       gvals, i1))
    with pytest.raises(KernelError):
        sf.stage_fuse_gather(gslab, x_slabs, gidx, gvals, i1.long())
    with pytest.raises(ShapeError):
        sf.stage_fuse_gather(gslab, x_slabs, gidx, gvals, i1[:, :64])


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
    troute.lane_shuffle.launches = tr.slab_gather.launches = 0
    g = solvers.pagerank(plan, n, dangling=dang, tol=1e-7, maxiter=200,
                         graph=True, chunk=16)
    # the warm-up step and the 16 captured iterations call the wrappers;
    # the replays run on the card alone
    assert tr.slab_gather.launches == 17
    assert troute.lane_shuffle.launches == 17 * plan.n_route_gathers
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
    troute.lane_shuffle.launches = tr.slab_gather.launches = 0
    again = solvers.pagerank(plan, n, dangling=dang, tol=1e-7, maxiter=200)
    assert solvers.captures() == 1
    assert troute.lane_shuffle.launches == tr.slab_gather.launches == 0
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
    from sblas_tpu_torch.memory import host as thost
    real = thost.trace_scope
    side = hp.copy_stream() if hp is not None else None

    @contextlib.contextmanager
    def slow(name, device=None):
        if name.endswith(delay):
            stream = (side if delay == "copy"
                      else torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                torch.cuda._sleep(cycles)
        with real(name, device):
            yield

    monkeypatch.setattr(thost, "trace_scope", slow)


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

BF16 = torch.bfloat16


def _ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-element distance in bf16 ulps (ordered bit patterns)."""
    def key(t):
        b = t.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)
    return (key(got) - key(want)).abs()


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("rows", [1, 37, 32768])
def test_lane_shuffle_bf16_kernel_matches_plain(dev, idx_dtype, rows):
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn((rows, 128), generator=g, device=dev).to(BF16)
    idx = torch.randint(0, 128, (rows, 128), generator=g, device=dev,
                        dtype=torch.int32).to(idx_dtype)
    before = troute.lane_shuffle.launches
    got = troute.lane_shuffle(x, idx)
    torch.cuda.synchronize()
    assert troute.lane_shuffle.launches == before + 1
    assert torch.equal(got, troute.lane_shuffle_plain(x, idx))


def test_lane_shuffle_refuses_int16_with_wide_values(dev):
    x = torch.zeros((4, 128), device=dev)
    idx = torch.zeros((4, 128), device=dev, dtype=torch.int16)
    with pytest.raises(KernelError):
        troute.lane_shuffle(x, idx)


@pytest.mark.parametrize("variant", ["f32_bf16", "bf16"])
@pytest.mark.parametrize("n_tiles,n_slabs", [(1, 1), (5, 3), (188, 62)])
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
    before = (tr.slab_gather.launches, tr.tile_gather.launches)
    got = tr.slab_gather(gslab, x_slabs, gidx, gvals, BF16)
    tiles = torch.index_select(x_slabs, 0, gslab)
    got_t = tr.tile_gather(tiles, gidx, gvals, BF16)
    torch.cuda.synchronize()
    assert (tr.slab_gather.launches, tr.tile_gather.launches) == (
        before[0] + 1, before[1] + 1)
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


@pytest.mark.parametrize("n,half_band,k", [(700, 9, 17), (3000, 36, 256),
                                           (20_000, 36, 300)])
def test_bell_spmm_bf16_kernel_within_one_ulp(dev, n, half_band, k):
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops import bsr_pallas as tb
    from sblas_tpu_torch.ops.bsr import BsrPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    A = fem_banded_like(n=n, half_band=half_band)
    plan = BsrPlan.from_csr(A, dtype=BF16, device=dev)
    g = torch.Generator(device=dev).manual_seed(n)
    B = torch.rand((n, k), generator=g, device=dev).to(BF16)
    C = torch.rand((n, k), generator=g, device=dev).to(BF16)
    args = (plan.vals, plan.bcol, B, C, 3.0, 4.0)
    got, again = tb.bell_spmm(*args), tb.bell_spmm(*args)
    torch.cuda.synchronize()
    assert got.dtype == BF16 and torch.equal(got, again)
    assert int(_ulps(got, tb.bell_spmm_plain(*args)).max()) <= 1


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
    troute.lane_shuffle.launches = tr.slab_gather.launches = 0
    got = spmv(on_card, x.to(dev), 3.0, 4.0, y.to(dev)).cpu()
    assert troute.lane_shuffle.launches == plan.n_route_gathers
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
