"""The route executor's schedule pass (`route.route_steps`): which
`view_transpose` layers kernel K1 stores in place of a copy on CUDA.

On the CPU `apply_route` pairs nothing and the transposed store's
wrapper launches nothing.  The fused steps are run here with K1's plain
mirror in the wrapper's place (one `torch.gather`, then the permute) and
held to `apply_route_np`; the CUDA kernel itself is held to the same
mirror bitwise in tests/test_torch_kernels_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

from sblas_tpu_torch.ops import route as troute
from sblas_tpu_torch.utils import trace
from sblas_tpu_torch.utils.errors import KernelError

LANES = troute.LANES
RADII = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32, 64, 128)
# every routable size from 128 to 128^3 * 8
ROUTABLE = sorted({LANES ** k * r for k in (1, 2, 3) for r in RADII
                   if LANES ** k * r <= LANES ** 3 * 8})
# built with `build_route` here (all of them: about 2 s); the larger ones
# (4M to 16.7M elements, a minute of edge colouring) take the schedule of
# `_schedule_of`, which these sizes hold to `build_route`
BUILT = [n for n in ROUTABLE if n <= LANES ** 3]


def _schedule_of(N: int) -> tuple:
    """The schedule `build_route` gives a routable N: it depends on N
    alone (gather, transpose, the level below, transpose, gather; a mix
    chain once a block has 8 rows or fewer)."""
    if N <= LANES:
        return (("gather", 1),)
    R = N // LANES
    ops = []

    def rec(bs):
        if bs <= LANES:
            ops.append(("gather", R))
            return
        A = bs // LANES
        ops.append(("gather", R))
        if A <= 8:
            ops.extend([("mix", A), ("gather", R)])
            return
        nb = N // bs
        ops.append(("view_transpose", (nb, A, LANES), (0, 2, 1)))
        rec(A)
        ops.append(("view_transpose", (nb, LANES, A), (0, 2, 1)))
        ops.append(("gather", R))

    rec(N)
    return tuple(ops)


@functools.lru_cache(maxsize=None)
def _prog(n: int):
    """A route of a seeded random permutation of n, and the permutation."""
    perm = np.random.RandomState(n).permutation(n)
    return perm, troute.build_route(perm)


def _identity_schedule(N: int) -> tuple:
    return troute.build_route(np.arange(N, dtype=np.int32)).schedule


def test_routable_sizes_are_routable():
    assert all(troute.routable_size(n) == n for n in ROUTABLE)
    assert len(ROUTABLE) == 30 and ROUTABLE[-1] == LANES ** 3 * 8


@pytest.mark.parametrize("N", BUILT)
def test_schedule_mirror_matches_build_route(N):
    assert _schedule_of(N) == _identity_schedule(N)


@pytest.mark.parametrize("N", ROUTABLE)
def test_route_steps_pair_every_transpose(N):
    """Fused, each transpose goes into the K1 launch of the gather just
    before it; unfused, each is a copy, and nothing else changes."""
    sched = _schedule_of(N)
    n_vt = sum(op[0] == "view_transpose" for op in sched)
    fused = troute.route_steps(sched, True)
    plain = troute.route_steps(sched, False)
    kinds = [op[0] for op in fused]
    assert kinds.count("gather_t") == n_vt
    assert "view_transpose" not in kinds
    assert [op[0] for op in plain] == [op[0] for op in sched]
    # every pair is a gather directly followed by its transpose
    i = 0
    for op in fused:
        if op[0] == "gather_t":
            assert sched[i][0] == "gather"
            assert sched[i + 1][0] == "view_transpose"
            assert op[2] == sched[i + 1][1]
            i += 2
        else:
            assert op[0] == sched[i][0]
            i += 1
    assert i == len(sched)
    # tables are indexed in schedule order, one per gather or mix
    n_tables = sum(op[0] in ("gather", "mix") for op in sched)
    assert [op[1] for op in fused if op[0] != "view_transpose"] == list(
        range(n_tables))
    assert [op[1] for op in plain if op[0] != "view_transpose"] == list(
        range(n_tables))


def test_route_steps_depend_on_the_schedule_alone():
    """Two permutations of one size give one schedule, and the pass
    returns the same steps for it (computed once)."""
    n = 40_000
    a = troute.build_route(np.random.RandomState(1).permutation(n))
    b = troute.build_route(np.random.RandomState(2).permutation(n))
    assert a.schedule == b.schedule
    assert troute.route_steps(a.schedule, True) is troute.route_steps(
        b.schedule, True)
    # a schedule as the plan cache loads it (a fresh equal tuple)
    again = tuple(tuple(op) for op in a.schedule)
    assert troute.route_steps(again, True) == troute.route_steps(
        a.schedule, True)


def test_route_steps_keep_copies_the_tile_cannot_cover():
    """A transpose with no gather before it (the stage-fuse probe's route
    after its first layer), one after a mix, and shapes the tile does not
    cover stay copies."""
    sched = _schedule_of(LANES ** 2 * 64)
    tail = troute.route_steps(sched[1:], True)
    assert tail[0] == sched[1]
    assert sum(op[0] == "gather_t" for op in tail) == 3
    odd = (("gather", 6), ("view_transpose", (1, 8, 96), (0, 2, 1)),
           ("gather", 6), ("view_transpose", (2, 48, 8), (0, 2, 1)),
           ("gather", 6), ("mix", 2),
           ("view_transpose", (1, 48, 16), (0, 2, 1)),
           ("gather", 6), ("view_transpose", (1, 3, 16, 16), (0, 1, 3, 2)))
    steps = troute.route_steps(odd, True)
    assert [op[0] for op in steps] == [
        "gather", "view_transpose", "gather", "view_transpose", "gather",
        "mix", "view_transpose", "gather", "view_transpose"]


@pytest.mark.parametrize("shape,ok", [
    ((1, 32768, 128), True), ((128, 256, 128), True),
    ((128, 128, 256), True), ((1, 128, 32768), True),
    ((1, 8192, 128), True), ((128, 64, 128), True), ((128, 128, 64), True),
    ((1, 128, 8192), True), ((128, 128, 16), True), ((128, 16, 128), True),
    ((3, 384, 128), True), ((1, 128, 640), True),
    ((1, 8, 128), False), ((1, 128, 8), False), ((1, 128, 48), False),
    ((1, 24, 128), False), ((1, 128, 96), False), ((2, 0, 128), False)])
def test_transposable(shape, ok):
    assert troute.transposable(shape, (0, 2, 1)) is ok
    assert not troute.transposable(shape, (0, 1, 2))


# 300 -> 384 (a mix layer, no transpose); 16384 -> A = 128; 40000 ->
# 49152 = 128^2 * 3 (a non-power-of-two radius, a mix level inside);
# 81920 = 128^2 * 5; 262144 -> two transpose levels; 1048576 -> (128,
# 64, 128) and (128, 128, 64), the cell's x relabel
FUSED_SIZES = [300, 16384, 40000, 81920, 262144, 1_000_000]


@pytest.mark.parametrize("n", FUSED_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_fused_steps_mirror_matches_numpy(n, dtype, monkeypatch):
    """The fused steps with K1's plain mirror (`torch.gather`, then the
    permute) give `apply_route_np`'s answer, bitwise, in every value type
    and with int16 tables under bf16 (the transport's)."""
    monkeypatch.setattr(troute, "lane_shuffle_transposed",
                        troute.lane_shuffle_transposed_plain)
    perm, prog = _prog(n)
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(n)
                         ).to(dtype)
    x_pad = torch.nn.functional.pad(x, (0, prog.n - n))
    tables = troute.route_tables(
        prog, "cpu", np.int16 if dtype == torch.bfloat16 else np.int32)
    steps = troute.route_steps(prog.schedule, True)
    with trace.recording() as rec:
        got = troute.execute_steps(steps, x_pad, tables)
    n_vt = sum(op[0] == "view_transpose" for op in prog.ops)
    assert rec.counters.get("route_transposes_fused", 0) == n_vt
    assert rec.counters.get("route_transpose_copies", 0) == 0
    # numpy has no bf16: its values go through float32, exactly
    wide = torch.float32 if dtype == torch.bfloat16 else dtype
    want = troute.apply_route_np(prog, x.to(wide).numpy())
    assert torch.equal(got[:n], x[perm])
    assert np.array_equal(got[:n].to(wide).numpy(), want)


@pytest.mark.parametrize("n", [300, 40000, 262144])
def test_cpu_routes_run_unchanged_and_fuse_nothing(n):
    """On the CPU `apply_route` keeps every transpose a copy: the answer
    is the numpy mirror's, and the counters read copies only."""
    perm, prog = _prog(n)
    x = np.random.RandomState(2).standard_normal(n).astype(np.float32)
    x_pad = torch.from_numpy(np.pad(x, (0, prog.n - n)))
    before = (troute.lane_shuffle.launches,
              troute.lane_shuffle_transposed.launches)
    with trace.recording() as rec:
        got = troute.apply_route(prog.schedule, x_pad,
                                 troute.route_tables(prog, "cpu"))
    n_vt = sum(op[0] == "view_transpose" for op in prog.ops)
    assert "route_transposes_fused" not in rec.counters
    assert rec.counters.get("route_transpose_copies", 0) == n_vt
    assert (troute.lane_shuffle.launches,
            troute.lane_shuffle_transposed.launches) == before
    assert np.array_equal(got.numpy()[:n], troute.apply_route_np(prog, x))
    assert np.array_equal(got.numpy()[:n], x[perm])


@pytest.mark.parametrize("shape", [(1, 64, 128), (2, 128, 32),
                                   (4, 16, 128)])
def test_transposed_plain_is_gather_then_permute(shape):
    nb, P, Q = shape
    rows = nb * P * Q // LANES
    g = torch.Generator().manual_seed(rows)
    x = torch.randn((rows, LANES), generator=g)
    idx = torch.randint(0, LANES, (rows, LANES), generator=g,
                        dtype=torch.int32)
    want = torch.gather(x, 1, idx).reshape(shape).permute(0, 2, 1)
    got = troute.lane_shuffle_transposed_plain(x, idx, shape)
    assert got.shape == (nb, Q, P) and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_lane_shuffle_transposed_refuses_other_devices(device):
    """The transposed store launches on CUDA alone: a CPU route never
    calls it (its transposes stay copies), and nothing counts."""
    x = torch.empty((16, 128), device=device)
    idx = torch.empty((16, 128), dtype=torch.int32, device=device)
    before = troute.lane_shuffle_transposed.launches
    with pytest.raises(KernelError):
        troute.lane_shuffle_transposed(x, idx, (1, 16, 128))
    assert troute.lane_shuffle_transposed.launches == before
