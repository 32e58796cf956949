"""Kernel K3's work tables (`sblas_tpu_torch.ops.wcoo.k3_tables`) on the
CPU: every real slot in exactly one unit, every row of the padded grid
with exactly one owner, the tables the port derives from the JAX
package's plan arrays equal to its own, and a numpy run of the kernel's
two-pass schedule (unit partials, then the carry combine) against
`window_reduce_plain`.

The schedule run follows csrc/wcoo_kernels.cu step by step: each unit
sums its rows in slot order, stores the rows wholly inside it, and puts
a first row that continues from the unit before in carry 0 and a last row
that continues into the next unit in carry 1; the second pass writes
every `k3_rows` entry.  f64 agrees with the plain version's `index_add_`
to 1e-12 (another summation order); f32 to 1e-6 normwise."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sblas_tpu.containers import CooMatrix as JCooMatrix
from sblas_tpu.io import generate as jgen
from sblas_tpu.ops import wcoo as jw
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.ops import wcoo as tw
from sblas_tpu_torch.utils.errors import PlanError

_FIELDS = ("xblk", "lane", "vals", "relrow", "half_ids", "wb", "visit0",
           "visit1")


def _csr(lengths, gaps=None, n=3000, seed=0):
    """A CSR matrix whose rows hold `lengths` entries, row i after
    `gaps[i]` empty rows, with values in [1, 2) (never 0)."""
    rng = np.random.RandomState(seed)
    gaps = np.zeros(len(lengths), np.int64) if gaps is None else gaps
    rows = np.cumsum(np.asarray(gaps) + 1) - 1
    m = int(rows[-1]) + 1 if len(rows) else 1
    row_idx = np.repeat(rows, lengths).astype(np.int64)
    col_idx = rng.randint(0, n, size=row_idx.size).astype(np.int64)
    vals = 1.0 + rng.random_sample(row_idx.size)
    return JCooMatrix(row_idx, col_idx, vals, (m, n)).to_csr()


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


def _owners(plan):
    """(n_row_blocks*128,) count of owners of each row, and the real
    slots each unit covers, from the tables alone."""
    units = plan.k3_units.numpy()
    rows_t = plan.k3_rows.numpy()
    row_of = (plan.wb.numpy().astype(np.int64)[:, None] * 128
              + plan.relrow.numpy()).reshape(-1)
    owners = np.zeros(plan.n_row_blocks * 128, np.int64)
    covered = []
    for start, info in units:
        n = info & 0xffff
        rows = row_of[start:start + n]
        covered.append(np.arange(start, start + n))
        inner = set(np.unique(rows).tolist())
        if info & tw._LEFT:
            inner.discard(int(rows[0]))
        if info & tw._RIGHT:
            inner.discard(int(rows[-1]))
        owners[list(inner)] += 1
    np.add.at(owners, rows_t[:, 0], 1)
    return owners, (np.concatenate(covered) if covered
                    else np.zeros(0, np.int64))


def _assert_tables(plan, unit=tw.UNIT):
    vals = plan.vals.numpy()
    owners, covered = _owners(plan)
    # every real slot (value != 0 here) lies in exactly one unit
    assert np.array_equal(np.sort(covered), np.flatnonzero(vals != 0))
    assert len(np.unique(covered)) == len(covered)
    units = plan.k3_units.numpy()
    assert np.all((units[:, 1] & 0xffff) <= unit)
    assert np.all(units[:, 0] // tw.TILE ==
                  (units[:, 0] + (units[:, 1] & 0xffff) - 1) // tw.TILE)
    # every row of the padded grid: exactly one owner
    assert np.all(owners == 1)
    # k3_rows: a boundary row spans exactly units u0..u1; an empty row
    # has no slot
    row_of = (plan.wb.numpy().astype(np.int64)[:, None] * 128
              + plan.relrow.numpy()).reshape(-1)
    real_rows = set(row_of[vals != 0].tolist())
    for row, u0, u1 in plan.k3_rows.numpy():
        if u0 < u1:
            spans = [u for u, (s, info) in enumerate(units)
                     if row in row_of[s:s + (info & 0xffff)]]
            assert spans == list(range(u0, u1 + 1))
        else:
            assert (u0, u1) == (0, -1) and row not in real_rows


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.tuples(
    st.sampled_from([0, 0, 0, 1, 300]),                  # empty rows before
    st.one_of(st.just(0), st.integers(1, 6),
              st.sampled_from([127, 128, 255, 256, 257, 512]),
              st.integers(3 * 512 + 1, 3 * 512 + 400))),  # > three tiles
    min_size=1, max_size=24), st.integers(0, 3), st.integers(0, 99))
def test_k3_tables_cover_slots_and_rows(rows, pad_tiles, seed):
    """Row-length mixes: empty rows, rows of a unit's length and of more
    than three tiles, gaps that split tiles, `min_tiles` pad tiles, and
    matrices whose real slots fit in one unit."""
    A = _csr([n for _, n in rows], [g for g, _ in rows], seed=seed)
    min_tiles = jw.wcoo_tile_count(A) + pad_tiles if pad_tiles else 0
    plan = tw.WcooPlan.from_csr(_port(A), dtype=torch.float64,
                                min_tiles=min_tiles, device="cpu")
    _assert_tables(plan)


@pytest.mark.parametrize("unit", [128, 256, 512])
def test_k3_tables_at_each_unit_size(unit):
    """Row ends exactly on unit boundaries, one row over a dozen units."""
    A = _csr([unit, unit, 1, 2 * unit - 1, 6 * unit + 3, 0, unit + 1])
    plan = tw.WcooPlan.from_csr(_port(A), dtype=torch.float64, device="cpu")
    tabs = tw.k3_tables(*(getattr(plan, k).numpy() for k in
                          ("wb", "relrow", "vals", "xblk", "lane")),
                        plan.n_row_blocks, unit=unit)
    plan = tw.WcooPlan.from_numpy(
        dict({k: getattr(plan, k).numpy() for k in _FIELDS}, **tabs),
        dict(shape=plan.shape, nnz=plan.nnz, n_tiles=plan.n_tiles,
             n_row_blocks=plan.n_row_blocks), "cpu")
    _assert_tables(plan, unit)
    assert plan.k3_units.shape[0] == sum(-(-c // unit) for c in (
        np.count_nonzero(plan.vals.numpy().reshape(-1, tw.TILE), axis=1)))


@pytest.mark.parametrize("dtype,unit", [(torch.float64, 128),
                                        (torch.float32, 128),
                                        (torch.bfloat16, 64)])
def test_plan_tables_at_their_value_types_unit(dtype, unit):
    """A plan's K3 tables are cut at `k3_unit` of its value type: 64
    slots for bf16 (the `bf16` variant walks a unit with 8 lanes), 128
    else; the same tables `k3_tables` gives at that unit."""
    A = _csr([200, 3, 65, 64, 1, 130, 0, 7])
    plan = tw.WcooPlan.from_csr(_port(A), dtype=dtype, device="cpu")
    assert tw.k3_unit(dtype) == unit
    tabs = tw.k3_tables(*(getattr(plan, k).float().numpy() if k == "vals"
                          else getattr(plan, k).numpy() for k in
                          ("wb", "relrow", "vals", "xblk", "lane")),
                        plan.n_row_blocks, unit=unit)
    assert np.array_equal(plan.k3_units.numpy(), tabs["k3_units"])
    assert np.array_equal(plan.k3_rows.numpy(), tabs["k3_rows"])
    _assert_tables(dataclasses.replace(plan, vals=plan.vals.double()), unit)


def test_k3_tables_of_an_empty_matrix():
    A = CsrMatrix(np.zeros(11, np.int64), np.zeros(0, np.int64),
                  np.zeros(0), (10, 10))
    plan = tw.WcooPlan.from_csr(A, dtype=torch.float64, device="cpu")
    assert plan.k3_units.shape == (0, 2)
    assert plan.k3_rows.shape == (plan.n_row_blocks * 128, 3)
    _assert_tables(plan)


def test_k3_tables_refuse_unsorted_slots():
    plan = tw.WcooPlan.from_csr(_port(_csr([3, 4])), dtype=torch.float64,
                                device="cpu")
    relrow = plan.relrow.numpy().copy()
    relrow[0, :2] = relrow[0, :2][::-1] + [0, 1]
    with pytest.raises(PlanError, match="row order"):
        tw.k3_tables(plan.wb.numpy(), relrow, plan.vals.numpy(),
                     plan.xblk.numpy(), plan.lane.numpy(), plan.n_row_blocks)


MATRICES = {
    "web": lambda: jgen.webbase_like(n=3000, avg_deg=3.0),
    "skew": lambda: jgen.adversarial_skew(m=256, n=200, heavy_rows=2,
                                          heavy_nnz=300, light_nnz=1),
    "long_row": lambda: _csr([3, 2000, 0, 5, 1700, 256, 1], [0, 2, 0, 0, 0,
                                                             0, 400]),
    "one_unit": lambda: _csr([2, 0, 7, 1]),
}


@functools.lru_cache(maxsize=None)
def _plans(name, min_tiles):
    A = MATRICES[name]()
    extra = jw.wcoo_tile_count(A) + min_tiles if min_tiles else 0
    return (jw.WcooPlan.from_csr(A, dtype=jnp.float64, min_tiles=extra),
            tw.WcooPlan.from_csr(_port(A), dtype=torch.float64,
                                 min_tiles=extra, device="cpu"))


@pytest.mark.parametrize("min_tiles", [0, 3])
@pytest.mark.parametrize("name", list(MATRICES))
def test_tables_from_jax_arrays_equal_from_csr(name, min_tiles):
    jp, tp = _plans(name, min_tiles)
    fields = {f: np.asarray(getattr(jp, f)) for f in _FIELDS}
    meta = dict(shape=jp.shape, nnz=jp.nnz, n_tiles=jp.n_tiles,
                n_row_blocks=jp.n_row_blocks)
    back = tw.WcooPlan.from_numpy(fields, meta, "cpu")
    for f in tw.WcooPlan.PORT_FIELDS:
        assert torch.equal(getattr(back, f), getattr(tp, f)), f
    _assert_tables(back)


def _two_pass(plan, B, k0, width, dtype):
    """csrc/wcoo_kernels.cu's schedule in numpy, in `dtype`."""
    units, rows_t = plan.k3_units.numpy(), plan.k3_rows.numpy()
    row_of = (plan.wb.numpy().astype(np.int64)[:, None] * 128
              + plan.relrow.numpy()).reshape(-1)
    vals = plan.vals.numpy().astype(dtype)
    cols = plan.xblk.numpy() * 128 + plan.lane.numpy()
    Bc = np.ascontiguousarray(B[:, k0:k0 + width], dtype=dtype)
    out = np.full((plan.n_row_blocks * 128, width), np.nan, dtype)
    carry = np.full((len(units), 2, width), np.nan, dtype)
    for u, (start, info) in enumerate(units):
        n = info & 0xffff
        rows = row_of[start:start + n]
        cuts = np.flatnonzero(np.diff(rows)) + 1
        runs = np.split(np.arange(start, start + n), cuts)
        for j, run in enumerate(runs):
            acc = np.zeros(width, dtype)
            for e in run:                      # slot order, as a lane sums
                acc = acc + vals[e] * Bc[cols[e]]
            if j == 0 and info & tw._LEFT:
                carry[u, 0] = acc
            elif j == len(runs) - 1 and info & tw._RIGHT:
                carry[u, 1] = acc
            else:
                assert np.isnan(out[row_of[run[0]]]).all()
                out[row_of[run[0]]] = acc
    for row, u0, u1 in rows_t:
        assert np.isnan(out[row]).all()
        acc = np.zeros(width, dtype)
        if u0 < u1:
            acc = carry[u0, 1]
            for v in range(u0 + 1, u1 + 1):
                acc = acc + carry[v, 0]
        out[row] = acc
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("min_tiles", [0, 3])
@pytest.mark.parametrize("name", list(MATRICES))
def test_two_pass_schedule_matches_plain(name, min_tiles, dtype):
    _, tp = _plans(name, min_tiles)
    B = np.random.RandomState(7).rand(tp.shape[1], 20)
    k0, width = 3, 13
    got = _two_pass(tp, B, k0, width, dtype)
    tt = torch.float64 if dtype == np.float64 else torch.float32
    want = tw.window_reduce_plain(
        tp.k3, tp.wb, tp.relrow, tp.vals.to(tt), tp.xblk, tp.lane,
        torch.from_numpy(B).to(tt), k0, width).double().numpy()
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-6, rel
