"""Port parity: `sblas_tpu_torch.scaling` against `sblas_tpu.scaling`
(mirrors tests/test_scaling.py).

Both packages get the same arguments, with `ici_bw` / `dcn_bw` passed
explicitly (their defaults differ: the port's link constant was measured
on H100s, the JAX package's is a TPU model value), and must agree on
every projection and line; the xfoot mode is priced from the port's own
`XFootStats` in both.  The scorecard's title and parameter line are the
port's own (no TPU named).  `measured_multichip` runs in a gloo group of
one."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import sblas_tpu.scaling as js
import sblas_tpu_torch.scaling as ts
from sblas_tpu.io import generate as jgen
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.parallel import make_mesh, xfoot_stats

BW = 3e11    # bytes/s, passed to both packages
DCN = 4e10


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


def _same(p, q):
    assert dataclasses.astuple(p) == dataclasses.astuple(q)


def test_collective_bytes_ring_formulas():
    S = 1000
    assert ts.collective_bytes("mode1", S, 8) == 0.0
    assert ts.collective_bytes("mode2_psum", S, 8) == pytest.approx(1750.0)
    assert ts.collective_bytes("mode2_psum_scatter", S, 8) == \
        pytest.approx(875.0)
    assert ts.collective_bytes("halo", S, 8, halo_bytes=64) == 128.0
    assert ts.collective_bytes("mode2_psum", S, 1) == 0.0
    for mode in ("mode1", "mode2_psum", "mode2_psum_scatter", "halo",
                 "xfoot"):
        for n in (1, 2, 4, 16):
            assert ts.collective_bytes(mode, S, n, 64, 321.0) == \
                js.collective_bytes(mode, S, n, 64, 321.0)
    with pytest.raises(ValueError, match="unknown mode"):
        ts.collective_bytes("ring", S, 4)


def test_projection_monotonicity():
    """More comm -> lower efficiency; mode1 is always linear."""
    t1, S = 1.0, 10_000_000
    ps = [ts.project(m, t1, S, 16, ici_bw=BW)
          for m in ("mode1", "mode2_psum", "mode2_psum_scatter")]
    assert ps[0].efficiency == pytest.approx(1.0)
    assert ps[2].efficiency > ps[1].efficiency
    assert ts.best_mode(ps).mode == "mode1"
    for p in ps:
        _same(p, js.project(p.mode, t1, S, 16, ici_bw=BW))
    _same(ts.best_mode(ps[1:]), js.best_mode(
        [js.project(p.mode, t1, S, 16, ici_bw=BW) for p in ps[1:]]))


def test_efficiency_definition():
    p = ts.project("mode1", 2.0, 123, 4, ici_bw=BW)
    assert p.t_n_ms == pytest.approx(0.5)
    assert p.efficiency == pytest.approx(1.0)
    t1, n, bw = 1.0, 4, 1e9
    S = 0.25 * bw / 1e3 * n / (2 * (n - 1))
    p = ts.project("mode2_psum", t1, S, n, ici_bw=bw)
    assert p.efficiency == pytest.approx(0.5, rel=1e-6)
    _same(p, js.project("mode2_psum", t1, S, n, ici_bw=bw))
    _same(ts.project("halo", 1.0, S, n, halo_bytes=4096, ici_bw=bw,
                     shard_ms=0.4),
          js.project("halo", 1.0, S, n, halo_bytes=4096, ici_bw=bw,
                     shard_ms=0.4))


def test_report_flags_80pct_target():
    lines = ts.report_lines("spmv", 1.0, 1_000_000, 1, 4, chips=(16,),
                            ici_bw=BW)
    assert any("meets 80% target" in ln or "MISSES 80% target" in ln
               for ln in lines)
    assert lines == js.report_lines("spmv", 1.0, 1_000_000, 1, 4,
                                    chips=(16,), ici_bw=BW)
    lines = ts.report_lines("spmm", 0.1, 10_000_000, 64, 4, chips=(16,),
                            ici_bw=BW)
    assert "mode1 100%" in "\n".join(lines)
    assert lines == js.report_lines("spmm", 0.1, 10_000_000, 64, 4,
                                    chips=(16,), ici_bw=BW)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo group of one made through a FileStore, destroyed at
    teardown."""
    store = tmp_path_factory.mktemp("store") / "s"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_measured_multichip_runs_per_device_count(world1):
    """One reading per device count up to the world (here 1), on its own
    sub-group, finite and positive; counts above the world stop it."""
    A = _port(jgen.fem_banded_like(n=512, half_band=4, dtype=np.float64))
    rows = ts.measured_multichip("spmv", A, 1, torch.float64, (1, 2, 4),
                                 device="cpu")
    assert [n for n, _ in rows] == [1]
    assert all(np.isfinite(ms) and ms > 0 for _, ms in rows)
    rows_mm = ts.measured_multichip("spmm", A, 8, torch.float64, (1,),
                                    device="cpu", kind="dia")
    assert len(rows_mm) == 1 and rows_mm[0][1] > 0


def test_measured_multichip_needs_a_group(monkeypatch):
    from sblas_tpu_torch.utils.errors import PartitionError
    A = _port(jgen.fem_banded_like(n=256, half_band=4, dtype=np.float64))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(PartitionError, match="process group"):
        ts.measured_multichip("spmv", A, 1, torch.float64, (1,),
                              device="cpu")


@pytest.fixture(scope="module")
def web20k():
    return jgen.webbase_like(n=20_000, avg_deg=3.0, seed=3,
                             local_scale=200.0, dtype=np.float64)


def test_xfoot_mode_priced_from_stats(web20k):
    A = web20k
    st = xfoot_stats(_port(A), 8)
    p = ts.project("xfoot", 1.0, A.shape[0] * 4, 8, xfoot_stats=st,
                   itemsize=4, ici_bw=BW)
    full = ts.project("mode2_psum", 1.0, A.shape[0] * 4, 8, ici_bw=BW)
    assert 0 < p.comm_ms < full.comm_ms
    _same(p, js.project("xfoot", 1.0, A.shape[0] * 4, 8, xfoot_stats=st,
                        itemsize=4, ici_bw=BW))


def test_project_table_matches_report_lines():
    table = ts.project_table("spmm", 1.0, 100_000, 64, 4, halo_rows=500,
                             chips=(4, 16), ici_bw=BW)
    assert sorted(table) == [4, 16]
    jtable = js.project_table("spmm", 1.0, 100_000, 64, 4, halo_rows=500,
                              chips=(4, 16), ici_bw=BW)
    for n in table:
        for p, q in zip(table[n], jtable[n], strict=True):
            _same(p, q)
    via_table = ts.report_lines("spmm", 1.0, 100_000, 64, 4, halo_rows=500,
                                chips=(4, 16), ici_bw=BW, table=table)
    recomputed = ts.report_lines("spmm", 1.0, 100_000, 64, 4,
                                 halo_rows=500, chips=(4, 16), ici_bw=BW)
    assert via_table == recomputed


def test_scorecard_format():
    t_good = ts.project_table("spmm", 1.0, 1000, 64, 4, chips=(4, 16),
                              ici_bw=BW)
    t_bad = ts.project_table("spmv", 0.01, 50_000_000, 1, 4, chips=(4, 16),
                             ici_bw=BW)
    rows = [("spmm shell K=64", t_good, None, ""),
            ("spmv webbase-1M", t_bad, (4, 0.96), "weak regime note")]
    lines = ts.scorecard_lines(rows)
    assert all(ln.startswith("#") for ln in lines)
    assert "BASELINE scorecard" in lines[0] and "80%" in lines[0]
    assert "1 card → 16 cards" in lines[0] and "v5e" not in lines[0]
    params = lines[1]
    assert params.startswith("# params:")
    for tok in ("ici_bw=", "dcn_bw=", "gather_ns=", "route_ns="):
        assert tok in params, params
    assert "measured" in params and "not measured" in params
    header = lines[2]
    assert "strong n=4" in header and "strong n=16" in header
    assert "weak" in header and "verdict" in header
    row_good = next(ln for ln in lines if "spmm shell K=64" in ln)
    assert "meets" in row_good and "mode1" in row_good
    row_bad = next(ln for ln in lines if "spmv webbase-1M" in ln)
    assert "MISSES" in row_bad and "96% @n=4" in row_bad
    assert "weak meets" in row_bad
    assert lines[lines.index(row_bad) + 1].startswith("#   ^ weak regime")
    assert lines[-1] == "# ====="
    jrows = [(w, js.project_table(*a, chips=(4, 16), ici_bw=BW), wk, nt)
             for (w, _, wk, nt), a in zip(rows, [
                 ("spmm", 1.0, 1000, 64, 4),
                 ("spmv", 0.01, 50_000_000, 1, 4)])]
    # the rows agree with the JAX package's; the title and the parameter
    # line are the port's own
    assert lines[2:] == js.scorecard_lines(jrows)[2:]


def test_scorecard_flags_weak_miss():
    t = ts.project_table("spmv", 1.0, 1000, 1, 4, chips=(4,), ici_bw=BW)
    lines = ts.scorecard_lines([("wl-miss", t, (4, 0.5), "")])
    row = next(ln for ln in lines if ln.startswith("# wl-miss"))
    assert "weak" in row and "MISSES" in row and "weak meets" not in row


def test_report_lines_include_xfoot_with_measured_shard(web20k):
    xf = {8: xfoot_stats(_port(web20k), 8)}
    lines = ts.report_lines("spmv", 1.0, web20k.shape[0], 1, 4, chips=(8,),
                            xfoot=xf, xfoot_shard_ms={8: 0.1}, ici_bw=BW)
    joined = "\n".join(lines)
    assert "xfoot" in joined and "best" in joined
    assert lines == js.report_lines("spmv", 1.0, web20k.shape[0], 1, 4,
                                    chips=(8,), xfoot=xf,
                                    xfoot_shard_ms={8: 0.1}, ici_bw=BW)


@pytest.mark.parametrize("s,c", [(1, 4), (2, 4), (4, 4), (4, 1)])
def test_two_tier_projections_match_jax(s, c):
    rb = 90_449 * 64 * 4
    _same(ts.project_hier(2.9, rb, s, c, ici_bw=BW, dcn_bw=DCN),
          js.project_hier(2.9, rb, s, c, ici_bw=BW, dcn_bw=DCN))
    _same(ts.project_hier(2.9, rb, s, c, ici_bw=BW, dcn_bw=DCN,
                          shard_ms=0.5),
          js.project_hier(2.9, rb, s, c, ici_bw=BW, dcn_bw=DCN,
                          shard_ms=0.5))
    _same(ts.project_flat_over_dcn(2.9, rb, s, c, dcn_bw=DCN),
          js.project_flat_over_dcn(2.9, rb, s, c, dcn_bw=DCN))


def test_link_constants_are_the_cards_own(monkeypatch):
    """No TPU constant in the port: the link and extraction constants
    differ from the JAX package's, say where they come from, and the
    environment overrides them."""
    assert ts.ICI_BW_DEFAULT != js.ICI_BW_DEFAULT
    assert ts.GATHER_NS != 2.3 and ts.ROUTE_NS != 0.09
    assert "H100" in ts.ICI_BW_SRC and "not measured" in ts.DCN_BW_SRC
    assert "v5e" not in ts.param_provenance()
    monkeypatch.setenv("SBLAS_ICI_BW", "1e11")
    assert ts._const("SBLAS_ICI_BW", 5.0, "x") == (1e11, "env SBLAS_ICI_BW")
