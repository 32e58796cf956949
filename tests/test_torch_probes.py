"""Port parity of the two experiment probes and their kernels.

* P1 (`stage_fuse_gather_plain`) bitwise against the JAX probe's
  `_fused_kernel` run through the `pallas_call` of
  experiments/stage_fuse_probe.py:74-92, in interpret mode;
* the port's `spmv_routed_fused1` against the JAX probe's on an xfoot
  worst shard of a small web graph;
* P2 (`window_lane_gather_plain`) bitwise against the `pallas_call` of
  experiments/wcoo_gather_probe.py:112-133, in interpret mode, and the
  column-window layout against the JAX probe's loop;
* both probes' `main(--device cpu)` in a toy world (a small web graph
  stands in for webbase-1M), whose host-side lines (shard geometry, tile
  counts, fills, window counts) equal the JAX probes'."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sblas_tpu.config import SBlasConfig as JConfig
from sblas_tpu.io import generate as jgen
from sblas_tpu.ops import rspmv as jr
from sblas_tpu.parallel import xfoot as jx
from sblas_tpu_torch.config import SBlasConfig as TConfig
from sblas_tpu_torch.containers import CsrMatrix, DenseVector
from sblas_tpu_torch.experiments import stage_fuse_probe as tsf
from sblas_tpu_torch.experiments import wcoo_gather_probe as twg
from sblas_tpu_torch.ops import rspmv as tr
from sblas_tpu_torch.parallel import xfoot as tx
from sblas_tpu_torch.tools import p1_variants
from sblas_tpu_torch.utils.errors import KernelError

LANES = 128
_EXP = os.path.join(os.path.dirname(__file__), "..", "experiments")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"exp_{name}", os.path.join(_EXP, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


# ---- P1: the slab gather fused with route pass 1 ----

def _jax_fused(gslab, x_slabs, gidx, gvals, i1):
    """The JAX probe's `_fused_kernel` with its `pallas_call`'s specs
    (stage_fuse_probe.py:74-92), in interpret mode."""
    T = gslab.shape[0]
    tile = pl.BlockSpec((1, LANES, LANES), lambda t, gs: (t, 0, 0))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(T,),
        in_specs=[pl.BlockSpec((1, LANES, LANES),
                               lambda t, gs: (gs[t], 0, 0)),
                  tile, tile, tile],
        out_specs=tile)
    return pl.pallas_call(
        _load("stage_fuse_probe")._fused_kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((T, LANES, LANES), x_slabs.dtype),
        interpret=True)(gslab, x_slabs, gidx, gvals, i1)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_tiles,n_slabs,dups", [
    pytest.param(1, 1, False, id="1-1"),
    pytest.param(3, 2, False, id="3-2"),
    pytest.param(3, 3, True, id="dups-3-3")])
def test_p1_plain_bitwise_equals_jax_kernel(np_dtype, n_tiles, n_slabs,
                                            dups):
    rng = np.random.RandomState(n_tiles)
    gslab = rng.randint(0, n_slabs, n_tiles).astype(np.int32)
    x_slabs = rng.standard_normal((n_slabs, LANES, LANES)).astype(np_dtype)
    gidx, i1 = (rng.randint(0, LANES, (n_tiles, LANES, LANES))
                .astype(np.int32) for _ in range(2))
    if dups:
        # slabs repeated and out of order; each row's i1 names 3 lanes
        gslab = np.array([2, 0, 2], np.int32)
        i1 = np.array([0, 127, 64], np.int32)[
            rng.randint(0, 3, (n_tiles, LANES, LANES))]
    gvals = rng.standard_normal((n_tiles, LANES, LANES)).astype(np_dtype)
    args = (gslab, x_slabs, gidx, gvals, i1)
    want = np.asarray(_jax_fused(*(jnp.asarray(a) for a in args)))
    before = tsf.stage_fuse_gather.launches
    got = tsf.stage_fuse_gather(*(torch.from_numpy(a) for a in args))
    assert tsf.stage_fuse_gather.launches == before   # the CPU's plain one
    assert got.dtype == torch.from_numpy(x_slabs).dtype
    assert np.array_equal(got.numpy(), want)


def test_p_wrappers_refuse_other_devices():
    t = torch.zeros((1, LANES, LANES), device="meta")
    with pytest.raises(KernelError):
        tsf.stage_fuse_gather(t[0, 0, :1].int(), t, t.int(), t, t.int())
    with pytest.raises(KernelError):
        twg.window_lane_gather(torch.zeros((LANES, 4), device="meta"),
                               t[0, 0, :1].int(), t[:, :1].int())


@pytest.fixture(scope="module")
def worst_shard():
    W = jgen.webbase_like(n=6000, avg_deg=3.0, seed=3, local_scale=60.0)
    local, sizes = jx.xfoot_worst_local(W, 4)
    return local, sizes


def test_spmv_routed_fused1_matches_jax(worst_shard):
    local, (tg, srs, prs, sks) = worst_shard
    mins = dict(min_gtiles=tg, min_srows=srs, min_prows=prs,
                min_sranks=sks)
    # a low peel threshold, so that the toy shard has peeled hub rows
    peel = dict(routed_peel_threshold=16)
    jp = jr.RoutedPlan.from_csr(local, dtype=jnp.float64,
                                config=JConfig(**peel), **mins)
    tp = tr.RoutedPlan.from_csr(_port(local), dtype=torch.float64,
                                config=TConfig(**peel), device="cpu", **mins)
    assert tp.schedule[0][0] == "gather" and tp.n_prows > 0
    x = DenseVector.random(local.shape[1]).values
    y = np.random.RandomState(2).random_sample(local.shape[0])
    want = np.asarray(_load("stage_fuse_probe").spmv_routed_fused1(
        jp, jnp.asarray(x), 3.0, 4.0, jnp.asarray(y)))
    got = tsf.spmv_routed_fused1(tp, torch.from_numpy(x), 3.0, 4.0,
                                 torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # on the CPU the fused pipeline reproduces the stock one bitwise
    stock = tr.spmv_routed(tp, torch.from_numpy(x), 3.0, 4.0,
                           torch.from_numpy(y))
    assert torch.equal(got, stock)
    xt = torch.from_numpy(x)
    assert torch.equal(tsf.stage_fuse_gather(*tsf.pass1_operands(tp, xt)),
                       tsf.pass1_tiles_stock(tp, xt))


# ---- P2: the B-row window gather ----

def _jax_window_gather(Bt, wblk, idx):
    """The JAX probe's `kern` and `pallas_call` (wcoo_gather_probe.py:
    112-133; the kernel is a closure in its main(), so its body is
    restated here), in interpret mode."""
    T, K = wblk.shape[0], Bt.shape[1]

    def kern(wblk_ref, bt_ref, idx_ref, out_ref):
        del wblk_ref
        lanes = jnp.broadcast_to(idx_ref[0], (K, LANES))
        out_ref[0] = jnp.take_along_axis(bt_ref[0], lanes, axis=1)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(T,),
        in_specs=[pl.BlockSpec((1, K, LANES), lambda t, wb: (wb[t], 0, 0)),
                  pl.BlockSpec((1, 1, LANES), lambda t, wb: (t, 0, 0))],
        out_specs=pl.BlockSpec((1, K, LANES), lambda t, wb: (t, 0, 0)))
    return pl.pallas_call(
        kern, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((T, K, LANES), Bt.dtype),
        interpret=True)(wblk, Bt, idx)


@pytest.mark.parametrize("np_dtype,k", [(np.float32, 64), (np.float64, 5)])
def test_p2_plain_bitwise_equals_jax_kernel(np_dtype, k):
    rng = np.random.RandomState(k)
    nb, T = 3, 4
    B = rng.standard_normal((nb * LANES, k)).astype(np_dtype)
    wblk = rng.randint(0, nb, T).astype(np.int32)
    idx = rng.randint(0, LANES, (T, 1, LANES)).astype(np.int32)
    Bt = jnp.swapaxes(jnp.asarray(B).reshape(nb, LANES, k), 1, 2)
    want = np.asarray(_jax_window_gather(Bt, jnp.asarray(wblk),
                                         jnp.asarray(idx)))
    before = twg.window_lane_gather.launches
    got = twg.window_lane_gather(*(torch.from_numpy(a)
                                   for a in (B, wblk, idx)))
    assert twg.window_lane_gather.launches == before
    assert got.shape == (T, k, LANES) and np.array_equal(got.numpy(), want)


def _jax_layout_loop(cols):
    """The JAX probe's window layout loop (wcoo_gather_probe.py:85-104 and
    the slot rebuild of :140-146)."""
    win = cols >> 7
    lane = (cols & 127).astype(np.int32)
    uniq, counts = np.unique(win, return_counts=True)
    tiles_per_win = -(-counts // LANES)
    T = int(tiles_per_win.sum())
    wblk = np.repeat(uniq, tiles_per_win).astype(np.int32)
    lane_tiles = np.zeros((T, 1, LANES), dtype=np.int32)
    slot = np.zeros(len(cols), np.int64)
    pos = t0 = 0
    for c, tw in zip(counts, tiles_per_win):
        buf = np.zeros(tw * LANES, np.int32)
        buf[:c] = lane[pos:pos + c]
        lane_tiles[t0:t0 + tw, 0, :] = buf.reshape(tw, LANES)
        slot[pos:pos + c] = t0 * LANES + np.arange(c)
        pos += c
        t0 += tw
    return wblk, lane_tiles, slot, len(uniq)


def test_window_layout_matches_the_jax_loop():
    W = jgen.webbase_like(n=20_000, avg_deg=3.0, seed=5, local_scale=200.0)
    cols = np.sort(W.col_idx.astype(np.int32))
    want = _jax_layout_loop(cols)
    got = twg.window_layout(cols)
    for a, b in zip(want[:3], got[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3] == want[3]


# ---- both probes' main() in a toy world ----

@pytest.fixture()
def toy_world(monkeypatch, tmp_path):
    """A small web graph in place of webbase-1M in both packages, the JAX
    loop timer cut to two iterations, and a temporary working directory
    for `.bench_cache`."""
    monkeypatch.chdir(tmp_path)
    import sblas_tpu.io.generate as jg
    import sblas_tpu.utils.benchtime as bt
    import sblas_tpu_torch.io.generate as tg
    for mod in (jg, tg):
        real = mod.webbase_like

        def small(*a, _real=real, **kw):
            return _real(n=4096, avg_deg=3.0, seed=3, local_scale=60.0,
                         dtype=kw.get("dtype", np.float32))
        monkeypatch.setattr(mod, "webbase_like", small)
    real_loop = bt.loop_time_ms
    monkeypatch.setattr(bt, "loop_time_ms", lambda step, carry, iters=2,
                        reps=1, args=(): real_loop(step, carry, iters=2,
                                                   reps=1, args=args))
    return monkeypatch


def _lines(text, prefixes):
    return [ln for ln in text.splitlines() if ln.startswith(prefixes)]


def test_stage_fuse_probe_main_cpu(toy_world, capsys):
    toy_world.setattr(sys, "argv", ["stage_fuse_probe.py", "4",
                                    "--check-only"])
    assert _load("stage_fuse_probe").main() == 0
    jax_err = capsys.readouterr().err
    assert tsf.main(["4", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    shard = _lines(err, "# shard:")
    assert shard and shard == _lines(jax_err, "# shard:")
    assert "exactness: Validation = True" in err
    assert "heaviest shard: stock" in err and "cpu host" in err
    # the second run loads the plan the first one cached
    assert tsf.main(["4", "--device", "cpu", "--check-only"]) == 0
    assert "webbase_xfoot_shard4_f32_torch_v1.npz" in \
        os.listdir(".bench_cache")


def test_wcoo_gather_probe_main_cpu(toy_world, capsys):
    assert _load("wcoo_gather_probe").main() == 0
    jax_out = capsys.readouterr().out
    assert twg.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    host = ("reduce fill", "gather tiles")
    assert len(_lines(out, host)) == 5
    assert _lines(out, host) == _lines(jax_out, host)
    assert "window lane gather oracle: OK" in out and "go/no-go" in out
    assert "bridge (64-wide row permutation" in out


def test_probes_refuse_unknown_devices(capsys):
    assert tsf.main(["--device", "tpu"]) == 2
    assert twg.main(["--device", "tpu"]) == 2
    assert "--device cuda|cpu" in capsys.readouterr().err


def test_probe_cuda_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tsf.main([]) == 2 and twg.main([]) == 2


def test_worst_shard_of_the_toy_world_is_jaxs(worst_shard):
    local, sizes = worst_shard
    W = jgen.webbase_like(n=6000, avg_deg=3.0, seed=3, local_scale=60.0)
    tloc, tsizes = tx.xfoot_worst_local(_port(W), 4)
    assert tsizes == sizes
    assert np.array_equal(tloc.col_idx, local.col_idx)


@pytest.mark.parametrize("variant", sorted(p1_variants.VARIANTS))
def test_p1_variant_patches_match_the_source(variant):
    """Every copy the P1 variants tool builds is made from the current
    csrc/probe_kernels.cu: each patch matches exactly once."""
    patches = p1_variants.VARIANTS[variant]
    copy = p1_variants._source(patches)
    assert "sblas_stage_fuse_gather_f32" in copy
    assert (copy == p1_variants._source([])) == (not patches)
