"""Headline benchmark of the port.  Prints ONE JSON line on stdout:

    {"metric": "ref_workloads_geomean_speedup", "value": N, "unit": "x",
     "vs_baseline": N, "device_value": N, "device": "...",
     "repeats": {...}}

    python -m sblas_tpu_torch.bench [--device cuda|cpu]
    torchrun --nproc_per_node=4 -m sblas_tpu_torch.bench

Port of the JAX package's root `bench.py`, cell for cell.  The
reference's two benchmark workloads (profiling.sh:6-21): CSR SpMM K=64 on
the s3dkq4m2-structure proxy (`fem_shell_like`, `make_plan(op="spmm")`,
DIA) and CSR SpMV on the webbase-1M proxy (`webbase_like`,
`make_plan(op="spmv")`, the routed engine: kernels K1 and K2).  `value`
is the geometric mean of the two speedups of the planned path over the
tier-0 `CooPlan`, unclamped: a plan that loses to tier 0 reports < 1x.
The chooser's thresholds were calibrated on a TPU and are not re-tuned
here.  Beside them, on stderr: the unstructured SpMM (webbase x K=64,
WCOO, kernel K3), the xfoot worst shard's compute at 4 and 16 shards
(`xfoot_worst_local`, `RoutedPlan.from_csr(min_*)`, `spmv_routed`), the
weak-scaling cell (the worst of 4 shards of `webbase_like(n=4_000_000)`
plus the modeled exchange at `scaling.ICI_BW_DEFAULT`), the projections
and two-tier lines of `scaling.py`, and the BASELINE scorecard.  Under a
process group of more than one rank (`torchrun`), every rank first
measures `scaling.measured_multichip` at n = 2 and 4 (routed SpMV shards,
K2'; DIA SpMM shards), then rank 0 runs the single-device cells and
prints; the other ranks exit.

Every cell is gated on the numpy oracle at the reference's 1e-3 relative
bar before it is timed.  Timing is the plain call: `wall_time_ms`, the
median host time of a synchronous call, gives `value` (what a solver loop
waits); `device_time_ms` (CUDA events, the host's launches hidden) runs
beside it and gives `device_value`.  Each `repeats[name]` keeps three
independent repeats: `min_ms`, `median_ms` and `spread` of the wall time
and `device_median_ms`.  With `--device cpu` the clock is the host's
(`host_time_ms`), the line says `"device": "cpu"`, `device_value` is null
and no number is reported under a device name.  `--device cuda` with no
card raises; it never runs on the CPU instead.

Plans with an analysis phase are cached under `.bench_cache/torch/`
(`io/plancache.py`; file names of the port's own, so neither package
loads the other's), with the weak cell's shard matrix and exchange
statistics beside its plan, so a warm run never regenerates the 4M-row
matrix.  Generators are looked up in `io.generate` at call time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

CACHE = os.path.join(".bench_cache", "torch")
K = 64
ALPHA = BETA = 1.0


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _device_probe(device: str):
    """The device the bench runs on: a CUDA card for "cuda" (raises when
    there is none; it never runs on the CPU instead), or the CPU."""
    import torch

    from .utils.errors import KernelError, require
    if device == "cpu":
        return torch.device("cpu")
    require(torch.cuda.is_available(), KernelError,
            "bench --device cuda: no CUDA device is available")
    dev = torch.device("cuda", torch.cuda.current_device())
    if os.environ.get("RANK", "0") == "0":
        log(f"# bench: device probe ok ({torch.cuda.get_device_name(dev)})")
    return dev


class _Clock:
    """Times one call: (wall ms, device ms) medians on CUDA, (host ms,
    None) on the CPU; `timed3` keeps three independent repeats."""

    def __init__(self, dev):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.repeats: dict = {}

    def once(self, fn):
        from .utils.timing import device_time_ms, host_time_ms, wall_time_ms
        if not self.cuda:
            return host_time_ms(fn, warmup=1, reps=5), None
        return (wall_time_ms(fn, warmup=5, reps=30, device=self.dev),
                device_time_ms(fn, warmup=3, reps=30, device=self.dev))

    def timed3(self, name: str, fn):
        """Three independent repeats; the median wall (host) time and the
        median device time are the cell's numbers.  A wall spread above 5
        % warns but never fails."""
        runs = [self.once(fn) for _ in range(3)]
        ts = sorted(w for w, _ in runs)
        spread = (ts[-1] - ts[0]) / max(ts[0], 1e-9)
        if spread > 0.05:
            log(f"# WARN {name}: repeat spread {spread * 100:.1f}% > 5% "
                f"({', '.join(f'{t:.5f}' for t in ts)} ms); the median is "
                f"reported")
        rec = {"min_ms": ts[0], "median_ms": ts[1], "spread": spread}
        dev_ms = None
        if self.cuda:
            dev_ms = float(np.median([d for _, d in runs]))
            rec["device_median_ms"] = dev_ms
        self.repeats[name] = rec
        return ts[1], dev_ms

    def label(self) -> str:
        return "wall" if self.cuda else "cpu host"


def _gate(title, got, want) -> None:
    from .utils.verify import check_equal
    report = check_equal(got.cpu().numpy(), want, relative=True)
    if not report.ok:
        raise AssertionError(f"bench {title} vs the CPU oracle: {report}")


def _vec(n, dev, fill=None):
    import torch

    from .containers import DenseVector
    v = (DenseVector.random(n, dtype=np.float32) if fill is None
         else DenseVector.constant(n, fill, dtype=np.float32))
    return v, torch.from_numpy(v.values).to(dev)


def _mat(n, k, dev, fill=None):
    import torch

    from .containers import DenseMatrix
    M = (DenseMatrix.random(n, k, dtype=np.float32) if fill is None
         else DenseMatrix.constant(n, k, fill, dtype=np.float32))
    return M, torch.from_numpy(M.values).to(dev)


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sblas_tpu_torch.bench")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = _device_probe(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        from .cli.common import setup_devices
        with setup_devices(world, args.device) as (mesh, _):
            measured = _measured(mesh.device)
            if mesh.rank != 0:
                return 0
            return _bench(mesh.device, measured)
    return _bench(dev, None)


def _measured(dev) -> dict:
    """`measured_multichip` on every rank: {op: [(n, ms)]} at n = 2, 4."""
    import torch
    import torch.distributed as dist

    from .io import generate
    from .scaling import measured_multichip
    chips = [n for n in (2, 4) if n <= dist.get_world_size()]
    out = {}
    for op, mat, k, kind in (
            ("spmm", generate.fem_shell_like(dtype=np.float32), K, "dia"),
            ("spmv", generate.webbase_like(dtype=np.float32), 1, None)):
        out[op] = measured_multichip(op, mat, k, torch.float32, chips,
                                     device=dev, kind=kind)
    return out


def _bench(dev, measured) -> int:
    import torch

    from .io import generate
    from .io.plancache import cached_plan
    from .ops import make_plan, spmm, spmv
    from .ops.cpu_reference import spmm_cpu, spmv_cpu
    from .ops.plans import CooPlan
    from .ops.rspmv import RoutedPlan, spmv_routed
    from .ops.spmm import spmm_coo
    from .ops.spmv import spmv_coo
    from .parallel.xfoot import xfoot_stats, xfoot_worst_local
    from .scaling import (ICI_BW_DEFAULT, project_flat_over_dcn,
                          project_hier, project_table, report_lines,
                          scorecard_lines)
    from .utils.timing import gflops, nnz_per_s, spmm_flops

    clock = _Clock(dev)
    f32 = torch.float32
    name = torch.cuda.get_device_name(dev) if clock.cuda else "cpu"
    log(f"# device: {name}; times are {clock.label()} ms per call "
        f"(medians){', device ms beside them' if clock.cuda else ''}")

    def cached(fname, build, valid=None):
        return cached_plan(os.path.join(CACHE, fname), build, valid,
                           device=dev, say=lambda s: log(f"# {s}"))

    # ---- headline 1: SpMM K=64 on the s3dkq4m2 shell proxy ----
    A = generate.fem_shell_like(dtype=np.float32)
    Bh, B = _mat(A.width, K, dev)
    Ch, C0 = _mat(A.height, K, dev, fill=1.0)
    base_plan = CooPlan.from_csr(A, dtype=f32, device=dev)
    best_plan = make_plan(A, dtype=f32, op="spmm", device=dev)
    want = spmm_cpu(A, Bh, ALPHA, BETA, Ch)
    _gate("spmm shell (best)", spmm(best_plan, B, ALPHA, BETA, C0), want)
    _gate("spmm shell (tier 0)", spmm_coo(base_plan, B, ALPHA, BETA, C0),
          want)
    del want
    ms_base, dv_base = clock.once(
        lambda: spmm_coo(base_plan, B, ALPHA, BETA, C0))
    ms_best, dv_best = clock.timed3(
        "spmm_shell", lambda: spmm(best_plan, B, ALPHA, BETA, C0))
    flops = spmm_flops(A.nnz, K)
    log(f"# spmm k64 shell (n={A.shape[0]}, nnz={A.nnz}): baseline "
        f"{gflops(flops, ms_base):.1f} GFLOP/s ({ms_base:.5f} ms, device "
        f"{_fmt(dv_base)}), best[{type(best_plan).__name__}] "
        f"{gflops(flops, ms_best):.1f} GFLOP/s ({ms_best:.5f} ms, device "
        f"{_fmt(dv_best)})")
    del base_plan, best_plan, B, C0

    # ---- headline 2: SpMV on the webbase-1M proxy ----
    W = generate.webbase_like(dtype=np.float32)
    xh, xw = _vec(W.width, dev)
    yh, yw = _vec(W.height, dev, fill=1.0)
    wbase = CooPlan.from_csr(W, dtype=f32, device=dev)
    wbest = cached("webbase_spmv_f32_torch_v1.npz",
                   lambda: make_plan(W, dtype=f32, op="spmv", device=dev),
                   valid=lambda p: p.shape == W.shape and p.nnz == W.nnz)
    want = spmv_cpu(W, xh, ALPHA, BETA, yh)
    _gate("spmv webbase (best)", spmv(wbest, xw, ALPHA, BETA, yw), want)
    _gate("spmv webbase (tier 0)", spmv_coo(wbase, xw, ALPHA, BETA, yw),
          want)
    ms_wb, dv_wb = clock.once(lambda: spmv_coo(wbase, xw, ALPHA, BETA, yw))
    ms_wbest, dv_wbest = clock.timed3(
        "spmv_webbase", lambda: spmv(wbest, xw, ALPHA, BETA, yw))
    log(f"# spmv webbase-1M-like (nnz={W.nnz}): baseline "
        f"{nnz_per_s(W.nnz, ms_wb):.3e} nnz/s ({ms_wb:.5f} ms, device "
        f"{_fmt(dv_wb)}), best[{type(wbest).__name__}] "
        f"{nnz_per_s(W.nnz, ms_wbest):.3e} nnz/s ({ms_wbest:.5f} ms, "
        f"device {_fmt(dv_wbest)})")
    # the JAX bench's opt-in bf16 route transport line (2e-3 bar)
    log("# spmv webbase bf16 transport: not ported to sblas_tpu_torch "
        "(ROADMAP Queue 1 item 5); not timed")
    del wbase, wbest, xw, yw

    # ---- secondary: unstructured SpMM K=64 on the webbase proxy (WCOO)
    Bwh, Bw = _mat(W.width, K, dev)
    Cwh, Cw = _mat(W.height, K, dev, fill=1.0)
    wm_plan = make_plan(W, dtype=f32, op="spmm", device=dev)
    _gate("spmm webbase", spmm(wm_plan, Bw, ALPHA, BETA, Cw),
          spmm_cpu(W, Bwh, ALPHA, BETA, Cwh))
    ms_wm, dv_wm = clock.timed3(
        "spmm_webbase_wcoo", lambda: spmm(wm_plan, Bw, ALPHA, BETA, Cw))
    log(f"# spmm k64 webbase (unstructured, {type(wm_plan).__name__}): "
        f"{ms_wm:.5f} ms (device {_fmt(dv_wm)}) = "
        f"{gflops(spmm_flops(W.nnz, K), ms_wm):.1f} GFLOP/s = "
        f"{nnz_per_s(W.nnz, ms_wm):.3e} nnz/s")
    del wm_plan, Bw, Cw, Bwh, Cwh

    # ---- projections over the link model (scaling.py) ----
    table_mm = project_table("spmm", ms_best, A.shape[0], K, 4,
                             halo_rows=2412)
    for line in report_lines("spmm", ms_best, A.shape[0], K, 4,
                             halo_rows=2412, table=table_mm):
        log(line)

    # xfoot: the plan-time exchange geometry and the heaviest shard's
    # compute, measured (every rank runs a plan of its shape)
    xf, shard_ms = {}, {}
    for nsh in (4, 16):
        xf[nsh] = xfoot_stats(W, nsh)
        local, (tg, srs, prs, sks) = xfoot_worst_local(W, nsh)
        lplan = cached(
            f"webbase_xfoot_shard{nsh}_f32_torch_v1.npz",
            lambda: RoutedPlan.from_csr(local, dtype=f32, min_gtiles=tg,
                                        min_srows=srs, min_prows=prs,
                                        min_sranks=sks, device=dev),
            valid=lambda p: (p.shape == local.shape and p.nnz == local.nnz
                             and p.n_gtiles >= tg and p.n_srows >= srs
                             and p.n_prows >= prs))
        xlh, xl = _vec(local.shape[1], dev)
        ylh, yl = _vec(local.shape[0], dev, fill=0.0)
        _gate(f"xfoot shard n={nsh}", spmv_routed(lplan, xl, 1.0, 1.0, yl),
              spmv_cpu(local, xlh, 1.0, 1.0, ylh))
        shard_ms[nsh], dv_sh = clock.timed3(
            f"xfoot_shard{nsh}",
            lambda: spmv_routed(lplan, xl, 1.0, 1.0, yl))
        log(f"# xfoot[spmv] n={nsh}: shard compute "
            f"{shard_ms[nsh] * 1e3:.1f} us (measured; device "
            f"{_fmt(dv_sh)}), hot {xf[nsh].hot_total}, packets "
            f"{xf[nsh].packet_pad}/pair, extract {xf[nsh].extract_mode}")
        del lplan
    table_mv = project_table("spmv", ms_wbest, W.shape[0], 1, 4, xfoot=xf,
                             xfoot_shard_ms=shard_ms)
    for line in report_lines("spmv", ms_wbest, W.shape[0], 1, 4, xfoot=xf,
                             xfoot_shard_ms=shard_ms, table=table_mv):
        log(line)

    # ---- weak scaling: 1M rows per device, the single-device workload
    # itself; t_n = the worst of 4 shards of a 4M-row matrix, measured,
    # plus the modeled exchange
    st4, local4, lplan4 = _weak_cell(dev)
    xl4h, xl4 = _vec(local4.shape[1], dev)
    yl4h, yl4 = _vec(local4.shape[0], dev, fill=0.0)
    _gate("weak shard n=4", spmv_routed(lplan4, xl4, 1.0, 1.0, yl4),
          spmv_cpu(local4, xl4h, 1.0, 1.0, yl4h))
    ms4, dv4 = clock.timed3("spmv_weak_shard4",
                            lambda: spmv_routed(lplan4, xl4, 1.0, 1.0, yl4))
    comm4_ms = (st4.comm_bytes(4) / ICI_BW_DEFAULT * 1e3
                + st4.extract_ns * 1e-6)
    eff_weak = ms_wbest / (ms4 + comm4_ms)
    log(f"# scaling[spmv] WEAK n=4 (1M rows/device, 4M-row matrix): shard "
        f"{ms4:.5f} ms (device {_fmt(dv4)}) + comm {comm4_ms:.5f} ms -> "
        f"{eff_weak * 100:.0f}% of per-device speed of light "
        f"({'meets' if eff_weak >= 0.8 else 'MISSES'} 80% target)")
    del lplan4

    # ---- two tiers: boxes of c cards, s boxes over the network ----
    for op_name, t1, rb in (("spmm", ms_best, A.shape[0] * K * 4),
                            ("spmv", ms_wbest, W.shape[0] * 4)):
        for (s, c) in ((2, 4), (4, 4)):
            h = project_hier(t1, rb, s, c)
            f = project_flat_over_dcn(t1, rb, s, c)
            log(f"# scaling[{op_name}] two-tier {s}x{c}: hier "
                f"{h.efficiency * 100:.0f}% (comm {h.comm_ms:.3f} ms) vs "
                f"flat-over-DCN {f.efficiency * 100:.0f}% "
                f"(comm {f.comm_ms:.3f} ms)")

    # ---- measured on several cards (torchrun), beside the projections
    for op_name, t1 in (("spmm", ms_best), ("spmv", ms_wbest)):
        for n, ms in (measured or {}).get(op_name, []):
            eff = t1 / (n * ms) if ms else float("inf")
            log(f"# measured[{op_name}] n={n}: {ms:.5f} ms "
                f"({clock.label()} per call), efficiency {eff * 100:.1f}%")

    for line in scorecard_lines([
        ("spmm shell K=64", table_mm, None, ""),
        ("spmv webbase-1M", table_mv, (4, eff_weak),
         "weak (1M rows/device, the single-device workload itself) is "
         "BASELINE's per-device speed-of-light regime; the strong n=16 "
         "cell splits 3M nnz into 0.19M-nnz shards, below the plan "
         "machinery's fixed-cost scale"),
    ]):
        log(line)

    geomean = float(np.sqrt((ms_base / ms_best) * (ms_wb / ms_wbest)))
    dev_geomean = (float(np.sqrt((dv_base / dv_best) * (dv_wb / dv_wbest)))
                   if clock.cuda else None)
    log(f"# spmm speedup {ms_base / ms_best:.3f}x, spmv speedup "
        f"{ms_wb / ms_wbest:.3f}x ({clock.label()}); device geomean "
        f"{'not measured' if dev_geomean is None else f'{dev_geomean:.4f}x'}")
    print(json.dumps({
        "metric": "ref_workloads_geomean_speedup",
        "value": round(geomean, 4),
        "unit": "x",
        "vs_baseline": round(geomean, 4),
        "device_value": (None if dev_geomean is None
                         else round(dev_geomean, 4)),
        "device": name,
        "repeats": {k: {f: (round(v, 5) if f != "spread" else round(v, 4))
                        for f, v in r.items()}
                    for k, r in clock.repeats.items()},
    }), flush=True)
    return 0


def _weak_cell(dev):
    """(XFootStats, the worst shard's CSR, its routed plan) for 4 shards of
    `webbase_like(n=4_000_000)`.  The stats and the shard's CSR sit in a
    sidecar beside the plan's cache file; on a hit of both whose shapes
    and nnz agree the 4M-row matrix is not generated."""
    import zipfile

    import torch

    from .containers import CsrMatrix
    from .io import generate
    from .io.plancache import load_plan, save_plan
    from .ops.rspmv import RoutedPlan
    from .parallel.xfoot import XFootStats, xfoot_stats, xfoot_worst_local
    from .utils.errors import FormatError
    side = os.path.join(CACHE, "webbase4m_xfoot_shard4_side_torch_v1.npz")
    plan_path = os.path.join(CACHE, "webbase4m_xfoot_shard4_f32_torch_v1.npz")
    if os.path.exists(side) and os.path.exists(plan_path):
        try:
            with np.load(side) as z:
                st4 = XFootStats(**json.loads(bytes(z["stats"]).decode()))
                local4 = CsrMatrix(z["row_ptr"], z["col_idx"], z["values"],
                                   tuple(int(v) for v in z["shape"]))
            lplan4 = load_plan(plan_path, dev)
            if lplan4.shape == local4.shape and lplan4.nnz == local4.nnz:
                return st4, local4, lplan4
            log("# W4 cache stale (plan and sidecar disagree); rebuilding")
        except (FormatError, OSError, KeyError, ValueError, TypeError,
                zipfile.BadZipFile) as e:
            log(f"# W4 cache unusable ({e}); rebuilding")
    W4 = generate.webbase_like(n=4_000_000, dtype=np.float32)
    st4 = xfoot_stats(W4, 4)
    local4, (tg, srs, prs, sks) = xfoot_worst_local(W4, 4)
    del W4
    lplan4 = RoutedPlan.from_csr(local4, dtype=torch.float32, min_gtiles=tg,
                                 min_srows=srs, min_prows=prs,
                                 min_sranks=sks, device=dev)
    os.makedirs(CACHE, exist_ok=True)
    save_plan(plan_path, lplan4)
    np.savez(side, stats=np.frombuffer(
        json.dumps(st4._asdict()).encode(), dtype=np.uint8),
        row_ptr=local4.row_ptr, col_idx=local4.col_idx,
        values=local4.values, shape=np.asarray(local4.shape))
    return st4, local4, lplan4


if __name__ == "__main__":
    sys.exit(main())
