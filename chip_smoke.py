"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `sblas_tpu_torch/csrc/`, holds
each against its plain PyTorch version at the shapes its main path gives
it (K1/K2/K2'/P1/P2 bitwise, K3/K4 within a stated tolerance, each
deterministic; K4's bound is that of f32-accurate 3xTF32 work on the
tensor cores, with the f32 CUDA-core bound printed beside it; every
`kernels` entry carries its share of bound),
then runs every main path at full size, counting kernel launches on each:

    webbase_like() (1M rows, f32) -> make_plan(op="spmv") -> RoutedPlan
        -> spmv (K1, K2: each launch counted by body, all on the row
        body, launched with programmatic dependent launch), and the
        tier-0 COO SpMV beside it; `[K1/K2 variants]`: every variant of
        K1 (f32, f64, bf16, bf16_i16) and K2 (f32, f64, bf16, f32_bf16)
        bitwise at that plan's first route layer and tiles
    webbase_like() x K=64 -> make_plan(op="spmm") -> WcooPlan -> spmm (K3,
        writing beta*C + alpha*A@B itself; K3 timed in that fused form
        and in its grid form, each with its bound)
    fem_shell_like() x K=64 -> make_plan(op="spmm") -> DiaPlan -> spmm
        (K5, once; `[K5 dia_spmm]`: K5 beside the plain `addcmul_` loop,
        its bound counted as DIA bytes and as the CSR `harness/work.py`
        counts, `torch.addmm` and `torch.sparse.mm` on CSR), and the
        tier-0 COO SpMM beside it
    fem_banded_like() x K=256 -> BsrPlan -> spmm (K4); x K=64 -> spmm
        (batched matmuls, no K4)
    SpMV over DiaPlan (shell: K6, once; `[K6 dia_spmv]`: K6 beside the
        plain `addcmul_` loop, its bound counted as DIA bytes and as CSR,
        `torch.mv` and `torch.sparse.mm` on CSR; `[f64]` K6[f64] the
        same) and BsrPlan (band-73), after each SpMM

and the distribution layer in a world-1 NCCL group:

    [dist] webbase_like() -> partition_row_plans(A, 1, op="spmv") (routed
        shards) -> spmv_dist_planned, psum and psum_scatter (K1, K2'),
        spmv_dist over nnz-balanced COO segments, spmv_dist_hier at 1x1
    [k2p] K2' against its plain version at the world-1 shard's tables and
        at one 4-way shard's
    [shards4] the same matrix cut 4 ways, each rank's compute run on the
        card (K2' 4 times), partials placed and summed
    [spmm-dist] webbase x K=64: spmm_mode2_planned over WCOO shards (K3)
        and spmm_mode1 over the WcooPlan; shell x K=64: spmm_mode2_planned
        over DIA shards, spmm_mode2, spmm_halo_planned, spmm_mode2_hier
    [xfoot] webbase_like() -> partition_xfoot(A, 1) (a routed shard) ->
        spmv_xfoot (K1, K2') and its nocomm twin
    [xfoot-extract] rank 0's extraction alone at 4 and 16 shards (COO
        shards), each engine forced (flat index_select; route through K1):
        the two packed vectors bitwise equal, ns per element of each (the
        port's GATHER_NS / ROUTE_NS) and the engine they give
    [xfoot-shard] xfoot_worst_local(A, n) -> RoutedPlan.from_csr(min_*) at
        n = 4 and 16: the stock SpMV (K2) and the fused one (P1), pass-1
        tiles bitwise, both against the oracle, both timed; the stock
        SpMV's kernels on the shard's own tables (`[xfoot-shard
        kernels]`: K1 on the main route's first layer, (8192, 128) and
        (2048, 128), beside torch.gather; K2 on the 53 and 14 tiles; every
        variant of each, bitwise), each with its bound and share, the
        variant the stock SpMV ran with its launches and body there, and
        the shard's whole main route's device ms
    [plancache] the world-1 xfoot shards and the n=16 routed plan saved,
        loaded on the card, bitwise equal, one loaded run vs the oracle
    [p1] / [p2] kernels P1 (at the full plan's T_g and at the n=16 shard,
        both kept in P1's `kernels` entry, the shard's as `shard16_*`)
        and P2 (webbase x K=64 windows, every gathered row checked) vs
        their plain versions, with P2's index_select yardsticks (f32,
        bf16) and the 64-wide row permutation a bridge would cost

    [solve] the solvers, each chunk of 16 iterations one CUDA graph and
        then eagerly (the two bitwise equal, the counters showing the
        kernels inside the captured chunk): CG, plain and Jacobi, on the
        shell SPD system (`examples.cg.build_spd`, n ~ 90k), PageRank on
        the webbase-1M P^T and BiCGSTAB on webbase-1M made diagonally
        dominant (both routed: K1, K2); wall ms per iteration of whole
        solves with the graph and eagerly, and wall and device ms and
        idle share of a replayed chunk and of an eager iteration
    [solve-dist] CG over routed RowPlanShards of the SPD system and
        PageRank over XFootShards of P^T in the world-1 group (K1, K2')

    [um] host-streamed execution: webbase-1M host-resident at a 16 MiB
        budget (12 WCOO bands, pinned) -> spmv_um and spmm_um x K=64 (K3
        on every band), the shell at 32 MiB (ELL bands) -> spmm_um x
        K=64; each streamed (tuning=0: bands counted, bytes streamed,
        peak device memory, device time against a plain pinned copy of
        the same bytes) and tuned (tuning=1: bitwise the streamed result
        for K3 and ELL bands)
    [k3-band] K3 against its plain version at one streamed band's tables
        (its pad tiles included)
    [um-dist] spmv_um_dist, spmm_um_dist (K3) and spmm_um_mode1 (K3) on
        webbase-1M in the world-1 group, untuned and tuned
    [um-dense] spmm_um_hostdense on the shell x K=64 (A, B and C in
        pinned host memory, a budget below C's 23 MB), untuned and tuned,
        and spmv_um_hostdense

    the 16-bit half, each bf16 variant held against its plain version
    (K1, K2, K2' bitwise; K3, K4 within one bf16 ulp, deterministic) and
    counted by variant (`_kernels.LAUNCHED`) on the path that runs it:
    [bf16-kernels] K1 bf16/int16 at webbase-1M's main-route tables, K2 and
        K2' f32 -> bf16 at that plan's tiles (and bf16 -> bf16 at a
        bf16-valued plan's), K3 bf16 at webbase x K=64 in both forms (its
        `bf16` variant, 16-byte loads on 8-lane groups) and its
        `bf16_ragged` variant, each body its launcher picks held on the
        path that runs it (counted by body, `_kernels.BODIES`): the ring
        body (the same lanes fed by a shared-memory ring of each entry's
        covering words, shifted on the read) at the SpMM at K=63's
        operands and on that SpMM (an odd stride), and on the SpMM at
        K=100's two chunks of 81 and 19 columns and on that SpMM; the
        masked body (the same lanes on whole words, columns counted from
        the word before k0) at k0 = 1 and on the webbase bf16 SpMM at
        K=128's two chunks of 81 and 47 columns and on that SpMM; bitwise
        the `bf16` variant's result on aligned copies at k0 = 1, 56
        columns, in both forms and at the odd stride), K4 bf16 (wgmma
        fed by TMA, its `bf16` variant, checked) at band-73 x K=256 and
        (`bf16_ragged`, wgmma on B's rows brought by TMA as 8-row groups
        and shifted into place, checked) at K=263 and, off the path,
        K=300,
        with library yardsticks (`torch.gather` on int32 indices; bf16
        `torch.sparse.mm` / `torch.addmm` on CSR where the torch build
        has them); informational, K4 bf16 on the shell's bf16 BELL plan
        at K=64 beside the `spmm_bsr` matmuls `ops.spmm` runs there
    [bf16-transport] the webbase-1M routed SpMV re-aimed with
        `with_transport("bf16")`, gated at 2e-3 and timed beside f32 in
        turns; `spmv_dist_planned` and `spmv_xfoot` at world 1 over
        shards built with `routed_transport="bf16"` (K2' storing bf16)
    [bf16-plans] plans with bf16 values against the oracle at the JAX
        package's bf16 bound (rtol = atol = 0.15): the webbase routed SpMV
        (K1 bf16, K2 bf16; and through K2' with `pregather`), the webbase
        WCOO SpMM (K3) at K=64, 63 and 100, the shell DIA SpMM and SpMV, the
        band-73 BELL SpMM
        at K=256 and K=263 (K4, each variant once)
    [bf16-dist] the distributed modes over containers with bf16 values,
        world 1: mode 1 over the bf16 WcooPlan (K3 `bf16`) and over
        band-73's bf16 BsrPlan at K=256 (K4 `bf16` once), mode 2 and
        the distributed SpMV over bf16 COO segments (f32 partials), the
        planned and xfoot SpMVs over bf16 routed shards (K1, K2' `bf16`),
        mode 2 over bf16 WCOO shards (K3 `bf16`), the halo SpMM on the
        shell; each at the bf16 bound, its launches by variant, the f32
        path's device ms beside it
    [um bf16] webbase-1M at 16 MiB in bf16 bands (sized by 2-byte values,
        pinned as bf16): spmv_um and spmm_um (K3 `bf16` once a band),
        streamed and tuned, bytes streamed beside f32's; the world-1 UM
        modes over bf16 shards; spmm_um_hostdense on the shell in bf16

    the f64 values, each f64 variant held against its plain version at
    its f32 row's shapes (K1, K2, K2', P1, P2 bitwise; K3, K4 within
    1e-12 normwise, deterministic), launched and counted by variant on a
    path, with its bound (bytes; K4: the f64 tensor cores' FLOPs, the
    CUDA cores' beside it), share and library time, one `[f64]` line
    each (the f32 plans' tables cast to f64, `cast_plan`):
    [f64] webbase-1M routed at f64: spmv (K1, K2 f64; their rows are
        `[K1/K2 variants]`' f64 readings), spmv_routed with `pregather`
        (K2' f64) and spmv_routed_fused1 (P1 f64); webbase x K=64 at
        f64: K3 in both forms beside f64 `torch.addmm`, then spmm (K3
        f64); P2 f64 on the [p2] windows beside f64 `index_select`; K4
        f64 (mma.sync f64 on the tensor cores; its DMMA kernels' registers
        and spills from the build's `-Xptxas -v` report, none may spill)
        at the full band-73 plan x K=256 beside f64 `torch.addmm`, then
        fem_banded_like(n=80_000) at f64 -> make_plan(op="spmm")
        unforced -> BsrPlan -> spmm at K=256 (one K4 f64 launch; the
        oracle on every third column); the seconds the section adds

each checked against the numpy oracle, and the SpMV and SpMM CLIs on a
200k-row `.mtx` (single mode, method 1, --mode distp, method 2p, --mode
xfoot, and --mode xfoot --plan-cache saving then loading; `[cli bf16]`:
--transport bf16, with --plan-cache saving the bf16 plan and a default
run re-aiming it; `[cli progressive]`; `[cli um]`:
spmv_test_um and spmm_test_um methods 1 and 2, tuning 0 and 1, at a
4 MiB budget), the `unit_test` CLI (`[unit_test]`), the profiling
harness (`[profiling]`: its `--small` traces and one of a streamed WCOO
SpMM, each naming its band ranges, the last K3), and the benchmark at
full size
(`[bench]`: `python -m sblas_tpu_torch.bench --device cuda`, its JSON
line and the card on one phase line).  Each
phase prints one line, stamped with the seconds since the script started
(`t=`); any failure raises and the script exits non-zero.
The line before the last is the card's name and power limit, the one
before that the kernels' JSON record, before that the script's seconds;
the last line is the device JSON.  Without a CUDA device it exits 1 and
prints no result.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ALPHA, BETA = 3.0, 4.0
SEED = 211
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, the
# float32 CUDA-core rate and the TF32 tensor-core rate; `bound_ms` is the
# larger of the bytes' time and the operations' time.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# the same data sheet's f64 rates: the CUDA cores and the f64 tensor
# cores (DMMA, reached through mma.sync f64)
FP64_FLOPS = 33.5e12
FP64_TC_FLOPS = 67e12
BF16 = torch.bfloat16
# the bf16 route transport's documented bar (the JAX CLI's and bench's),
# and the JAX package's bound for bf16-valued plans (rtol = atol = 0.15,
# tests/test_ops_single_chip.py::test_bfloat16_plans_run)
BF16_TRANSPORT_BAR = 2e-3
BF16_PLAN_TOL = 0.15
# K3/K4 sum in another order than their plain versions (index_add_,
# einsum): max |kernel - plain| / max(1, max |plain|) must stay below this
F32_REL_TOL = 1e-5
# the same bar for the f64 kernels (K3[f64], K4[f64]): f64 products and
# sums in another order than their plain versions
F64_REL_TOL = 1e-12
ORACLE_COLS = 64   # spmm_cpu column chunk: bounds its (nnz, cols) transient
# device ms (and streamed bytes) of f32 paths, by path, printed beside
# their bf16 counterparts in [bf16-dist] and [um bf16]
F32_RECORD: dict = {}


def phase(title: str, /, **fields) -> None:
    """One result line, stamped with the script's elapsed seconds."""
    body = ", ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{title}] t={time.perf_counter() - T_START:.1f}s, {body}",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: int, flops: int, rate: float = FP32_FLOPS) -> dict:
    """Least time the card could take: bytes over the HBM rate or
    operations over `rate` (the f32 CUDA-core peak unless named),
    whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bf16_ulps(got, want) -> int:
    """Largest per-element distance in bf16 ulps between two bf16 tensors
    (ordered bit patterns, so +0 and -0 are one value)."""
    def key(t):
        b = t.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)
    return int((key(got) - key(want)).abs().max()) if got.numel() else 0


def compare(name, kernel_fn, plain_fn, counter, rel_tol=0.0, ulps=None):
    """Kernel vs plain version on the same inputs: two kernel launches
    must agree bitwise (deterministic); the kernel must equal the plain
    version (rel_tol 0), stay within rel_tol of it, normwise, or (bf16,
    `ulps`) within that many bf16 ulps of it per element.  Returns
    (max_abs_err, rel_err, kernel ms, plain ms), medians of device time.
    Resets the launch counter afterwards, so these launches never count
    as a main path's."""
    from sblas_tpu_torch.utils.timing import device_time_ms
    got, again, want = kernel_fn(), kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    err = float((got.double() - want.double()).abs().max())
    rel = err / max(1.0, float(want.double().abs().max()))
    if ulps is not None:
        ok = bf16_ulps(got, want) <= ulps
    else:
        ok = torch.equal(got, want) if rel_tol == 0.0 else rel <= rel_tol
    if not ok:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max_abs_err={err}, rel={rel})")
    ms = device_time_ms(kernel_fn, reps=20, inner=10)
    plain_ms = device_time_ms(plain_fn, reps=20, inner=10)
    counter.launches = 0
    return err, rel, ms, plain_ms


def recorded(path: str, times: dict) -> dict:
    """`times` (from `call_times`), its device ms kept as `path`'s f32
    counterpart for the bf16 phases."""
    F32_RECORD[path] = float(times["device_ms"])
    return times


def call_times(fn, nnz: int, k: int = 1, reps: int = 30) -> dict:
    """Wall ms per synchronous call, device ms, the device's idle share,
    nnz/s and GFLOP/s over the wall time (medians of `reps` runs after 5
    warm-ups)."""
    from sblas_tpu_torch.utils.timing import (device_time_ms, gflops,
                                              nnz_per_s, spmm_flops,
                                              wall_time_ms)
    wall = wall_time_ms(fn, warmup=5, reps=reps)
    busy = device_time_ms(fn, warmup=5, reps=reps)
    return dict(wall_ms=f"{wall:.5f}", device_ms=f"{busy:.5f}",
                idle_share=f"{max(1.0 - busy / wall, 0.0):.3f}",
                nnz_per_s=f"{nnz_per_s(nnz, wall):.4e}",
                gflops=f"{gflops(spmm_flops(nnz, k), wall):.3f}")


def oracle_spmm(A, B, C):
    """spmm_cpu on the host, in column chunks of B."""
    from sblas_tpu_torch.containers import DenseMatrix
    from sblas_tpu_torch.ops.cpu_reference import spmm_cpu
    return np.concatenate([
        spmm_cpu(A, DenseMatrix(B[:, k0:k0 + ORACLE_COLS]), ALPHA, BETA,
                 DenseMatrix(C[:, k0:k0 + ORACLE_COLS]))
        for k0 in range(0, B.shape[1], ORACLE_COLS)], axis=1)


def checked(title, got, want):
    """check_equal(relative=True) at the reference's 1e-3, after a shape
    and finiteness check; returns the report's text."""
    from sblas_tpu_torch.utils.verify import check_equal
    got = got.cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{title}: output shape {got.shape} (want "
                             f"{want.shape}) or non-finite")
    report = check_equal(got, want, relative=True)
    if not report.ok:
        raise AssertionError(f"{title} vs the CPU oracle: {report}")
    return str(report)


def launches_of(counters: dict, fn):
    """Run `fn` with every kernel counter set to 0 just before; return its
    result and the counts just after (`_kernels.LAUNCHED` and
    `_kernels.BODIES`, cleared too, then hold the run's launches by
    variant and by body)."""
    from sblas_tpu_torch import _kernels
    for c in counters.values():
        c.launches = 0
    _kernels.LAUNCHED.clear()
    _kernels.BODIES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counters.items()}


def expect_launches(title, counts, expect):
    if counts != expect:
        raise AssertionError(f"{title}: kernel launches {counts}, expected "
                             f"{expect}")


def variant_launches(title, expect: dict) -> dict:
    """The last `launches_of` run's launches by variant (launcher name
    without its `sblas_` prefix), which must be `expect`."""
    from sblas_tpu_torch import _kernels
    got = {k[len("sblas_"):]: v for k, v in _kernels.LAUNCHED.items()}
    if got != expect:
        raise AssertionError(f"{title}: launches by variant {got}, "
                             f"expected {expect}")
    return got


def k1_k2_launches(title, launches: dict) -> dict:
    """The last `launches_of` run's K1 and K2 launches by variant
    (launcher name without its `sblas_` prefix), whose sums by kernel
    must be `launches` (`lane_shuffle`, K1's row body, apart from its
    transposed store `lane_shuffle_transposed`).  Each is launched with
    programmatic dependent launch (`csrc/row_io.cuh`'s `launch_pdl`); no
    query reads the launch mode back, so none is printed."""
    from sblas_tpu_torch import _kernels
    got = {k[len("sblas_"):]: v for k, v in _kernels.LAUNCHED.items()
           if k.startswith(("sblas_lane_shuffle_", "sblas_slab_gather_"))}
    summed = {name: sum(got.get(f"{name}_{v}", 0)
                        for v in _kernels.LAUNCHERS[name][1])
              for name in launches}
    if summed != launches:
        raise AssertionError(f"{title}: K1/K2 launches by variant {got}, "
                             f"expected {launches} by kernel")
    return got


def k1_split(*schedules, n: int = 1) -> dict:
    """K1's launches by counter in `n` runs of the routes `schedules` on
    the card, as `route_steps` pairs them: the transposed store
    (`lane_shuffle_transposed`) at each gather it pairs with the
    transpose after it, the row body (`lane_shuffle`) at the others."""
    from sblas_tpu_torch.ops.route import route_steps
    kinds = [op[0] for s in schedules for op in route_steps(tuple(s), True)]
    return {"lane_shuffle": n * kinds.count("gather"),
            "lane_shuffle_transposed": n * kinds.count("gather_t")}


def routes_of(*plans) -> tuple:
    """Each routed plan's three route schedules: x relabel, main, unrank."""
    return tuple(s for p in plans for s in (
        p.xroute_schedule, p.schedule, p.unrank_schedule))


def k1_variants(variant: str, *schedules) -> dict:
    """`k1_split` by variant (launcher name without `sblas_`, as
    `variant_launches` reads them), zero counts left out."""
    return {f"{k}_{variant}": v for k, v in k1_split(*schedules).items()
            if v}


def k1_transposed_phase(plan, kernels, variant="f32",
                        main_only=False) -> None:
    """[K1 transposed]: K1's transposed store in `variant` at every
    transpose of `plan`'s routes (the main route alone with `main_only`)
    that the SpMV stores inside K1, on the plan's own tables and random
    values: bitwise the row body followed by the permute copy (the route
    before the transposed store) and the plain version, with the kernel's
    ms, the row body's and the row body plus copy's, the plain version's,
    the bound (x, idx and out once: 12 bytes an f32 element) and the
    share.  Records the first main-route transpose as
    `kernels["lane_shuffle_transposed"]` (f32) or
    `kernels["lane_shuffle_transposed[<variant>]"]`; the launches are
    filled in from the path's own run."""
    from sblas_tpu_torch.ops.route import (LANE_SHUFFLE_VARIANTS,
                                           lane_shuffle,
                                           lane_shuffle_transposed,
                                           lane_shuffle_transposed_plain,
                                           route_steps)
    card = card_line()
    dev = plan.gslab.device
    dt, it = LANE_SHUFFLE_VARIANTS[variant]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + len(variant))
    key = ("lane_shuffle_transposed" if variant == "f32"
           else f"lane_shuffle_transposed[{variant}]")
    routes = [("main", plan.schedule, plan.tables)]
    if not main_only:
        routes += [("x relabel", plan.xroute_schedule, plan.xroute_tables),
                   ("unrank", plan.unrank_schedule, plan.unrank_tables)]
    for route, sched, tables in routes:
        for op in route_steps(tuple(sched), True):
            if op[0] != "gather_t":
                continue
            idx, shape = tables[op[1]], op[2]
            if idx.dtype != it:
                raise AssertionError(f"K1 transposed[{variant}] {route}: "
                                     f"tables are {idx.dtype}, not {it}")
            x2d = torch.rand(idx.shape, generator=gen, device=dev).to(dt)

            def unfused(x2d=x2d, idx=idx, shape=shape):
                return lane_shuffle(x2d, idx).reshape(shape).permute(
                    0, 2, 1).contiguous()
            err, _, ms, plain_ms = compare(
                f"K1 transposed[{variant}] {route} {shape}",
                lambda: lane_shuffle_transposed(x2d, idx, shape),
                lambda: lane_shuffle_transposed_plain(x2d, idx, shape),
                lane_shuffle_transposed)
            if not torch.equal(lane_shuffle_transposed(x2d, idx, shape),
                               unfused()):
                raise AssertionError(f"K1 transposed[{variant}] {route} "
                                     f"{shape}: differs from K1 and the "
                                     f"copy")
            row_ms = _device_ms(lambda: lane_shuffle(x2d, idx))
            unfused_ms = _device_ms(unfused)
            lane_shuffle.launches = lane_shuffle_transposed.launches = 0
            bnd = bound(nbytes(x2d, idx, x2d), 0)
            phase("K1 transposed", variant=variant, route=route,
                  shape=shape, bitwise_equal=True, ms=f"{ms:.5f}",
                  k1_ms=f"{row_ms:.5f}", k1_copy_ms=f"{unfused_ms:.5f}",
                  plain_ms=f"{plain_ms:.5f}",
                  bound_ms=f"{bnd['bound_ms']:.5f}",
                  share=f"{bnd['bound_ms'] / ms:.3f}",
                  gain=f"{unfused_ms / ms:.2f}x", card=card)
            if key not in kernels:
                kernels[key] = dict(
                    kernel_rec("lane_shuffle_transposed", variant,
                               "route_kernels.cu",
                               "sblas_tpu/ops/route.py:388", err, ms,
                               plain_ms, plain_ms, bnd), name=key)
            del x2d


def checked_bf16(title, got, want, bar=None):
    """A bf16 path's result against the f64 oracle: finite, of the
    expected shape, and within `bar` relative (check_equal, the bf16
    transport's gate) or, with no bar, the JAX package's bf16-plan bound
    (|got - want| <= 0.15 + 0.15 |want|).  Returns the text with the
    largest relative error, max |got - want| / max(1, |want|)."""
    from sblas_tpu_torch.utils.verify import check_equal
    got = got.float().cpu().numpy().astype(np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{title}: output shape {got.shape} (want "
                             f"{want.shape}) or non-finite")
    if bar is not None:
        report = check_equal(got, want, error_bar=bar, relative=True)
        if not report.ok:
            raise AssertionError(f"{title} vs the CPU oracle at {bar}: "
                                 f"{report}")
        return str(report)
    err = np.abs(got - want)
    bad = int((err > BF16_PLAN_TOL + BF16_PLAN_TOL * np.abs(want)).sum())
    rel = float((err / np.maximum(1.0, np.abs(want))).max())
    if bad:
        raise AssertionError(f"{title}: {bad} elements outside rtol=atol="
                             f"{BF16_PLAN_TOL} (max_rel={rel:.3e})")
    return f"within rtol=atol={BF16_PLAN_TOL} (max_rel={rel:.3e})"


def kernel_rec(name, variant, source, replaces, err, ms, plain_ms,
               library_ms, bnd) -> dict:
    """One entry of the `kernels` JSON line; `launches` is filled in from
    the main path's run."""
    return dict(name=f"{name}[{variant}]", route="cuda",
                source=f"sblas_tpu_torch/csrc/{source}", replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **bnd)


def library_or_none(title, fn):
    """Device ms of one PyTorch library call used as a yardstick, or None
    when this torch build has no such call for these operands (the reason
    is printed); the yardstick is never used by the port."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        phase("library", call=title, library_ms=None,
              reason=str(e).splitlines()[0][:160])
        return None
    return _device_ms(fn)


def k3_forms(title, args, C, A_csr, nnz, rate, rel_tol=0.0, ulps=None):
    """K3 at the main path's shapes in both store forms, each against its
    plain version (`compare`): the grid form, the kernel's sums alone,
    beside `torch.sparse.mm`; and the fused form, beta*C + alpha*A@B on
    C's rows (the form the SpMM launches), beside `torch.addmm` on the
    same CSR matrix.  Prints one phase line; returns the fused form's
    `kernels` record, the grid form's time and bound beside it.  The
    chunk must be C's whole width (a fused call writes only its chunk)."""
    from sblas_tpu_torch.ops.wcoo import window_reduce, window_reduce_plain
    k3, wb, relrow, vals, xblk, lane, B, k0, width = args
    if (k0, width) != (0, C.shape[1]):
        raise AssertionError(f"{title}: chunk {k0}:{k0 + width} is not C's")
    es = vals.element_size()
    index = nbytes(k3.units, k3.rows, wb, relrow, vals, xblk, lane)
    g_err, _, g_ms, g_plain = compare(
        f"{title} grid", lambda: window_reduce(*args),
        lambda: window_reduce_plain(*args), window_reduce, rel_tol, ulps)
    g_bnd = bound(index + (B.shape[0] + k3.n_row_blocks * 128) * width * es,
                  2 * nnz * width, rate)
    epi = dict(C=C, alpha=ALPHA, beta=BETA)
    err, rel, ms, plain_ms = compare(
        f"{title} fused", lambda: window_reduce(*args, **epi),
        lambda: window_reduce_plain(*args, **epi), window_reduce, rel_tol,
        ulps)
    bnd = bound(index + (B.shape[0] + 2 * C.shape[0]) * width * es,
                2 * nnz * width + 3 * C.shape[0] * width, rate)
    mm_ms = library_or_none(f"torch.sparse.mm {vals.dtype} CSR x dense",
                            lambda: torch.sparse.mm(A_csr, B))
    lib_ms = library_or_none(
        f"torch.addmm {vals.dtype} CSR x dense",
        lambda: torch.addmm(C, A_csr, B, beta=BETA, alpha=ALPHA))
    phase("K3 forms", kernel=title, units=k3.units.shape[0],
          k3_rows=k3.rows.shape[0], K=width, deterministic=True,
          tol=f"{ulps} bf16 ulp" if ulps is not None else rel_tol,
          grid_ms=f"{g_ms:.5f}", grid_plain_ms=f"{g_plain:.5f}",
          grid_max_abs_err=f"{g_err:.3e}", sparse_mm_ms=_fmt_ms(mm_ms),
          grid_bound_ms=f"{g_bnd['bound_ms']:.5f}",
          grid_share=f"{g_bnd['bound_ms'] / g_ms:.3f}",
          fused_ms=f"{ms:.5f}", fused_plain_ms=f"{plain_ms:.5f}",
          fused_max_abs_err=f"{err:.3e}", fused_rel_err=f"{rel:.3e}",
          addmm_ms=_fmt_ms(lib_ms), fused_bound_ms=f"{bnd['bound_ms']:.5f}",
          bound_by=bnd["bound_by"],
          fused_share=f"{bnd['bound_ms'] / ms:.3f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                grid_ms=g_ms, grid_bound_ms=g_bnd["bound_ms"],
                sparse_mm_ms=mm_ms, **bnd)


def sparse_csr(A, dev, dtype=torch.float32):
    """A as a torch sparse CSR tensor on `dev` (f32 unless named), for the
    library yardstick calls only; A's values are cast once, to `dtype`
    (an f64 yardstick multiplies A's own values)."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.row_ptr), torch.from_numpy(A.col_idx),
        torch.from_numpy(A.values).to(dtype),
        size=A.shape, device=dev, check_invariants=False)


def cast_plan(plan, dtype):
    """`plan` with its floating tensors cast to `dtype`.  For a matrix
    with f32 values this is the plan `make_plan(A, dtype)` builds: a
    layout depends on the sparsity alone (tests/test_torch_f64.py holds
    the routed, WCOO and BELL plans to it field by field), so the [f64]
    phases reuse the f32 phases' tables instead of building them again."""
    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).to(dtype)
        for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), torch.Tensor)
        and getattr(plan, f.name).is_floating_point()})


# seconds the [f64] phases add, by phase
F64_SECONDS: dict = {}


def f64_line(name, rec, **fields) -> None:
    """One [f64] line for kernel `name`'s f64 variant (its `kernels`
    record `rec`): time, bound, share, plain and library times."""
    phase("f64", kernel=f"{name}[f64]", launches=rec.get("launches"),
          max_abs_err=f"{rec['max_abs_err']:.3e}", ms=f"{rec['ms']:.5f}",
          bound_ms=f"{rec['bound_ms']:.5f}", bound_by=rec["bound_by"],
          share_of_bound=f"{rec['bound_ms'] / rec['ms']:.3f}",
          plain_ms=f"{rec['plain_ms']:.5f}",
          library_ms=_fmt_ms(rec["library_ms"]), **fields)


T_START = time.perf_counter()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # true f32 for every float32 product (the BELL path raises otherwise)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_line()
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), card=card,
          torch=torch.__version__, cuda=torch.version.cuda)

    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.containers import DenseMatrix, DenseVector
    from sblas_tpu_torch.io import native
    from sblas_tpu_torch.io.generate import (fem_banded_like, fem_shell_like,
                                             webbase_like)
    from sblas_tpu_torch.ops import (BsrPlan, DiaPlan, WcooPlan, bell_stats,
                                     make_plan, spmm, spmv)
    from sblas_tpu_torch.ops.bsr_pallas import bell_spmm, bell_spmm_plain
    from sblas_tpu_torch.ops.cpu_reference import spmv_cpu
    from sblas_tpu_torch.ops.dia import dia_spmm, dia_spmv
    from sblas_tpu_torch.ops.route import (LANES, lane_shuffle,
                                           lane_shuffle_plain,
                                           lane_shuffle_transposed)
    from sblas_tpu_torch.ops.rspmv import (SLAB, RoutedPlan, slab_gather,
                                           slab_gather_plain, tile_gather)
    from sblas_tpu_torch.ops.wcoo import k_chunk_width, window_reduce
    from sblas_tpu_torch.experiments.stage_fuse_probe import (
        stage_fuse_gather)
    from sblas_tpu_torch.experiments.wcoo_gather_probe import (
        window_lane_gather)

    counters = {"lane_shuffle": lane_shuffle,
                "lane_shuffle_transposed": lane_shuffle_transposed,
                "slab_gather": slab_gather,
                "tile_gather": tile_gather, "window_reduce": window_reduce,
                "bell_spmm": bell_spmm, "dia_spmm": dia_spmm,
                "dia_spmv": dia_spmv,
                "stage_fuse_gather": stage_fuse_gather,
                "window_lane_gather": window_lane_gather}
    none = {name: 0 for name in counters}

    # ---- build ----
    t0 = time.perf_counter()
    lib_path = _kernels.build()
    _kernels.library()
    build_s = time.perf_counter() - t0
    if not native.available():
        raise RuntimeError("native/libsblasio.so did not build or load: the "
                           "1M-row routed plan needs its edge colouring")
    phase("build", seconds=f"{build_s:.2f}",
          library=os.path.relpath(lib_path), native=native.available())

    # ---- main-path matrix and plan (their shapes feed the kernel phases)
    t0 = time.perf_counter()
    A = webbase_like(dtype=np.float32)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = make_plan(A, dtype=torch.float32, op="spmv", device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    if not isinstance(plan, RoutedPlan):
        raise AssertionError(f"make_plan chose {type(plan).__name__}, "
                             f"expected RoutedPlan")
    phase("plan", kind=type(plan).__name__, shape=A.shape, nnz=A.nnz,
          generate_s=f"{gen_s:.2f}", build_s=f"{plan_s:.2f}",
          route_n=plan.route_n, xroute_n=plan.xroute_n,
          unrank_n=plan.unrank_n, n_gtiles=plan.n_gtiles,
          n_prows=plan.n_prows, gather_fill=f"{plan.gather_fill:.3f}",
          stack_fill=f"{plan.stack_fill:.3f}",
          k1_per_spmv=plan.n_route_gathers)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kernels = {}

    # ---- K1: lane shuffle at the main route's (R, 128) ----
    R = plan.route_n // LANES
    x2d = torch.rand((R, LANES), generator=gen, device=dev)
    idx = torch.randint(0, LANES, (R, LANES), generator=gen, device=dev,
                        dtype=torch.int32)
    err, _, ms, plain_ms = compare(
        "lane_shuffle", lambda: lane_shuffle(x2d, idx),
        lambda: lane_shuffle_plain(x2d, idx), lane_shuffle)
    phase("K1 lane_shuffle", shape=(R, LANES), bitwise_equal=True,
          ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}")
    # the plain version is the one library call, torch.gather
    kernels["lane_shuffle"] = dict(
        name="lane_shuffle", route="cuda",
        source="sblas_tpu_torch/csrc/route_kernels.cu",
        replaces="sblas_tpu/ops/route.py:388", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=plain_ms,
        **bound(3 * nbytes(x2d), 0))
    del x2d, idx
    k1_transposed_phase(plan, kernels)

    # ---- K2: slab gather at the main path's T_g, with the plan's tables
    n_slabs = -(-A.shape[1] // SLAB)
    x_slabs = torch.rand((n_slabs, LANES, LANES), generator=gen, device=dev)
    err, _, ms, plain_ms = compare(
        "slab_gather",
        lambda: slab_gather(plan.gslab, x_slabs, plan.gidx, plan.gvals),
        lambda: slab_gather_plain(plan.gslab, x_slabs, plan.gidx,
                                  plan.gvals), slab_gather)
    phase("K2 slab_gather", n_gtiles=plan.n_gtiles, n_slabs=n_slabs,
          bitwise_equal=True, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}")
    kernels["slab_gather"] = dict(
        name="slab_gather", route="cuda",
        source="sblas_tpu_torch/csrc/rspmv_kernels.cu",
        replaces="sblas_tpu/ops/rspmv.py:582", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=None,
        **bound(nbytes(plan.gslab, x_slabs, plan.gidx, plan.gvals,
                       plan.gvals), 0))

    # ---- P1: K2 fused with route pass 1, at the full plan's T_g ----
    kernels["stage_fuse_gather"] = dict(
        name="stage_fuse_gather", route="cuda",
        source="sblas_tpu_torch/csrc/probe_kernels.cu",
        replaces="experiments/stage_fuse_probe.py:41", library_ms=None,
        **p1_compare(plan, x_slabs, "full webbase-1M plan"))
    del x_slabs

    # ---- SpMV main path: one counted SpMV, oracle check, then timing ----
    x = DenseVector.random(A.width, dtype=np.float32)
    y = DenseVector.constant(A.height, 1.0, dtype=np.float32)
    xd = torch.from_numpy(x.values).to(dev)
    yd = torch.from_numpy(y.values).to(dev)
    want = spmv_cpu(A, x, ALPHA, BETA, y)
    from sblas_tpu_torch.utils import trace
    k1 = k1_split(*routes_of(plan))
    with trace.recording() as rec:
        out, counts = launches_of(counters,
                                  lambda: spmv(plan, xd, ALPHA, BETA, yd))
    expect_launches("routed SpMV", counts, dict(none, **k1, slab_gather=1))
    ran = k1_k2_launches("routed SpMV", dict(**k1, slab_gather=1))
    transposes = (rec.counters.get("route_transposes_fused", 0),
                  rec.counters.get("route_transpose_copies", 0))
    if transposes != (counts["lane_shuffle_transposed"], 0):
        raise AssertionError(f"routed SpMV: transposes (fused, copies) "
                             f"{transposes}, K1 launches {counts}")
    for name in ("lane_shuffle", "lane_shuffle_transposed", "slab_gather"):
        kernels[name]["launches"] = counts[name]
    phase("main path", plan="RoutedPlan", launches=counts,
          by_variant=ran, transposes_fused=transposes[0],
          transpose_copies=transposes[1],
          check=checked("routed SpMV", out, want),
          **call_times(lambda: spmv(plan, xd, ALPHA, BETA, yd), A.nnz))
    k1k2 = k1_k2_at("K1/K2 variants", "webbase-1M plan", plan, ran)
    f64_routed(A, plan, xd, yd, want, k1k2, counters, none, kernels)

    # ---- tier 0: COO SpMV on the same matrix ----
    coo = make_plan(A, dtype=torch.float32, force="coo", device=dev)
    phase("tier0 coo", check=checked(
        "COO SpMV", spmv(coo, xd, ALPHA, BETA, yd), want),
          **call_times(lambda: spmv(coo, xd, ALPHA, BETA, yd), A.nnz))
    del coo, out
    bf16_routed_phases(A, plan, x, xd, yd, want, gen, counters, none,
                       kernels)
    del plan

    # ---- the distribution layer in a world-1 NCCL group ----
    mesh, mesh2 = nccl_world1(dev)
    dist_phases(A, xd, yd, want, mesh, mesh2, gen, counters, none, kernels)
    xfoot_phases(A, x, xd, yd, want, mesh, counters, none, kernels)
    del xd, yd
    solve_phases(A, mesh, counters, none)

    # ---- WCOO SpMM: webbase x K=64 -> WcooPlan -> K3 ----
    K = 64
    wplan = make_plan(A, dtype=torch.float32, op="spmm", device=dev)
    if not isinstance(wplan, WcooPlan):
        raise AssertionError(f"webbase SpMM plan {type(wplan).__name__}, "
                             f"expected WcooPlan")
    Bw = DenseMatrix.random(A.width, K, dtype=np.float32).values
    Cw = DenseMatrix.constant(A.height, K, 1.0, dtype=np.float32).values
    Bd, Cd = torch.from_numpy(Bw).to(dev), torch.from_numpy(Cw).to(dev)
    kc = k_chunk_width(wplan.n_tiles, K)
    k3_args = (wplan.k3, wplan.wb, wplan.relrow, wplan.vals, wplan.xblk,
               wplan.lane, Bd, 0, kc)
    A_csr = sparse_csr(A, dev)
    kernels["window_reduce"] = dict(
        name="window_reduce", route="cuda",
        source="sblas_tpu_torch/csrc/wcoo_kernels.cu",
        replaces="sblas_tpu/ops/wcoo.py:291",
        **k3_forms("K3 window_reduce", k3_args, Cd, A_csr, A.nnz,
                   FP32_FLOPS, rel_tol=F32_REL_TOL))
    del A_csr
    want = oracle_spmm(A, Bw, Cw)
    out, counts = launches_of(counters,
                              lambda: spmm(wplan, Bd, ALPHA, BETA, Cd))
    expect_launches("WCOO SpMM", counts,
                    dict(none, window_reduce=-(-K // kc)))
    kernels["window_reduce"]["launches"] = counts["window_reduce"]
    phase("wcoo spmm", plan="WcooPlan", K=K, fill=f"{wplan.fill_ratio:.3f}",
          launches=counts, check=checked("WCOO SpMM", out, want),
          **call_times(lambda: spmm(wplan, Bd, ALPHA, BETA, Cd), A.nnz, K))
    f64_wcoo(A, wplan, Bd, Cd, want, counters, none, kernels)
    wp16 = bf16_wcoo_phases(A, Bd, Cd, want, counters, none, kernels)
    spmm_dist_webbase(A, wplan, Bd, Cd, want, mesh, counters, none)
    um_webbase_phases(A, Bd, Cd, want, mesh, counters, none, kernels)
    bf16_dist_webbase(A, wp16, wplan, Bd, Cd, want, mesh, counters, none)
    um_bf16_phases(A, Bd, Cd, want, mesh, counters, none)
    del wplan, wp16, Cd, out, want
    p2_phase(A, Bd, counters, none, kernels)
    del Bd, A

    # ---- SpMM headline: shell x K=64 -> DiaPlan; tier-0 COO beside it
    S = fem_shell_like(dtype=np.float32)
    splan = make_plan(S, dtype=torch.float32, op="spmm", device=dev)
    if not isinstance(splan, DiaPlan):
        raise AssertionError(f"shell SpMM plan {type(splan).__name__}, "
                             f"expected DiaPlan")
    Bs = DenseMatrix.random(S.width, K, dtype=np.float32).values
    Cs = DenseMatrix.constant(S.height, K, 1.0, dtype=np.float32).values
    Bd, Cd = torch.from_numpy(Bs).to(dev), torch.from_numpy(Cs).to(dev)
    want = oracle_spmm(S, Bs, Cs)
    kernels["dia_spmm"] = k5_row(S, splan, Bd, Cd)
    out, counts = launches_of(counters,
                              lambda: spmm(splan, Bd, ALPHA, BETA, Cd))
    expect_launches("DIA SpMM", counts, dict(none, dia_spmm=1))
    variant_launches("DIA SpMM", {"dia_spmm_f32": 1})
    kernels["dia_spmm"]["launches"] = counts["dia_spmm"]
    phase("spmm headline", plan="DiaPlan", shape=S.shape, nnz=S.nnz, K=K,
          n_diags=len(splan.offsets), launches=counts,
          check=checked("DIA SpMM", out, want),
          **call_times(lambda: spmm(splan, Bd, ALPHA, BETA, Cd), S.nnz, K))
    coo = make_plan(S, dtype=torch.float32, force="coo", device=dev)
    phase("tier0 coo spmm", check=checked(
        "COO SpMM", spmm(coo, Bd, ALPHA, BETA, Cd), want),
          **call_times(lambda: spmm(coo, Bd, ALPHA, BETA, Cd), S.nnz, K))
    f64_dia(S, splan, Bd, Cd, want, counters, none, kernels)
    bf16_shell_phases(S, Bd, Cd, want, counters, none)
    bf16_shell_k4_record(S, Bd, Cd, want, counters, none)
    spmm_dist_shell(S, Bd, Cd, want, mesh, mesh2, counters, none)
    um_shell_phases(S, Bs, Cs, Bd, Cd, want, counters, none)
    import torch.distributed as dist
    dist.destroy_process_group()   # the CLIs below make their own groups
    del coo, Bd, Cd, out, want

    # ---- SpMV over the DIA plan (shell): K6 ----
    k6_phases(S, counters, none, kernels)
    del splan, S

    # ---- K4 and BELL SpMM: band-73 x K=256 -> BsrPlan -> K4 ----
    F = fem_banded_like(dtype=np.float32)
    bplan = make_plan(F, dtype=torch.float32, op="spmm", device=dev)
    if not isinstance(bplan, BsrPlan):
        raise AssertionError(f"band-73 SpMM plan {type(bplan).__name__}, "
                             f"expected BsrPlan")
    K4 = 256
    Bb = DenseMatrix.random(F.width, K4, dtype=np.float32).values
    Cb = DenseMatrix.constant(F.height, K4, 1.0, dtype=np.float32).values
    Bd, Cd = torch.from_numpy(Bb).to(dev), torch.from_numpy(Cb).to(dev)
    k4_args = (bplan.vals, bplan.bcol, Bd, Cd, ALPHA, BETA)
    err, rel, ms, plain_ms = compare(
        "bell_spmm", lambda: bell_spmm(*k4_args),
        lambda: bell_spmm_plain(*k4_args), bell_spmm, F32_REL_TOL)
    F_csr = sparse_csr(F, dev)
    lib_ms = _device_ms(lambda: torch.addmm(Cd, F_csr, Bd, beta=BETA,
                                            alpha=ALPHA))
    n_blocks = bell_stats(F)["n_blocks"]
    # f32-accurate work on this card: 3xTF32, three tensor-core products
    # per f32 product; the CUDA-core f32 bound is printed beside it
    k4_bytes = nbytes(bplan.vals, bplan.bcol, Bd, Cd, Cd)
    k4_flops = 2 * n_blocks * 128 * 128 * K4
    k4_bound = bound(k4_bytes, 3 * k4_flops, rate=TF32_FLOPS)
    phase("K4 bell_spmm", n_brows=bplan.vals.shape[0], slots=bplan.slots,
          n_blocks=n_blocks, K=K4, max_abs_err=f"{err:.3e}",
          rel_err=f"{rel:.3e}", tol=F32_REL_TOL, deterministic=True,
          ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=f"{lib_ms:.5f}",
          bound_ms=f"{k4_bound['bound_ms']:.5f}",
          bound_by=k4_bound["bound_by"],
          share_of_bound=f"{k4_bound['bound_ms'] / ms:.3f}",
          fp32_core_bound_ms=f"{bound(k4_bytes, k4_flops)['bound_ms']:.5f}")
    kernels["bell_spmm"] = dict(
        name="bell_spmm", route="cuda",
        source="sblas_tpu_torch/csrc/bsr_kernels.cu",
        replaces="sblas_tpu/ops/bsr_pallas.py:37", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, **k4_bound)
    del F_csr
    want = oracle_spmm(F, Bb, Cb)
    out, counts = launches_of(counters,
                              lambda: spmm(bplan, Bd, ALPHA, BETA, Cd))
    expect_launches("BELL SpMM K=256", counts, dict(none, bell_spmm=1))
    kernels["bell_spmm"]["launches"] = counts["bell_spmm"]
    phase("bell spmm", plan="BsrPlan", K=K4, launches=counts,
          check=checked("BELL SpMM K=256", out, want),
          **call_times(lambda: spmm(bplan, Bd, ALPHA, BETA, Cd), F.nnz, K4))
    f64_bell(F, bplan, Bd, Cd, n_blocks, counters, none, kernels)
    phase("f64", section_seconds=f"{sum(F64_SECONDS.values()):.1f}",
          **{f"{k}_s": f"{v:.1f}" for k, v in F64_SECONDS.items()})
    bp16 = bf16_bell_phases(F, Bd, Cd, want, counters, none, kernels)
    bf16_bell_mode1(F, bplan, bp16, Bd, Cd, want, counters, none)
    del bp16
    Bd, Cd = Bd[:, :K].contiguous(), Cd[:, :K].contiguous()
    want = want[:, :K]
    out, counts = launches_of(counters,
                              lambda: spmm(bplan, Bd, ALPHA, BETA, Cd))
    expect_launches("BELL SpMM K=64", counts, none)
    phase("bell spmm", plan="BsrPlan", K=K, launches=counts,
          check=checked("BELL SpMM K=64", out, want),
          **call_times(lambda: spmm(bplan, Bd, ALPHA, BETA, Cd), F.nnz, K))
    del Bd, Cd, out, want

    # ---- SpMV over the BELL plan (band-73) ----
    fv = make_plan(F, dtype=torch.float32, op="spmv", device=dev)
    _spmv_phase("bsr spmv", F, fv, BsrPlan, counters, none)
    del bplan, fv, F

    # ---- CLIs on the card: SpMV single and distp, SpMM methods 1, 2p ----
    from sblas_tpu_torch.cli import spmm_test, spmv_test
    from sblas_tpu_torch.io.mmio import write_mtx
    W = webbase_like(n=200_000, dtype=np.float64)
    Wc = W.to_coo()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "webbase_200k.mtx")
        write_mtx(path, W.height, W.width, Wc.row_idx, Wc.col_idx,
                  Wc.values)
        text, rc = _cli(spmv_test.main, [path, str(ALPHA), str(BETA), "1",
                                         "f32", "--mode", "single",
                                         "--device", "cuda"])
        if rc != 0 or "Validation = True" not in text or \
                "plan RoutedPlan" not in text:
            raise AssertionError(f"CLI single mode failed (rc={rc}):\n{text}")
        run_line = next(ln for ln in text.splitlines() if "run time" in ln)
        phase("cli", rc=rc, nnz=W.nnz, plan="RoutedPlan", validation=True,
              run=run_line.strip())
        cli_bf16_phases(spmv_test.main, path, W.nnz, tmp)
        text, rc = _cli(spmm_test.main, ["1", path, str(K), str(ALPHA),
                                         str(BETA), "1", "f32", "--device",
                                         "cuda"])
        if rc != 0 or "Validation = True" not in text:
            raise AssertionError(f"spmm_test method 1 failed (rc={rc}):\n"
                                 f"{text}")
        lines = text.splitlines()
        phase("cli spmm", rc=rc, nnz=W.nnz, K=K, validation=True,
              plan=next(ln for ln in lines if "plan" in ln).split()[-1],
              run=next(ln for ln in lines if "run time" in ln).strip(),
              gflops=next(ln for ln in lines if "GFLOPS" in ln).split()[-1])
        text, rc = _cli(spmv_test.main, [path, str(ALPHA), str(BETA), "1",
                                         "f32", "--mode", "distp",
                                         "--device", "cuda"])
        if rc != 0 or "Validation = True" not in text or \
                "kind=routed" not in text:
            raise AssertionError(f"CLI --mode distp failed (rc={rc}):\n"
                                 f"{text}")
        phase("cli distp", rc=rc, nnz=W.nnz, kind="routed", validation=True,
              run=next(ln for ln in text.splitlines()
                       if "run time" in ln).strip())
        xfoot_argv = [path, str(ALPHA), str(BETA), "1", "f32", "--mode",
                      "xfoot", "--device", "cuda"]
        cache = os.path.join(tmp, "xfoot_shards.npz")
        for label, argv, said in (
                ("cli xfoot", xfoot_argv, "mode xfoot"),
                ("cli xfoot --plan-cache",
                 [*xfoot_argv, "--plan-cache", cache], "plan cache: saved"),
                ("cli xfoot --plan-cache",
                 [*xfoot_argv, "--plan-cache", cache],
                 "plan cache: loaded")):
            text, rc = _cli(spmv_test.main, argv)
            if rc != 0 or "Validation = True" not in text or \
                    said not in text:
                raise AssertionError(f"{label} failed (rc={rc}):\n{text}")
            lines = text.splitlines()
            phase(label, rc=rc, nnz=W.nnz, validation=True,
                  cache=said if "cache" in said else "none",
                  shards=next(ln for ln in lines if "xfoot shards" in ln
                              ).strip(),
                  load=next(ln for ln in lines if "Load time" in ln).strip(),
                  run=next(ln for ln in lines if "run time" in ln).strip())
        um_cli_phases(path, W.nnz, K)
        text, rc = _cli(spmm_test.main, ["2p", path, str(K), str(ALPHA),
                                         str(BETA), "1", "f32", "--device",
                                         "cuda"])
    if rc != 0 or "Validation = True" not in text:
        raise AssertionError(f"spmm_test method 2p failed (rc={rc}):\n{text}")
    lines = text.splitlines()
    phase("cli spmm 2p", rc=rc, nnz=W.nnz, K=K, validation=True,
          shards=next(ln for ln in lines if "kind=" in ln).strip(),
          run=next(ln for ln in lines if "run time" in ln).strip(),
          gflops=next(ln for ln in lines if "GFLOPS" in ln).split()[-1])
    from sblas_tpu_torch.cli import unit_test
    text, rc = _cli(unit_test.main, ["--device", "cuda"])
    if rc != 0 or "Validation = True" not in text:
        raise AssertionError(f"unit_test failed (rc={rc}):\n{text}")
    phase("unit_test", rc=rc, validation=True, tests=sum(
        ln.endswith(": PASS") for ln in text.splitlines()))
    profiling_phase(dev)
    bench_phase(card)
    phase("total", seconds=f"{time.perf_counter() - T_START:.1f}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
            "library_ms")
    # K3's launches in [um]'s streamed SpMM; K3's grid form beside its
    # fused one
    extra = ("um_launches", "grid_ms", "grid_bound_ms", "sparse_mm_ms",
             # P1 at the n=16 xfoot shard beside its full-plan reading
             "shard16_n_gtiles", "shard16_ms", "shard16_plain_ms",
             "shard16_bound_ms", "shard16_max_abs_err",
             # K4[f64]'s bound on the f64 CUDA cores beside its
             # tensor-core one
             "cuda_core_bound_ms",
             # K5's bound as the benchmark counts A (CSR), beside its own
             # (DIA values), and torch.sparse.mm beside torch.addmm
             "csr_bound_ms")
    for rec in kernels.values():
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        missing = [k for k in keys if k not in rec]
        if missing or rec["launches"] < 1:
            raise AssertionError(f"kernel {rec['name']}: missing {missing} "
                                 f"or not launched on its main path")
    print(json.dumps({"kernels": [
        {k: rec[k] for k in keys + extra if k in rec}
        for rec in kernels.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k5_record(S, plan, Bd, Cd, rel_tol) -> dict:
    """K5 against the plain `addcmul_` loop on `plan` x (Bd, Cd) (normwise
    `rel_tol`, two launches bitwise), `torch.addmm` and `torch.sparse.mm`
    on a CSR copy of S in B's dtype as yardsticks, and K5's bound by its
    own bytes (the DIA values, B, C and C' once) and by the SpMM's bytes
    as `benchmark/harness/work.py` counts them (A as CSR: values, 32-bit
    column indices and row pointers), 2 nnz K operations at the f32 (f64)
    CUDA-core rate: its `kernels` record, `launches` to fill in."""
    from sblas_tpu_torch.ops.dia import dia_spmm, spmm_dia_plain
    variant = "f64" if Bd.dtype == torch.float64 else "f32"
    err, _, ms, plain_ms = compare(
        f"dia_spmm[{variant}]", lambda: dia_spmm(plan, Bd, Cd, ALPHA, BETA),
        lambda: spmm_dia_plain(plan, Bd, ALPHA, BETA, Cd), dia_spmm,
        rel_tol)
    S_csr = sparse_csr(S, Bd.device, Bd.dtype)
    lib_ms = _device_ms(lambda: torch.addmm(Cd, S_csr, Bd, beta=BETA,
                                            alpha=ALPHA))
    mm_ms = _device_ms(lambda: torch.sparse.mm(S_csr, Bd))
    del S_csr
    (m, n), k, vb = plan.shape, Bd.shape[1], Bd.element_size()
    rate = FP64_FLOPS if variant == "f64" else FP32_FLOPS
    flops, dense = 2 * S.nnz * k, (n * k + 2 * m * k) * vb
    csr = S.nnz * (vb + 4) + (m + 1) * 4
    return dict(name="dia_spmm" + ("[f64]" if variant == "f64" else ""),
                route="cuda", source="sblas_tpu_torch/csrc/dia_kernels.cu",
                replaces="none (sblas_tpu/ops/dia.py leaves DIA to XLA)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                sparse_mm_ms=mm_ms,
                csr_bound_ms=bound(csr + dense, flops, rate)["bound_ms"],
                **bound(plan.vals.numel() * vb + dense, flops, rate))


def k5_row(S, splan, Bd, Cd) -> dict:
    """[K5 dia_spmm]: `k5_record` at the shell x K in f32, with K5's
    registers and spills from the build's `-Xptxas -v` report."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops.dia import dia_runs
    rec = k5_record(S, splan, Bd, Cd, F32_REL_TOL)
    res = _kernels.kernel_resources(_kernels.ptxas_report() or "",
                                    "dia_spmm_kernel")
    phase("K5 dia_spmm", shape=S.shape, nnz=S.nnz, K=Bd.shape[1],
          n_diags=len(splan.offsets), runs=len(dia_runs(splan.offsets)),
          max_abs_err=f"{rec['max_abs_err']:.3e}", deterministic=True,
          ms=f"{rec['ms']:.5f}", bound_ms=f"{rec['bound_ms']:.5f}",
          bound_by=rec["bound_by"],
          share_of_bound=f"{rec['bound_ms'] / rec['ms']:.3f}",
          csr_bound_ms=f"{rec['csr_bound_ms']:.5f}",
          csr_share=f"{rec['csr_bound_ms'] / rec['ms']:.3f}",
          plain_ms=f"{rec['plain_ms']:.5f}",
          library_ms=f"{rec['library_ms']:.5f}",
          sparse_mm_ms=f"{rec['sparse_mm_ms']:.5f}",
          resources=[(r["registers"], r["spill_stores"], r["spill_loads"])
                     for r in res])
    return rec


def k6_record(S, plan, xd, yd, rel_tol) -> dict:
    """K6 against the plain `addcmul_` loop on `plan` x (xd, yd) (normwise
    `rel_tol`, two launches bitwise), `torch.mv` and `torch.sparse.mm` on
    a CSR copy of S in x's dtype as yardsticks (the port calls neither),
    and K6's bound by its own bytes (the DIA values, x, y and y' once)
    and by the SpMV's bytes with A as CSR (values, 32-bit column indices
    and row pointers), 2 nnz operations at the f32 (f64) CUDA-core rate:
    its `kernels` record, `launches` to fill in."""
    from sblas_tpu_torch.ops.dia import dia_spmv, spmv_dia_plain
    variant = "f64" if xd.dtype == torch.float64 else "f32"
    err, _, ms, plain_ms = compare(
        f"dia_spmv[{variant}]", lambda: dia_spmv(plan, xd, yd, ALPHA, BETA),
        lambda: spmv_dia_plain(plan, xd, ALPHA, BETA, yd), dia_spmv,
        rel_tol)
    S_csr = sparse_csr(S, xd.device, xd.dtype)
    lib_ms = _device_ms(lambda: torch.mv(S_csr, xd))
    mm_ms = _device_ms(lambda: torch.sparse.mm(S_csr, xd[:, None]))
    del S_csr
    (m, n), vb = plan.shape, xd.element_size()
    rate = FP64_FLOPS if variant == "f64" else FP32_FLOPS
    flops, dense = 2 * S.nnz, (n + 2 * m) * vb
    csr = S.nnz * (vb + 4) + (m + 1) * 4
    return dict(name="dia_spmv" + ("[f64]" if variant == "f64" else ""),
                route="cuda", source="sblas_tpu_torch/csrc/dia_kernels.cu",
                replaces="none (sblas_tpu/ops/dia.py leaves DIA to XLA)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                sparse_mm_ms=mm_ms,
                csr_bound_ms=bound(csr + dense, flops, rate)["bound_ms"],
                **bound(plan.vals.numel() * vb + dense, flops, rate))


def k6_phases(S, counters, none, kernels) -> None:
    """[K6 dia_spmv] and the DIA SpMV: `k6_record` on the shell's SpMV
    plan (`make_plan(op="spmv")`, DIA) in f32 with K6's registers and
    spills from the build's `-Xptxas -v` report, then `spmv` on that plan
    (one K6 launch, against the oracle, timed); then `[f64]` K6[f64], the
    same on the plan cast to f64 (`cast_plan`; 1e-12 normwise)."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.containers import DenseVector
    from sblas_tpu_torch.ops import DiaPlan, make_plan, spmv
    from sblas_tpu_torch.ops.cpu_reference import spmv_cpu
    dev = torch.device("cuda", 0)
    sv = make_plan(S, dtype=torch.float32, op="spmv", device=dev)
    if not isinstance(sv, DiaPlan):
        raise AssertionError(f"shell SpMV plan {type(sv).__name__}, "
                             f"expected DiaPlan")
    x = DenseVector.random(S.width, dtype=np.float32)
    y = DenseVector.constant(S.height, 1.0, dtype=np.float32)
    xd = torch.from_numpy(x.values).to(dev)
    yd = torch.from_numpy(y.values).to(dev)
    want = spmv_cpu(S, x, ALPHA, BETA, y)
    rec = kernels["dia_spmv"] = k6_record(S, sv, xd, yd, F32_REL_TOL)
    res = _kernels.kernel_resources(_kernels.ptxas_report() or "",
                                    "dia_spmv_kernel")
    out, counts = launches_of(counters,
                              lambda: spmv(sv, xd, ALPHA, BETA, yd))
    expect_launches("DIA SpMV", counts, dict(none, dia_spmv=1))
    variant_launches("DIA SpMV", {"dia_spmv_f32": 1})
    rec["launches"] = counts["dia_spmv"]
    phase("K6 dia_spmv", shape=S.shape, nnz=S.nnz,
          n_diags=len(sv.offsets), max_abs_err=f"{rec['max_abs_err']:.3e}",
          deterministic=True, ms=f"{rec['ms']:.5f}",
          bound_ms=f"{rec['bound_ms']:.5f}", bound_by=rec["bound_by"],
          share_of_bound=f"{rec['bound_ms'] / rec['ms']:.3f}",
          csr_bound_ms=f"{rec['csr_bound_ms']:.5f}",
          csr_share=f"{rec['csr_bound_ms'] / rec['ms']:.3f}",
          plain_ms=f"{rec['plain_ms']:.5f}",
          library_ms=f"{rec['library_ms']:.5f}",
          sparse_mm_ms=f"{rec['sparse_mm_ms']:.5f}",
          resources=[(r["registers"], r["spill_stores"], r["spill_loads"])
                     for r in res])
    phase("dia spmv", plan="DiaPlan", shape=S.shape, nnz=S.nnz,
          launches=counts, check=checked("DIA SpMV", out, want),
          **call_times(lambda: spmv(sv, xd, ALPHA, BETA, yd), S.nnz))
    t0 = time.perf_counter()
    sv64 = cast_plan(sv, torch.float64)
    x64, y64 = xd.double(), yd.double()
    rec = kernels["dia_spmv[f64]"] = k6_record(S, sv64, x64, y64,
                                                F64_REL_TOL)
    out, counts = launches_of(counters,
                              lambda: spmv(sv64, x64, ALPHA, BETA, y64))
    expect_launches("DIA SpMV f64", counts, dict(none, dia_spmv=1))
    variant_launches("DIA SpMV f64", {"dia_spmv_f64": 1})
    rec["launches"] = counts["dia_spmv"]
    f64_line("dia_spmv", rec, plan="shell SpMV DIA cast to f64",
             csr_bound_ms=f"{rec['csr_bound_ms']:.5f}",
             sparse_mm_ms=f"{rec['sparse_mm_ms']:.5f}",
             check=checked("DIA SpMV f64", out, want))
    F64_SECONDS["dia_spmv"] = time.perf_counter() - t0


def f64_dia(S, splan, Bd, Cd, want, counters, none, kernels) -> None:
    """[f64] K5[f64]: `k5_record` on the shell's plan cast to f64
    (`cast_plan`; 1e-12 normwise); then `spmm` on that plan: one K5 f64
    launch, against the oracle."""
    from sblas_tpu_torch.ops import spmm
    t0 = time.perf_counter()
    sp64 = cast_plan(splan, torch.float64)
    B64, C64 = Bd.double(), Cd.double()
    rec = kernels["dia_spmm[f64]"] = k5_record(S, sp64, B64, C64,
                                                F64_REL_TOL)
    out, counts = launches_of(counters,
                              lambda: spmm(sp64, B64, ALPHA, BETA, C64))
    expect_launches("DIA SpMM f64", counts, dict(none, dia_spmm=1))
    variant_launches("DIA SpMM f64", {"dia_spmm_f64": 1})
    rec["launches"] = counts["dia_spmm"]
    f64_line("dia_spmm", rec, plan="shell DIA cast to f64", K=Bd.shape[1],
             csr_bound_ms=f"{rec['csr_bound_ms']:.5f}",
             sparse_mm_ms=f"{rec['sparse_mm_ms']:.5f}",
             check=checked("DIA SpMM f64", out, want))
    F64_SECONDS["dia"] = time.perf_counter() - t0


def f64_routed(A, plan, xd, yd, want, k1k2, counters, none,
               kernels) -> None:
    """[f64] on the webbase-1M routed plan at f64 values (the f32 plan's
    tables, `cast_plan`; `choose_kind` must pick routed at f64): K2' and
    P1 against their plain versions at the plan's tiles; the routed SpMV
    (K1 and K2 f64, counted by variant and body), the same through K2'
    (`pregather`, the distributed shard's branch) and through P1
    (`spmv_routed_fused1`), each against the oracle.  K1's and K2's f64
    rows are `[K1/K2 variants]`' readings (`k1k2`) at the same plan."""
    from sblas_tpu_torch.experiments.stage_fuse_probe import (
        spmv_routed_fused1)
    from sblas_tpu_torch.ops import choose_kind, spmv
    from sblas_tpu_torch.ops.rspmv import (SLAB, spmv_routed, tile_gather,
                                           tile_gather_plain)
    t0 = time.perf_counter()
    dev, f64 = xd.device, torch.float64
    if choose_kind(A, f64, op="spmv") != "routed":
        raise AssertionError("webbase-1M at f64: make_plan(op='spmv') "
                             "does not choose routed")
    p64 = cast_plan(plan, f64)
    x64, y64 = xd.double(), yd.double()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 64)
    x_slabs = torch.rand((-(-A.shape[1] // SLAB), 128, 128), generator=gen,
                         device=dev, dtype=f64)
    x_tiles = torch.index_select(x_slabs, 0, p64.gslab)
    targs = (x_tiles, p64.gidx, p64.gvals)
    err, _, ms, plain_ms = compare(
        "tile_gather[f64]", lambda: tile_gather(*targs),
        lambda: tile_gather_plain(*targs), tile_gather)
    kernels["tile_gather[f64]"] = kernel_rec(
        "tile_gather", "f64", "rspmv_kernels.cu",
        "sblas_tpu/ops/rspmv.py:592", err, ms, plain_ms, None,
        bound(nbytes(*targs, p64.gvals), 0))
    del x_tiles, targs
    kernels["stage_fuse_gather[f64]"] = dict(
        name="stage_fuse_gather[f64]", route="cuda",
        source="sblas_tpu_torch/csrc/probe_kernels.cu",
        replaces="experiments/stage_fuse_probe.py:41", library_ms=None,
        **p1_compare(p64, x_slabs, "full webbase-1M plan, f64"))
    del x_slabs
    for name, src, at in (("lane_shuffle", "route_kernels.cu",
                           "sblas_tpu/ops/route.py:388"),
                          ("slab_gather", "rspmv_kernels.cu",
                           "sblas_tpu/ops/rspmv.py:582")):
        r = k1k2[name, "f64"]
        kernels[f"{name}[f64]"] = kernel_rec(
            name, "f64", src, at, r["max_abs_err"], r["ms"], r["plain_ms"],
            r["library_ms"], {k: r[k] for k in ("bound_ms", "bound_by")})

    k1_transposed_phase(p64, kernels, "f64")

    routes = routes_of(p64)
    k1 = k1_split(*routes)
    out, counts = launches_of(counters,
                              lambda: spmv(p64, x64, ALPHA, BETA, y64))
    expect_launches("routed SpMV f64", counts,
                    dict(none, **k1, slab_gather=1))
    by_variant = variant_launches("routed SpMV f64", {
        **k1_variants("f64", *routes), "slab_gather_f64": 1})
    k1_k2_launches("routed SpMV f64", dict(**k1, slab_gather=1))
    for name in ("lane_shuffle", "lane_shuffle_transposed", "slab_gather"):
        kernels[f"{name}[f64]"]["launches"] = by_variant.get(f"{name}_f64",
                                                            0)
    phase("f64", path="spmv RoutedPlan webbase-1M f64", launches=counts,
          by_variant=by_variant, check=checked("routed SpMV f64", out, want),
          **call_times(lambda: spmv(p64, x64, ALPHA, BETA, y64), A.nnz))
    # P1 does the main route's first gather (the peeled rows' part of it
    # stays a K1 row body): the rest of that route starts with a
    # transpose, which stays a copy
    for title, run, kname, k1_routes, peel in (
            ("spmv_routed f64 pregather (K2prime)",
             lambda: spmv_routed(p64, x64, ALPHA, BETA, y64, pregather=True),
             "tile_gather", routes, 0),
            ("spmv_routed_fused1 f64 (P1)",
             lambda: spmv_routed_fused1(p64, x64, ALPHA, BETA, y64),
             "stage_fuse_gather", (routes[0], routes[1][1:], routes[2]),
             int(p64.n_prows > 0))):
        out, counts = launches_of(counters, run)
        if (counts[kname] != 1 or counts["slab_gather"]
                or counts["lane_shuffle"] < 1):
            raise AssertionError(f"{title}: kernel launches {counts}")
        want_k1 = k1_variants("f64", *k1_routes)
        want_k1["lane_shuffle_f64"] = want_k1.get("lane_shuffle_f64",
                                                  0) + peel
        variant_launches(title, {f"{kname}_f64": 1, **want_k1})
        kernels[f"{kname}[f64]"]["launches"] = 1
        phase("f64", path=f"{title} webbase-1M", launches=counts,
              check=checked(title, out, want), **call_times(run, A.nnz))
    del out
    for name in ("lane_shuffle", "lane_shuffle_transposed", "slab_gather",
                 "tile_gather", "stage_fuse_gather"):
        f64_line(name, kernels[f"{name}[f64]"], card=card_line())
    F64_SECONDS["routed"] = time.perf_counter() - t0


def f64_wcoo(A, wplan, Bd, Cd, want, counters, none, kernels) -> None:
    """[f64] on webbase x K at f64 values (the f32 WcooPlan's tables,
    `cast_plan`; `choose_kind` must pick wcoo at f64): K3[f64] in both
    store forms against its plain version (1e-12 normwise,
    deterministic), beside `torch.addmm` on A as an f64 CSR tensor; then
    the WCOO SpMM through K3[f64], counted, against the oracle."""
    from sblas_tpu_torch.ops import choose_kind, spmm
    from sblas_tpu_torch.ops.wcoo import k_chunk_width
    t0 = time.perf_counter()
    dev, f64, K = Bd.device, torch.float64, Bd.shape[1]
    if choose_kind(A, f64, op="spmm") != "wcoo":
        raise AssertionError("webbase-1M at f64: make_plan(op='spmm') "
                             "does not choose wcoo")
    wp64 = cast_plan(wplan, f64)
    B64, C64 = Bd.double(), Cd.double()
    kc = k_chunk_width(wp64.n_tiles, K)
    args = (wp64.k3, wp64.wb, wp64.relrow, wp64.vals, wp64.xblk, wp64.lane,
            B64, 0, kc)
    A_csr = sparse_csr(A, dev, f64)
    kernels["window_reduce[f64]"] = dict(
        name="window_reduce[f64]", route="cuda",
        source="sblas_tpu_torch/csrc/wcoo_kernels.cu",
        replaces="sblas_tpu/ops/wcoo.py:291",
        **k3_forms("K3 window_reduce[f64]", args, C64, A_csr, A.nnz,
                   FP64_FLOPS, rel_tol=F64_REL_TOL))
    del A_csr
    run = lambda: spmm(wp64, B64, ALPHA, BETA, C64)  # noqa: E731
    out, counts = launches_of(counters, run)
    expect_launches("WCOO SpMM f64", counts,
                    dict(none, window_reduce=-(-K // kc)))
    by_variant = variant_launches("WCOO SpMM f64",
                                  {"window_reduce_f64": -(-K // kc)})
    kernels["window_reduce[f64]"]["launches"] = counts["window_reduce"]
    phase("f64", path=f"spmm WcooPlan webbase-1M x K={K} f64",
          launches=counts, by_variant=by_variant,
          check=checked("WCOO SpMM f64", out, want),
          **call_times(run, A.nnz, K))
    del out
    f64_line("window_reduce", kernels["window_reduce[f64]"],
             tol=F64_REL_TOL, deterministic=True, card=card_line())
    F64_SECONDS["wcoo"] = time.perf_counter() - t0


def f64_bell(F, bplan, Bd, Cd, n_blocks, counters, none, kernels) -> None:
    """[f64] BELL: K4[f64] (mma.sync f64 on the tensor cores) against its
    plain version at the full band-73 plan at f64 values (the f32
    BsrPlan's tables, `cast_plan`: `make_plan(F, f64, force="bsr")`'s
    plan; unforced, the full band-73 takes DIA at f64, its 8-byte BELL
    bytes past `_BSR_DIA_SPMM_BYTES`) at K=256, 1e-12 normwise, two
    launches bitwise, beside `torch.addmm` on an f64 CSR; bound by the
    f64 tensor cores' rate, the CUDA cores' beside it; the DMMA kernels'
    registers and spills from the build's `-Xptxas -v` report (none may
    spill).  Then the path: `fem_banded_like(n=80_000)` at f64 through
    `make_plan(op="spmm")` unforced (a BsrPlan) and `spmm` at K=256, one
    K4[f64] launch, against the oracle on every third column."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.containers import DenseMatrix
    from sblas_tpu_torch.io.generate import fem_banded_like
    from sblas_tpu_torch.ops import BsrPlan, choose_kind, make_plan, spmm
    from sblas_tpu_torch.ops.bsr_pallas import (bell_spmm, bell_spmm_plain,
                                                f64_mma_shape)
    t0 = time.perf_counter()
    dev, f64, K = Bd.device, torch.float64, Bd.shape[1]
    report = _kernels.ptxas_report()
    if report is None:
        raise AssertionError("the kernel library has no -Xptxas -v report")
    dmma = _kernels.kernel_resources(report, "bell_spmm_dmma_kernel")
    if len(dmma) != 2 or any(r["spill_stores"] or r["spill_loads"]
                             for r in dmma):
        raise AssertionError(f"K4[f64]'s DMMA kernels: {dmma}")
    bp64 = cast_plan(bplan, f64)
    B64, C64 = Bd.double(), Cd.double()
    args = (bp64.vals, bp64.bcol, B64, C64, ALPHA, BETA)
    err, rel, ms, plain_ms = compare(
        "bell_spmm[f64]", lambda: bell_spmm(*args),
        lambda: bell_spmm_plain(*args), bell_spmm, F64_REL_TOL)
    F_csr = sparse_csr(F, dev, f64)
    lib_ms = _device_ms(lambda: torch.addmm(C64, F_csr, B64, beta=BETA,
                                            alpha=ALPHA))
    del F_csr
    k4_bytes = nbytes(bp64.vals, bp64.bcol, B64, C64, C64)
    k4_flops = 2 * n_blocks * 128 * 128 * K
    bnd = bound(k4_bytes, k4_flops, rate=FP64_TC_FLOPS)
    core = bound(k4_bytes, k4_flops, rate=FP64_FLOPS)["bound_ms"]
    kernels["bell_spmm[f64]"] = dict(
        kernel_rec("bell_spmm", "f64", "bsr_kernels.cu",
                   "sblas_tpu/ops/bsr_pallas.py:37", err, ms, plain_ms,
                   lib_ms, bnd), cuda_core_bound_ms=core)
    del bp64, args, B64, C64

    G = fem_banded_like(n=80_000, dtype=np.float64)
    t1 = time.perf_counter()
    gplan = make_plan(G, dtype=f64, op="spmm", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    if not isinstance(gplan, BsrPlan):
        raise AssertionError(f"fem_banded_like(n=80_000) f64 SpMM plan "
                             f"{type(gplan).__name__}, expected BsrPlan")
    Bg = DenseMatrix.random(G.width, K, dtype=np.float64).values
    Cg = DenseMatrix.constant(G.height, K, 1.0, dtype=np.float64).values
    Bgd, Cgd = torch.from_numpy(Bg).to(dev), torch.from_numpy(Cg).to(dev)
    run = lambda: spmm(gplan, Bgd, ALPHA, BETA, Cgd)  # noqa: E731
    out, counts = launches_of(counters, run)
    expect_launches("BELL SpMM f64 K=256", counts, dict(none, bell_spmm=1))
    by_variant = variant_launches("BELL SpMM f64 K=256",
                                  {"bell_spmm_f64": 1})
    bodies = dict(_kernels.BODIES)
    if bodies != {"bell_spmm_f64.dmma": 1}:
        raise AssertionError(f"BELL SpMM f64 K=256: bodies {bodies}")
    kernels["bell_spmm[f64]"]["launches"] = 1
    # the oracle on every third column (spmm_cpu takes 28 s for all 256
    # on the card's host): every column tile, both columns of each
    # accumulator pair, every row
    cols = np.arange(0, K, 3)
    t1 = time.perf_counter()
    want = oracle_spmm(G, np.ascontiguousarray(Bg[:, cols]),
                       np.ascontiguousarray(Cg[:, cols]))
    oracle_s = time.perf_counter() - t1
    phase("f64", path=f"spmm BsrPlan fem_banded_like(n=80_000) x K={K} "
          f"f64 (unforced; the full band-73 at f64 chooses "
          f"{choose_kind(F, f64, op='spmm')})",
          build_s=f"{build_s:.2f}", oracle_s=f"{oracle_s:.2f}",
          n_brows=gplan.vals.shape[0], slots=gplan.slots, launches=counts,
          by_variant=by_variant, bodies=bodies, oracle_columns=len(cols),
          check=checked("BELL SpMM f64 K=256",
                        out[:, torch.from_numpy(cols).to(dev)], want),
          **call_times(run, G.nnz, K))
    del out, want, gplan, Bgd, Cgd
    f64_line("bell_spmm", kernels["bell_spmm[f64]"], plan="band-73 forced",
             n_brows=bplan.vals.shape[0], slots=bplan.slots,
             n_blocks=n_blocks, K=K, mma=f64_mma_shape(),
             dmma_kernels=[(r["registers"], r["spill_stores"],
                            r["spill_loads"]) for r in dmma],
             rel_err=f"{rel:.3e}", tol=F64_REL_TOL, deterministic=True,
             cuda_core_bound_ms=f"{core:.5f}", card=card_line())
    F64_SECONDS["bell"] = time.perf_counter() - t0


def nccl_world1(dev):
    """A world-1 NCCL group on `dev` (a failed initialisation raises), its
    mesh and its 1x1 two-tier mesh, built once for every phase (each
    group holds an NCCL communicator until the group is destroyed)."""
    from sblas_tpu_torch.cli.common import group_of_one
    from sblas_tpu_torch.parallel import (init_distributed, make_mesh,
                                          make_mesh2)
    init_distributed(backend="nccl", device_id=dev, **group_of_one())
    return make_mesh(1, device=dev), make_mesh2(1, 1, device=dev)


def dist_timing(steps: dict, nnz: int) -> None:
    """[dist timing]: the distributed routed SpMV's compute alone
    (nocomm), the compute placed in its full-height partial, and the whole
    call, timed in turns (A B C C B A) so a drift in host speed shows as
    two readings of one step; then one profiled window of the whole call,
    per op."""
    from sblas_tpu_torch.utils.timing import device_time_ms, wall_time_ms
    reads = {name: [] for name in steps}
    for name in [*steps, *reversed(steps)]:
        reads[name].append((wall_time_ms(steps[name], warmup=5, reps=30),
                            device_time_ms(steps[name], warmup=5, reps=30)))
    mean = {name: np.mean(r, axis=0) for name, r in reads.items()}
    F32_RECORD.update({name: float(m[1]) for name, m in mean.items()})
    for name, r in reads.items():
        phase("dist timing", step=name,
              wall_ms=" / ".join(f"{w:.5f}" for w, _ in r),
              device_ms=" / ".join(f"{d:.5f}" for _, d in r),
              nnz_per_s=f"{nnz / (mean[name][0] * 1e-3):.4e}")
    (wall0, dev0), (wall1, dev1), (wall2, dev2) = mean.values()
    phase("dist timing", placement_device_ms=f"{dev1 - dev0:.5f}",
          exposed_comm_device_ms=f"{dev2 - dev1:.5f}",
          exposed_comm_wall_ms=f"{wall2 - wall0:.5f}",
          idle_share=f"{max(1.0 - dev2 / wall2, 0.0):.3f}")
    calls, run = 20, list(steps.values())[-1]
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    ops = list(prof.key_averages())

    def per_call(key):
        return sorted(((ev.key, ev.self_cpu_time_total / calls,
                        getattr(ev, "self_device_time_total", 0.0) / calls)
                       for ev in ops), key=key)[:5]

    for by, key in (("host", lambda r: -r[1]), ("device", lambda r: -r[2])):
        phase("dist profile", top5_by=by, calls=calls, ops="; ".join(
            f"{k}: host_us={h:.1f} device_us={d:.1f}"
            for k, h, d in per_call(key)))


def dist_phases(A, xd, yd, want, mesh, mesh2, gen, counters, none,
                kernels) -> None:
    """[dist], [k2p] and [shards4] on the webbase-1M proxy: the routed
    per-shard SpMV through K2', the COO-segment mode 2 and the 1x1 hier
    mode in the world-1 group, then the same matrix cut 4 ways."""
    from sblas_tpu_torch.ops.rspmv import (SLAB, routed_shard_sizes,
                                           tile_gather, tile_gather_plain)
    from sblas_tpu_torch.parallel import (Mesh, partition_row_plans,
                                          spmv_dist,
                                          spmv_dist_hier, spmv_dist_planned,
                                          spmv_dist_planned_nocomm)
    from sblas_tpu_torch.parallel.planned import (_local_csr,
                                                  _row_boundaries,
                                                  full_height)
    from sblas_tpu_torch.partition import partition_nnz_balanced
    dev, f32 = mesh.device, torch.float32
    t0 = time.perf_counter()
    sh1 = partition_row_plans(A, 1, dtype=f32, op="spmv", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if sh1.kind != "routed":
        raise AssertionError(f"world-1 shards are {sh1.kind}, expected "
                             f"routed")
    p1 = sh1.local(0)

    # K2' against its plain version at the shard's tables
    n_slabs = -(-A.shape[1] // SLAB)
    x_slabs = torch.rand((n_slabs, 128, 128), generator=gen, device=dev)

    def k2p(plan, title):
        x_tiles = torch.index_select(x_slabs, 0, plan.gslab)
        args = (x_tiles, plan.gidx, plan.gvals)
        err, _, ms, plain_ms = compare(
            "tile_gather", lambda: tile_gather(*args),
            lambda: tile_gather_plain(*args), tile_gather)
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   **bound(nbytes(*args, plan.gvals), 0))
        phase("k2p", shapes=title, n_gtiles=plan.n_gtiles,
              bitwise_equal=True, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
              bound_ms=f"{rec['bound_ms']:.5f}", bound_by=rec["bound_by"])
        return rec

    kernels["tile_gather"] = dict(
        name="tile_gather", route="cuda",
        source="sblas_tpu_torch/csrc/rspmv_kernels.cu",
        replaces="sblas_tpu/ops/rspmv.py:592", library_ms=None,
        **k2p(p1, "world-1 shard of webbase-1M"))

    routed = dict(none, **k1_split(*routes_of(p1)), tile_gather=1)
    for reduce in ("psum", "psum_scatter"):
        out, counts = launches_of(counters, lambda: spmv_dist_planned(
            sh1, xd, ALPHA, BETA, yd, mesh, reduce=reduce))
        expect_launches(f"spmv_dist_planned {reduce}", counts, routed)
        phase("dist", path=f"spmv_dist_planned {reduce}", kind=sh1.kind,
              band_rows=sh1.band_rows, n_gtiles=p1.n_gtiles,
              build_s=f"{build_s:.2f}", launches=counts,
              check=checked(f"spmv_dist_planned {reduce}", out, want))
    kernels["tile_gather"]["launches"] = counts["tile_gather"]
    m_full = -(-(A.shape[0] + sh1.band_rows) // 128) * 128
    dist_timing({
        "nocomm": lambda: spmv_dist_planned_nocomm(sh1, xd, mesh),
        "nocomm+placement": lambda: full_height(
            spmv_dist_planned_nocomm(sh1, xd, mesh), 0, m_full),
        "spmv_dist_planned psum": lambda: spmv_dist_planned(
            sh1, xd, ALPHA, BETA, yd, mesh)}, A.nnz)

    segs = partition_nnz_balanced(A, 1, dtype=f32, device=dev)
    out, counts = launches_of(counters, lambda: spmv_dist(
        segs, xd, ALPHA, BETA, yd, mesh))
    expect_launches("spmv_dist", counts, none)
    phase("dist", path="spmv_dist psum (COO segments)", launches=counts,
          check=checked("spmv_dist", out, want),
          **recorded("spmv_dist", call_times(
              lambda: spmv_dist(segs, xd, ALPHA, BETA, yd, mesh), A.nnz)))
    del segs
    out, counts = launches_of(counters, lambda: spmv_dist_hier(
        sh1, xd, ALPHA, BETA, yd, mesh2))
    expect_launches("spmv_dist_hier", counts, routed)
    phase("dist", path="spmv_dist_hier 1x1", launches=counts,
          check=checked("spmv_dist_hier", out, want))
    del sh1, p1
    bf16_transport_dist(
        A, xd, yd, want, mesh, counters, none, kernels,
        lambda *a, **k: partition_row_plans(*a, op="spmv", **k),
        lambda sh: spmv_dist_planned(sh, xd, ALPHA, BETA, yd, mesh),
        "spmv_dist_planned psum bf16 transport")

    # ---- [shards4]: four ranks' compute, one after another on the card
    t0 = time.perf_counter()
    sh4 = partition_row_plans(A, 4, dtype=f32, op="spmv", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bounds = _row_boundaries(A, 4)
    natural = [routed_shard_sizes(_local_csr(A, int(bounds[s]),
                                             int(bounds[s + 1]),
                                             sh4.band_rows))[0]
               for s in range(4)]
    m = A.shape[0]
    m_full = -(-(m + sh4.band_rows) // 512) * 512

    def run4():
        total = torch.zeros(m_full, dtype=f32, device=dev)
        for s in range(4):
            local = spmv_dist_planned_nocomm(sh4, xd, Mesh(None, s, 4, dev))
            total += full_height(local, sh4.row_offsets[s], m_full)
        return BETA * yd + ALPHA * total[:m]

    out, counts = launches_of(counters, run4)
    expect_launches("shards4", counts, dict(
        none, tile_gather=4, **k1_split(*routes_of(*sh4.plans))))
    phase("shards4", kind=sh4.kind, band_rows=sh4.band_rows,
          n_gtiles_shared=sh4.local(0).n_gtiles, n_gtiles_natural=natural,
          build_s=f"{build_s:.2f}", launches=counts,
          check=checked("shards4", out, want))
    k2p(sh4.local(0), "shard 0 of 4")
    del sh4


def bf16_routed_phases(A, plan, x, xd, yd, want, gen, counters, none,
                       kernels) -> None:
    """[bf16-kernels] K1 on bf16 lanes with the int16 main-route tables and
    K2/K2' storing bf16, at the webbase-1M plan's shapes; [bf16-transport]
    the routed SpMV re-aimed with `with_transport("bf16")`, gated at 2e-3
    and timed beside f32 in turns; [bf16-plans] the routed SpMV of a plan
    with bf16 values (K1 bf16/i32, K2 bf16), also through K2'
    (`pregather`)."""
    from sblas_tpu_torch.ops import make_plan, spmv
    from sblas_tpu_torch.ops.route import LANES, lane_shuffle, \
        lane_shuffle_plain
    from sblas_tpu_torch.ops.rspmv import (SLAB, slab_gather,
                                           slab_gather_plain, spmv_routed,
                                           tile_gather, tile_gather_plain)
    dev = xd.device
    plan16 = plan.with_transport("bf16")

    def k1(p, variant, title):
        """K1 at `p`'s first main-route table; its library call is
        torch.gather on int32 indices."""
        idx = p.tables[0]
        x2d = torch.rand(idx.shape, generator=gen, device=dev).to(BF16)
        idx32 = idx.int()
        err, _, ms, plain_ms = compare(
            f"lane_shuffle[{variant}]", lambda: lane_shuffle(x2d, idx),
            lambda: lane_shuffle_plain(x2d, idx), lane_shuffle)
        lib_ms = _device_ms(lambda: torch.gather(x2d, 1, idx32))
        bnd = bound(nbytes(x2d, idx, x2d), 0)
        phase("bf16-kernels", kernel=f"K1 lane_shuffle[{variant}]",
              tables=title, shape=tuple(idx.shape), bitwise_equal=True,
              ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
              library_ms=f"{lib_ms:.5f}", bound_ms=f"{bnd['bound_ms']:.5f}",
              share_of_bound=f"{bnd['bound_ms'] / ms:.3f}")
        kernels[f"lane_shuffle[{variant}]"] = kernel_rec(
            "lane_shuffle", variant, "route_kernels.cu",
            "sblas_tpu/ops/route.py:388", err, ms, plain_ms, lib_ms, bnd)

    def k2(p, x_slabs, variant, title):
        """K2 and K2' storing bf16 at `p`'s gather tiles."""
        args = (p.gslab, x_slabs, p.gidx, p.gvals.to(x_slabs.dtype), BF16)
        x_tiles = torch.index_select(x_slabs, 0, p.gslab)
        targs = (x_tiles, *args[2:])
        for name, fn, plain, a, reads in (
                ("slab_gather", slab_gather, slab_gather_plain, args,
                 args[:4]),
                ("tile_gather", tile_gather, tile_gather_plain, targs,
                 targs[:3])):
            err, _, ms, plain_ms = compare(
                f"{name}[{variant}]", lambda: fn(*a), lambda: plain(*a), fn)
            out_bytes = p.n_gtiles * SLAB * 2
            bnd = bound(nbytes(*reads) + out_bytes, 0)
            phase("bf16-kernels", kernel=f"{name}[{variant}]", tiles=title,
                  n_gtiles=p.n_gtiles, bitwise_equal=True, ms=f"{ms:.5f}",
                  plain_ms=f"{plain_ms:.5f}",
                  bound_ms=f"{bnd['bound_ms']:.5f}",
                  share_of_bound=f"{bnd['bound_ms'] / ms:.3f}")
            kernels[f"{name}[{variant}]"] = kernel_rec(
                name, variant, "rspmv_kernels.cu",
                "sblas_tpu/ops/rspmv.py:" + ("582" if name == "slab_gather"
                                             else "592"),
                err, ms, plain_ms, None, bnd)

    # ---- [bf16-kernels] at the bf16-transport plan's tables ----
    n_slabs = -(-A.shape[1] // SLAB)
    k1(plan16, "bf16_i16", "webbase-1M main route, bf16 transport")
    k1_transposed_phase(plan16, kernels, "bf16_i16", main_only=True)
    x_slabs = torch.rand((n_slabs, LANES, LANES), generator=gen, device=dev)
    k2(plan16, x_slabs, "f32_bf16", "webbase-1M plan")

    # ---- [bf16-transport]: the routed SpMV, f32 and bf16 in turns ----
    k1n = k1_split(*routes_of(plan16))
    out, counts = launches_of(counters,
                              lambda: spmv(plan16, xd, ALPHA, BETA, yd))
    expect_launches("routed SpMV bf16 transport", counts,
                    dict(none, **k1n, slab_gather=1))
    by_variant = variant_launches("routed SpMV bf16 transport", {
        **k1_variants("bf16_i16", plan16.schedule),
        **k1_variants("f32", plan16.xroute_schedule,
                      plan16.unrank_schedule),
        "slab_gather_f32_bf16": 1})
    k1_k2_launches("routed SpMV bf16 transport",
                   dict(**k1n, slab_gather=1))
    for name in ("lane_shuffle", "lane_shuffle_transposed"):
        kernels[f"{name}[bf16_i16]"]["launches"] = by_variant.get(
            f"{name}_bf16_i16", 0)
    kernels["slab_gather[f32_bf16]"]["launches"] = 1
    check = checked_bf16("routed SpMV bf16 transport", out, want,
                         bar=BF16_TRANSPORT_BAR)
    times = {}
    for label, p in (("f32", plan), ("bf16", plan16), ("bf16", plan16),
                     ("f32", plan)):
        t = call_times(lambda: spmv(p, xd, ALPHA, BETA, yd), A.nnz)
        times.setdefault(label, []).append(t)
    phase("bf16-transport", path="spmv RoutedPlan webbase-1M",
          launches=counts, by_variant=by_variant, check=check,
          **{f"{label}_{k}": "/".join(t[k] for t in ts)
             for label, ts in times.items()
             for k in ("wall_ms", "device_ms")})
    del plan16, out

    # ---- [bf16-plans]: the routed SpMV of a plan with bf16 values ----
    t0 = time.perf_counter()
    pv = make_plan(A, dtype=BF16, op="spmv", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if type(pv).__name__ != "RoutedPlan" or pv.dtype != BF16:
        raise AssertionError(f"bf16 webbase SpMV plan {type(pv).__name__} "
                             f"{pv.dtype}, expected a bf16 RoutedPlan")
    k1(pv, "bf16", "webbase-1M main route, bf16 values")
    k1_transposed_phase(pv, kernels, "bf16")
    k2(pv, x_slabs.to(BF16), "bf16", "webbase-1M bf16-valued plan")
    del x_slabs
    x16, y16 = xd.to(BF16), yd.to(BF16)
    k1n = k1_split(*routes_of(pv))
    for pregather, kname in ((False, "slab_gather"), (True, "tile_gather")):
        out, counts = launches_of(counters, lambda: spmv_routed(
            pv, x16, ALPHA, BETA, y16, pregather=pregather))
        expect_launches("routed SpMV bf16 values", counts,
                        dict(none, **k1n, **{kname: 1}))
        by_variant = variant_launches("routed SpMV bf16 values", {
            **k1_variants("bf16", *routes_of(pv)), f"{kname}_bf16": 1})
        kernels[f"{kname}[bf16]"]["launches"] = 1
        if not pregather:
            k1_k2_launches("routed SpMV bf16 values",
                           dict(**k1n, slab_gather=1))
            for name in ("lane_shuffle", "lane_shuffle_transposed"):
                kernels[f"{name}[bf16]"]["launches"] = by_variant.get(
                    f"{name}_bf16", 0)
        phase("bf16-plans", path=f"spmv_routed bf16 values webbase-1M"
              f"{' pregather (K2prime)' if pregather else ''}",
              build_s=f"{build_s:.2f}", launches=counts,
              by_variant=by_variant,
              check=checked_bf16("routed SpMV bf16 values", out, want),
              **call_times(lambda: spmv_routed(
                  pv, x16, ALPHA, BETA, y16, pregather=pregather), A.nnz))
    del pv, out


def bf16_wcoo_phases(A, Bd, Cd, want, counters, none, kernels) -> None:
    """[bf16-kernels] K3 in bf16 at webbase x K=64 in both store forms
    against its plain version (within one bf16 ulp); [bf16-plans] the WCOO
    SpMM of a plan with bf16 values (K3's `bf16` variant), against the
    oracle and timed.  Then `bf16_ragged`, at an unaligned k0 against its
    plain version and on the path that takes it: the SpMM at K=63."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import WcooPlan, make_plan, spmm
    from sblas_tpu_torch.ops.wcoo import k_chunk_width
    K = Bd.shape[1]
    wp = make_plan(A, dtype=BF16, op="spmm", device=Bd.device)
    if not isinstance(wp, WcooPlan) or wp.dtype != BF16:
        raise AssertionError(f"bf16 webbase SpMM plan {type(wp).__name__}, "
                             f"expected a bf16 WcooPlan")
    B16, C16 = Bd.to(BF16), Cd.to(BF16)
    kc = k_chunk_width(wp.n_tiles, K)
    args = (wp.k3, wp.wb, wp.relrow, wp.vals, wp.xblk, wp.lane, B16, 0, kc)
    A_csr = sparse_csr(A, Bd.device, BF16)
    _kernels.LAUNCHED.clear()
    rec = k3_forms("K3 window_reduce[bf16]", args, C16, A_csr, A.nnz,
                   BF16_FLOPS, ulps=1)
    variants = sorted(k[len("sblas_window_reduce_"):]
                      for k in _kernels.LAUNCHED)
    if variants != ["bf16"]:
        raise AssertionError(f"K3[bf16] at K={kc} ran variants {variants}, "
                             f"expected bf16")
    kernels["window_reduce[bf16]"] = dict(
        name="window_reduce[bf16]", route="cuda",
        source="sblas_tpu_torch/csrc/wcoo_kernels.cu",
        replaces="sblas_tpu/ops/wcoo.py:291", **rec)
    out, counts = launches_of(counters,
                              lambda: spmm(wp, B16, ALPHA, BETA, C16))
    expect_launches("WCOO SpMM bf16", counts,
                    dict(none, window_reduce=-(-K // kc)))
    by_variant = variant_launches("WCOO SpMM bf16",
                                  {"window_reduce_bf16": -(-K // kc)})
    kernels["window_reduce[bf16]"]["launches"] = by_variant[
        "window_reduce_bf16"]
    phase("bf16-plans", path="spmm WcooPlan bf16 webbase-1M", K=K,
          units=wp.k3_units.shape[0], launches=counts, by_variant=by_variant,
          check=checked_bf16("WCOO SpMM bf16", out, want),
          **call_times(lambda: spmm(wp, B16, ALPHA, BETA, C16), A.nnz, K))
    bf16_ragged_k3(A, wp, A_csr, B16, C16, want, counters, none, kernels)
    return wp


def body_launches(title, expect: dict) -> dict:
    """The last `launches_of` run's K3[bf16_ragged] launches by the body
    its launcher ran (`_kernels.BODIES`: `masked`, the `bf16` sub-warp
    rows on whole words; `ring`, the sub-warp rows fed by the
    shared-memory ring), which must be `expect`."""
    from sblas_tpu_torch import _kernels
    got = {k[len("window_reduce_bf16_ragged."):]: v
           for k, v in _kernels.BODIES.items()}
    if got != expect:
        raise AssertionError(f"{title}: K3[bf16_ragged] launches by body "
                             f"{got}, expected {expect}")
    return got


def ragged_compare(name, calls, C, body):
    """K3[bf16_ragged] in the fused form over `calls` ((B, k0, width, tabs)
    each, into one out that starts as C) against its plain version on the
    same inputs, within one bf16 ulp, two launches bitwise; every launch
    must be `bf16_ragged` on `body`.  Returns `compare`'s tuple."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops.wcoo import window_reduce, window_reduce_plain
    epi = dict(C=C, alpha=ALPHA, beta=BETA)

    def run(fn, out):
        for B, k0, width, tabs in calls:
            fn(*tabs, B, k0, width, **epi, out=out)
        return out
    # the kernel's calls take the two outs in turns, so `compare` holds
    # two launches' results
    outs = [C.clone(), C.clone()]
    turn = itertools.cycle(outs)
    _kernels.LAUNCHED.clear()
    _kernels.BODIES.clear()
    rec = compare(name, lambda: run(window_reduce, next(turn)),
                  lambda: run(window_reduce_plain, C.clone()),
                  window_reduce, ulps=1)
    variants = sorted(k[len("sblas_window_reduce_"):]
                      for k in _kernels.LAUNCHED)
    bodies = sorted(k[len("window_reduce_bf16_ragged."):]
                    for k in _kernels.BODIES)
    if variants != ["bf16_ragged"] or bodies != [body]:
        raise AssertionError(f"{name} ran variants {variants}, bodies "
                             f"{bodies}; expected bf16_ragged on {body}")
    return rec


def bf16_ragged_k3(A, wp, A_csr, B16, C16, want, counters, none,
                   kernels) -> None:
    """K3[bf16_ragged], each of its launcher's two bodies held within one
    bf16 ulp of its plain version at the operands of the path that runs
    it and timed with its bound.  The ring body at the SpMM at K=63's own
    operands (B and C cut to 63 columns, an odd row stride; k0 = 0), then
    that SpMM (the oracle cut alike), one call on that body; the masked
    body at k0 = 1 of the K=64 operands (63 columns at an odd offset, the
    shape PERF.md's row is measured at); the aligned `bf16` bits; then
    the SpMM at K=100, whose two chunks take the ring body
    (`bf16_wcoo_k100`), and at K=128, whose two chunks take the masked
    body (`bf16_wcoo_k128`)."""
    from sblas_tpu_torch.ops import spmm
    from sblas_tpu_torch.ops.wcoo import k_chunk_width
    KR = B16.shape[1] - 1
    tabs = (wp.k3, wp.wb, wp.relrow, wp.vals, wp.xblk, wp.lane)
    index = nbytes(wp.k3_units, wp.k3_rows, wp.wb, wp.relrow, wp.vals,
                   wp.xblk, wp.lane)
    m = C16.shape[0]
    bnd = bound(index + (B16.shape[0] + 2 * m) * KR * 2,
                2 * A.nnz * KR + 3 * m * KR, rate=BF16_FLOPS)
    BR, CR = B16[:, :KR].contiguous(), C16[:, :KR].contiguous()
    lib_ms = library_or_none(
        f"torch.addmm bf16 CSR x dense, K={KR}",
        lambda: torch.addmm(CR, A_csr, BR, beta=BETA, alpha=ALPHA))
    name = "window_reduce[bf16_ragged.ring]"
    err, rel, ms, plain_ms = ragged_compare(name, [(BR, 0, KR, tabs)], CR,
                                            "ring")
    kc = k_chunk_width(wp.n_tiles, KR)
    out, counts = launches_of(counters, lambda: spmm(wp, BR, ALPHA, BETA, CR))
    expect_launches(f"WCOO SpMM bf16 K={KR}", counts,
                    dict(none, window_reduce=-(-KR // kc)))
    by_variant = variant_launches(f"WCOO SpMM bf16 K={KR}",
                                  {"window_reduce_bf16_ragged": -(-KR // kc)})
    by_body = body_launches(f"WCOO SpMM bf16 K={KR}",
                            {"ring": -(-KR // kc)})
    phase("bf16-kernels", kernel=f"K3 {name} fused", k0=0, K=KR, ldb=KR,
          main_path_launches=by_body, max_abs_err=f"{err:.3e}",
          rel_err=f"{rel:.3e}", ulps=1, deterministic=True, ms=f"{ms:.5f}",
          plain_ms=f"{plain_ms:.5f}", library_ms=_fmt_ms(lib_ms),
          bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
          share_of_bound=f"{bnd['bound_ms'] / ms:.3f}")
    kernels[name] = dict(
        name=name, route="cuda", source="sblas_tpu_torch/csrc/wcoo_kernels.cu",
        replaces="sblas_tpu/ops/wcoo.py:291", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms,
        launches=by_body["ring"], **bnd)
    phase("bf16-plans", path=f"spmm WcooPlan bf16 webbase-1M K={KR}",
          launches=counts, by_variant=by_variant, by_body=by_body,
          check=checked_bf16(f"WCOO SpMM bf16 K={KR}", out, want[:, :KR]),
          **call_times(lambda: spmm(wp, BR, ALPHA, BETA, CR), A.nnz, KR))
    # the masked body at k0 = 1, off the path (C and out at column 1)
    err, rel, ms, plain_ms = ragged_compare(
        "window_reduce[bf16_ragged] k0=1", [(B16, 1, KR, tabs)], C16,
        "masked")
    phase("bf16-kernels", kernel="K3 window_reduce[bf16_ragged] fused",
          body="masked", k0=1, K=KR, ldb=B16.shape[1],
          max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", ulps=1,
          deterministic=True, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=_fmt_ms(lib_ms), bound_ms=f"{bnd['bound_ms']:.5f}",
          bound_by=bnd["bound_by"],
          share_of_bound=f"{bnd['bound_ms'] / ms:.3f}")
    ragged_gives_bf16_bits(wp, B16, C16)
    bf16_wcoo_k100(A, wp, A_csr, B16, C16, want, counters, none)
    bf16_wcoo_k128(A, A_csr, B16, C16, want, counters, none, kernels)


def ragged_gives_bf16_bits(wp, B16, C16) -> None:
    """K3[bf16_ragged] at k0 = 1 over 56 columns against K3[bf16] on
    aligned copies of the same 56 columns (k0 = 0): the bodies sum in one
    order and round once the same way, so every store form must agree
    bitwise: the grid form, whose out starts on 16 bytes, on the ring
    body; the fused form on the masked body; and the fused form at the
    odd row stride 63 (B and C cut to 63 columns) on the ring body."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops.wcoo import window_reduce
    W = 56
    tabs = (wp.k3, wp.wb, wp.relrow, wp.vals, wp.xblk, wp.lane)
    Ba, Ca = B16[:, 1:1 + W].contiguous(), C16[:, 1:1 + W].contiguous()
    Bo, Co = B16[:, :63].contiguous(), C16[:, :63].contiguous()
    epi = dict(alpha=ALPHA, beta=BETA)
    _kernels.LAUNCHED.clear()
    _kernels.BODIES.clear()
    grid_r = window_reduce(*tabs, B16, 1, W)
    fused_r = window_reduce(*tabs, B16, 1, W, C=C16, **epi)[:, 1:1 + W]
    odd_r = window_reduce(*tabs, Bo, 1, W, C=Co, **epi)[:, 1:1 + W]
    grid_a = window_reduce(*tabs, Ba, 0, W)
    fused_a = window_reduce(*tabs, Ba, 0, W, C=Ca, **epi)
    torch.cuda.synchronize()
    got = {k[len("sblas_window_reduce_"):]: v
           for k, v in _kernels.LAUNCHED.items()}
    if got != {"bf16_ragged": 3, "bf16": 2}:
        raise AssertionError(f"ragged vs bf16: variants {got}")
    body_launches("ragged vs bf16", {"ring": 2, "masked": 1})
    same = (torch.equal(grid_r, grid_a), torch.equal(fused_r, fused_a),
            torch.equal(odd_r, fused_a))
    if not all(same):
        raise AssertionError(f"K3[bf16_ragged] at k0=1 differs from "
                             f"K3[bf16] on aligned copies (grid, fused, "
                             f"fused at stride 63 equal: {same})")
    window_reduce.launches = 0
    phase("bf16-kernels", kernel="K3 bf16_ragged vs bf16, aligned copies",
          k0=1, width=W, grid_bitwise=True, grid_body="ring",
          fused_bitwise=True, fused_body="masked",
          stride63_fused_bitwise=True, stride63_body="ring")


def bf16_wcoo_k100(A, wp, A_csr, B16, C16, want, counters, none) -> None:
    """[bf16-kernels] the webbase-1M bf16 WCOO SpMM at K=100 (`spmm` on
    the bf16 WcooPlan): the JAX package's chunk width (81 at webbase)
    makes two K3 calls, 81 and 19 columns wide at row stride 100, both
    `bf16_ragged` on its ring body.  That body is held within one bf16
    ulp of its plain version on the same two chunks and timed, with the
    bound and `torch.addmm` beside it; then the SpMM against the oracle.
    B and C are the K=64 operands and the first 36 of their columns
    reversed, so the oracle is the K=64 one extended alike."""
    from sblas_tpu_torch.ops import spmm
    from sblas_tpu_torch.ops.wcoo import k_chunk_width
    K = 100
    extra = K - B16.shape[1]
    B = torch.cat([B16, B16.flip(1)[:, :extra]], 1).contiguous()
    C = torch.cat([C16, C16.flip(1)[:, :extra]], 1).contiguous()
    want = np.concatenate([want, want[:, ::-1][:, :extra]], 1)
    kc = k_chunk_width(wp.n_tiles, K)
    chunks = [(k0, min(kc, K - k0)) for k0 in range(0, K, kc)]
    tabs = (wp.k3, wp.wb, wp.relrow, wp.vals, wp.xblk, wp.lane)
    index = nbytes(wp.k3_units, wp.k3_rows, wp.wb, wp.relrow, wp.vals,
                   wp.xblk, wp.lane)
    m = C.shape[0]
    # each call reads the index streams once; B, C and out once in all
    bnd = bound(len(chunks) * index + (B.shape[0] + 2 * m) * K * 2,
                2 * A.nnz * K + 3 * m * K, rate=BF16_FLOPS)
    name = "window_reduce[bf16_ragged.ring]"
    err, rel, ms, plain_ms = ragged_compare(
        name, [(B, k0, w, tabs) for k0, w in chunks], C, "ring")
    lib_ms = library_or_none(
        f"torch.addmm bf16 CSR x dense, K={K}",
        lambda: torch.addmm(C, A_csr, B, beta=BETA, alpha=ALPHA))
    out, counts = launches_of(counters, lambda: spmm(wp, B, ALPHA, BETA, C))
    expect_launches(f"WCOO SpMM bf16 K={K}", counts,
                    dict(none, window_reduce=len(chunks)))
    by_variant = variant_launches(f"WCOO SpMM bf16 K={K}",
                                  {"window_reduce_bf16_ragged": 2})
    by_body = body_launches(f"WCOO SpMM bf16 K={K}", {"ring": 2})
    phase("bf16-kernels", kernel=f"K3 {name} fused, the K={K} chunks",
          body="ring", chunks=chunks, ldb=K, main_path_launches=by_body,
          max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", ulps=1,
          deterministic=True, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=_fmt_ms(lib_ms), bound_ms=f"{bnd['bound_ms']:.5f}",
          bound_by=bnd["bound_by"],
          share_of_bound=f"{bnd['bound_ms'] / ms:.3f}")
    times = call_times(lambda: spmm(wp, B, ALPHA, BETA, C), A.nnz, K)
    phase("bf16-plans", path=f"spmm WcooPlan bf16 webbase-1M K={K}",
          chunks=[w for _, w in chunks], launches=counts,
          by_variant=by_variant, by_body=by_body,
          check=checked_bf16(f"WCOO SpMM bf16 K={K}", out, want),
          bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
          share_of_bound=f"{bnd['bound_ms'] / float(times['device_ms']):.3f}",
          **times)


def bf16_wcoo_k128(A, A_csr, B16, C16, want, counters, none,
                   kernels) -> None:
    """[bf16-kernels] the webbase-1M bf16 WCOO SpMM at K=128 through
    `make_plan(..., force="wcoo")` and `spmm`: the JAX package's chunk
    width (81 at webbase) makes two K3 calls, 81 and 47 columns wide,
    both `bf16_ragged` on its masked body.  That body is held within one
    bf16 ulp of its plain version on the same two chunks and timed (the
    `kernels` entry of K3[bf16_ragged]).  B and C are the K=64 operands
    and their columns reversed, so the oracle is the K=64 one and its
    columns reversed."""
    from sblas_tpu_torch.ops import WcooPlan, make_plan, spmm
    from sblas_tpu_torch.ops.wcoo import k_chunk_width
    K = 2 * B16.shape[1]
    wp = make_plan(A, dtype=BF16, force="wcoo", device=B16.device)
    if not isinstance(wp, WcooPlan):
        raise AssertionError(f"force='wcoo' built {type(wp).__name__}")
    B = torch.cat([B16, B16.flip(1)], 1).contiguous()
    C = torch.cat([C16, C16.flip(1)], 1).contiguous()
    want = np.concatenate([want, want[:, ::-1]], 1)
    kc = k_chunk_width(wp.n_tiles, K)
    chunks = [(k0, min(kc, K - k0)) for k0 in range(0, K, kc)]
    tabs = (wp.k3, wp.wb, wp.relrow, wp.vals, wp.xblk, wp.lane)
    index = nbytes(wp.k3_units, wp.k3_rows, wp.wb, wp.relrow, wp.vals,
                   wp.xblk, wp.lane)
    m = C.shape[0]
    # each call reads the index streams once; B, C and out once in all
    bnd = bound(len(chunks) * index + (B.shape[0] + 2 * m) * K * 2,
                2 * A.nnz * K + 3 * m * K, rate=BF16_FLOPS)
    name = "window_reduce[bf16_ragged]"
    err, rel, ms, plain_ms = ragged_compare(
        name, [(B, k0, w, tabs) for k0, w in chunks], C, "masked")
    lib_ms = library_or_none(
        f"torch.addmm bf16 CSR x dense, K={K}",
        lambda: torch.addmm(C, A_csr, B, beta=BETA, alpha=ALPHA))
    out, counts = launches_of(counters, lambda: spmm(wp, B, ALPHA, BETA, C))
    expect_launches(f"WCOO SpMM bf16 K={K}", counts,
                    dict(none, window_reduce=len(chunks)))
    by_variant = variant_launches(f"WCOO SpMM bf16 K={K}",
                                  {"window_reduce_bf16_ragged": 2})
    by_body = body_launches(f"WCOO SpMM bf16 K={K}", {"masked": 2})
    phase("bf16-kernels", kernel=f"K3 {name} fused, the K={K} chunks",
          body="masked", chunks=chunks, ldb=K, main_path_launches=by_body,
          max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", ulps=1,
          deterministic=True, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=_fmt_ms(lib_ms), bound_ms=f"{bnd['bound_ms']:.5f}",
          bound_by=bnd["bound_by"],
          share_of_bound=f"{bnd['bound_ms'] / ms:.3f}")
    kernels[name] = dict(
        name=name, route="cuda", source="sblas_tpu_torch/csrc/wcoo_kernels.cu",
        replaces="sblas_tpu/ops/wcoo.py:291", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, launches=by_body["masked"],
        **bnd)
    times = call_times(lambda: spmm(wp, B, ALPHA, BETA, C), A.nnz, K)
    phase("bf16-kernels", path=f"spmm WcooPlan bf16 webbase-1M K={K}",
          chunks=[w for _, w in chunks], launches=counts,
          by_variant=by_variant, by_body=by_body,
          check=checked_bf16(f"WCOO SpMM bf16 K={K}", out, want),
          bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
          share_of_bound=f"{bnd['bound_ms'] / float(times['device_ms']):.3f}",
          **times)


def bf16_shell_phases(S, Bd, Cd, want, counters, none) -> None:
    """[bf16-plans] the shell with bf16 values: the DIA SpMM and SpMV
    (plain torch, no kernel) against the oracle and timed; the auto
    choice at bf16 is printed (the BELL byte cap halves against f32)."""
    from sblas_tpu_torch.containers import DenseVector
    from sblas_tpu_torch.ops import choose_kind, make_plan, spmm, spmv
    from sblas_tpu_torch.ops.cpu_reference import spmv_cpu
    dp = make_plan(S, dtype=BF16, force="dia", device=Bd.device)
    B16, C16 = Bd.to(BF16), Cd.to(BF16)
    out, counts = launches_of(counters,
                              lambda: spmm(dp, B16, ALPHA, BETA, C16))
    expect_launches("DIA SpMM bf16", counts, none)
    phase("bf16-plans", path="spmm DiaPlan bf16 shell", K=Bd.shape[1],
          auto_kind_bf16=choose_kind(S, BF16, op="spmm"), launches=counts,
          check=checked_bf16("DIA SpMM bf16", out, want),
          **call_times(lambda: spmm(dp, B16, ALPHA, BETA, C16), S.nnz,
                       Bd.shape[1]))
    x = DenseVector.random(S.width, dtype=np.float32)
    y = DenseVector.constant(S.height, 1.0, dtype=np.float32)
    x16 = torch.from_numpy(x.values).to(Bd.device, BF16)
    y16 = torch.from_numpy(y.values).to(Bd.device, BF16)
    out, counts = launches_of(counters,
                              lambda: spmv(dp, x16, ALPHA, BETA, y16))
    expect_launches("DIA SpMV bf16", counts, none)
    phase("bf16-plans", path="spmv DiaPlan bf16 shell",
          auto_kind_bf16=choose_kind(S, BF16, op="spmv"), launches=counts,
          check=checked_bf16("DIA SpMV bf16", out,
                             spmv_cpu(S, x, ALPHA, BETA, y)),
          **call_times(lambda: spmv(dp, x16, ALPHA, BETA, y16), S.nnz))


def bf16_shell_k4_record(S, Bd, Cd, want, counters, none) -> None:
    """[bf16-kernels], informational: K4[bf16] on the BELL plan that
    `make_plan` picks for the shell at bf16, at K=64, within one bf16 ulp
    of its plain version and timed beside the `spmm_bsr` batched matmuls
    that `ops.spmm` runs there (K < 256: no K4 launch, checked).  A record
    for a later decision on K4's gate; the path is not changed."""
    from sblas_tpu_torch.ops import BsrPlan, bell_stats, make_plan, spmm
    from sblas_tpu_torch.ops.bsr_pallas import bell_spmm, bell_spmm_plain
    K = Bd.shape[1]
    bp = make_plan(S, dtype=BF16, op="spmm", device=Bd.device)
    if not isinstance(bp, BsrPlan):
        raise AssertionError(f"bf16 shell SpMM plan {type(bp).__name__}, "
                             f"expected a bf16 BsrPlan")
    B16, C16 = Bd.to(BF16), Cd.to(BF16)
    args = (bp.vals, bp.bcol, B16, C16, ALPHA, BETA)
    err, _, ms, plain_ms = compare(
        "bell_spmm[bf16] shell K=64", lambda: bell_spmm(*args),
        lambda: bell_spmm_plain(*args), bell_spmm, ulps=1)
    out, counts = launches_of(counters,
                              lambda: spmm(bp, B16, ALPHA, BETA, C16))
    expect_launches("BELL SpMM bf16 shell K=64", counts, none)
    spmm_bsr_ms = _device_ms(lambda: spmm(bp, B16, ALPHA, BETA, C16))
    flops = 2 * bell_stats(S)["n_blocks"] * 128 * 128 * K
    bnd = bound(nbytes(bp.vals, bp.bcol, B16, C16, C16), flops,
                rate=BF16_FLOPS)
    phase("bf16-kernels", kernel="K4 bell_spmm[bf16] shell, informational",
          K=K, n_brows=bp.vals.shape[0], slots=bp.slots,
          max_abs_err=f"{err:.3e}", ulps=1, ms=f"{ms:.5f}",
          spmm_bsr_ms=f"{spmm_bsr_ms:.5f}",
          plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bnd['bound_ms']:.5f}",
          bound_by=bnd["bound_by"],
          share_of_bound=f"{bnd['bound_ms'] / ms:.3f}",
          spmm_check=checked_bf16("BELL SpMM bf16 shell K=64", out, want))


def bf16_bell_phases(F, Bd, Cd, want, counters, none, kernels) -> None:
    """[bf16-kernels] K4 in bf16 at band-73 x K=256 against its plain
    version (within one bf16 ulp); [bf16-plans] the BELL SpMM of a plan
    with bf16 values (K4 once), against the oracle and timed.  Then the
    same at K=263, where TMA cannot take B's rows (K % 8 != 0), through
    K4's `bf16_ragged` variant."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import BsrPlan, bell_stats, make_plan, spmm
    from sblas_tpu_torch.ops.bsr_pallas import bell_spmm, bell_spmm_plain
    K4 = Bd.shape[1]
    bp = make_plan(F, dtype=BF16, op="spmm", device=Bd.device)
    if not isinstance(bp, BsrPlan) or bp.dtype != BF16:
        raise AssertionError(f"bf16 band-73 SpMM plan {type(bp).__name__}, "
                             f"expected a bf16 BsrPlan")
    B16, C16 = Bd.to(BF16), Cd.to(BF16)
    args = (bp.vals, bp.bcol, B16, C16, ALPHA, BETA)
    _kernels.LAUNCHED.clear()
    err, rel, ms, plain_ms = compare(
        "bell_spmm[bf16]", lambda: bell_spmm(*args),
        lambda: bell_spmm_plain(*args), bell_spmm, ulps=1)
    variants = sorted(k[len("sblas_bell_spmm_"):] for k in _kernels.LAUNCHED)
    if variants != ["bf16"]:
        raise AssertionError(f"K4[bf16] at K={K4} ran variants {variants}, "
                             f"expected the wgmma one, bf16")
    F_csr = sparse_csr(F, Bd.device, BF16)
    lib_ms = library_or_none(
        "torch.addmm bf16 CSR x dense",
        lambda: torch.addmm(C16, F_csr, B16, beta=BETA, alpha=ALPHA))
    flops = 2 * bell_stats(F)["n_blocks"] * 128 * 128 * K4
    nb = nbytes(bp.vals, bp.bcol, B16, C16, C16)
    bnd = bound(nb, flops, rate=BF16_FLOPS)
    out, counts = launches_of(counters,
                              lambda: spmm(bp, B16, ALPHA, BETA, C16))
    expect_launches("BELL SpMM bf16", counts, dict(none, bell_spmm=1))
    by_variant = variant_launches("BELL SpMM bf16", {"bell_spmm_bf16": 1})
    phase("bf16-kernels", kernel="K4 bell_spmm[bf16]", K=K4,
          variant=variants[0], main_path_launches=by_variant,
          max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", ulps=1,
          deterministic=True, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=_fmt_ms(lib_ms), bound_ms=f"{bnd['bound_ms']:.5f}",
          bound_by=bnd["bound_by"],
          share_of_bound=f"{bnd['bound_ms'] / ms:.3f}",
          fp32_core_bound_ms=f"{bound(nb, flops)['bound_ms']:.5f}")
    kernels["bell_spmm[bf16]"] = dict(kernel_rec(
        "bell_spmm", "bf16", "bsr_kernels.cu",
        "sblas_tpu/ops/bsr_pallas.py:37", err, ms, plain_ms, lib_ms, bnd),
        launches=by_variant["bell_spmm_bf16"])
    phase("bf16-plans", path=f"spmm BsrPlan bf16 band-73 K={K4}",
          launches=counts, by_variant=by_variant,
          check=checked_bf16("BELL SpMM bf16", out, want),
          **call_times(lambda: spmm(bp, B16, ALPHA, BETA, C16), F.nnz, K4))
    bf16_ragged_phases(F, bp, F_csr, B16, C16, want, counters, none,
                       kernels)
    return bp


def bf16_bell_mode1(F, bplan, bp, Bd, Cd, want, counters, none) -> None:
    """[bf16-dist] mode 1 over the band-73 BELL plan in bf16 at K=256: its
    one column block through `ops.spmm`, so K4[bf16] once (the JAX
    package's distributed BELL path runs its matmuls instead); beside the
    f32 plan's mode 1.  Mode 1 makes no collective, so a mesh without a
    group serves."""
    from sblas_tpu_torch.parallel import Mesh, spmm_mode1
    mesh = Mesh(None, 0, 1, Bd.device)
    B16, C16 = Bd.to(BF16), Cd.to(BF16)
    f32_ms = _device_ms(lambda: spmm_mode1(bplan, Bd, ALPHA, BETA, Cd, mesh))
    bf16_dist_run(f"spmm_mode1 band-73 K={Bd.shape[1]} (BsrPlan bf16)",
                  lambda: spmm_mode1(bp, B16, ALPHA, BETA, C16, mesh), want,
                  counters, none, dict(bell_spmm=1), {"bell_spmm_bf16": 1},
                  f32_ms, F.nnz, Bd.shape[1])


def bf16_ragged_phases(F, bp, F_csr, B16, C16, want, counters, none,
                       kernels) -> None:
    """K4[bf16_ragged] at band-73 x K=263: B and C's columns 256-262
    repeat 0-6, so the oracle's do too."""
    from sblas_tpu_torch import _kernels
    from sblas_tpu_torch.ops import bell_stats, spmm
    from sblas_tpu_torch.ops.bsr_pallas import (bell_spmm, bell_spmm_plain,
                                                ragged_column_tiles)
    extra = 7
    KR = B16.shape[1] + extra
    BR = torch.cat([B16, B16[:, :extra]], 1)
    CR = torch.cat([C16, C16[:, :extra]], 1)
    want = np.concatenate([want, want[:, :extra]], 1)
    args = (bp.vals, bp.bcol, BR, CR, ALPHA, BETA)
    _kernels.LAUNCHED.clear()
    err, rel, ms, plain_ms = compare(
        "bell_spmm[bf16_ragged]", lambda: bell_spmm(*args),
        lambda: bell_spmm_plain(*args), bell_spmm, ulps=1)
    variants = sorted(k[len("sblas_bell_spmm_"):] for k in _kernels.LAUNCHED)
    if variants != ["bf16_ragged"]:
        raise AssertionError(f"K4[bf16] at K={KR} ran variants {variants}, "
                             f"expected bf16_ragged")
    lib_ms = library_or_none(
        f"torch.addmm bf16 CSR x dense, K={KR}",
        lambda: torch.addmm(CR, F_csr, BR, beta=BETA, alpha=ALPHA))
    flops = 2 * bell_stats(F)["n_blocks"] * 128 * 128 * KR
    bnd = bound(nbytes(bp.vals, bp.bcol, BR, CR, CR), flops, rate=BF16_FLOPS)
    out, counts = launches_of(counters, lambda: spmm(bp, BR, ALPHA, BETA, CR))
    expect_launches(f"BELL SpMM bf16 K={KR}", counts,
                    dict(none, bell_spmm=1))
    by_variant = variant_launches(f"BELL SpMM bf16 K={KR}",
                                  {"bell_spmm_bf16_ragged": 1})
    phase("bf16-kernels", kernel="K4 bell_spmm[bf16_ragged]", K=KR,
          column_tiles=ragged_column_tiles(KR),
          variant=variants[0], main_path_launches=by_variant,
          max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", ulps=1,
          deterministic=True, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=_fmt_ms(lib_ms), bound_ms=f"{bnd['bound_ms']:.5f}",
          bound_by=bnd["bound_by"],
          share_of_bound=f"{bnd['bound_ms'] / ms:.3f}")
    kernels["bell_spmm[bf16_ragged]"] = dict(kernel_rec(
        "bell_spmm", "bf16_ragged", "bsr_kernels.cu",
        "sblas_tpu/ops/bsr_pallas.py:37", err, ms, plain_ms, lib_ms, bnd),
        launches=by_variant["bell_spmm_bf16_ragged"])
    phase("bf16-plans", path=f"spmm BsrPlan bf16 band-73 K={KR}",
          launches=counts, by_variant=by_variant,
          check=checked_bf16(f"BELL SpMM bf16 K={KR}", out, want),
          **call_times(lambda: spmm(bp, BR, ALPHA, BETA, CR), F.nnz, KR))
    # one more K off the path: K=300 (column tiles 152 + 148)
    extra = 300 - B16.shape[1]
    BR = torch.cat([B16, B16[:, :extra]], 1)
    CR = torch.cat([C16, C16[:, :extra]], 1)
    args = (bp.vals, bp.bcol, BR, CR, ALPHA, BETA)
    _kernels.LAUNCHED.clear()
    err, rel, ms, plain_ms = compare(
        "bell_spmm[bf16_ragged] K=300", lambda: bell_spmm(*args),
        lambda: bell_spmm_plain(*args), bell_spmm, ulps=1)
    if sorted(_kernels.LAUNCHED) != ["sblas_bell_spmm_bf16_ragged"]:
        raise AssertionError(f"K4 at K=300 ran {dict(_kernels.LAUNCHED)}")
    bnd = bound(nbytes(bp.vals, bp.bcol, BR, CR, CR),
                2 * bell_stats(F)["n_blocks"] * 128 * 128 * BR.shape[1],
                rate=BF16_FLOPS)
    phase("bf16-kernels", kernel="K4 bell_spmm[bf16_ragged], off the path",
          K=BR.shape[1], column_tiles=ragged_column_tiles(BR.shape[1]),
          max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", ulps=1,
          deterministic=True, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
          share_of_bound=f"{bnd['bound_ms'] / ms:.3f}")


def cli_bf16_phases(main_fn, path, nnz, tmp) -> None:
    """[cli bf16]: spmv_test --transport bf16 (its 2e-3 bar), then with
    --plan-cache saving the bf16 plan and a default-transport run
    re-aiming it; [cli progressive]: a validated first result from the
    fast plan, then the steady state."""
    base = [path, str(ALPHA), str(BETA), "1", "f32", "--mode", "single",
            "--device", "cuda"]
    cache = os.path.join(tmp, "webbase_200k_bf16.npz")
    for argv, said in (
            ([*base, "--transport", "bf16"], "plan RoutedPlan"),
            ([*base, "--transport", "bf16", "--plan-cache", cache],
             "plan cache: saved"),
            ([*base, "--plan-cache", cache],
             "plan cache: converted transport 'bf16' -> 'f32'")):
        text, rc = _cli(main_fn, argv)
        if rc != 0 or "Validation = True" not in text or said not in text:
            raise AssertionError(f"CLI {' '.join(argv[len(base):])} failed "
                                 f"(rc={rc}):\n{text}")
        lines = text.splitlines()
        phase("cli bf16", rc=rc, nnz=nnz, flags=" ".join(argv[len(base):]),
              said=said, check=next(ln for ln in lines
                                    if "max_rel" in ln).strip(),
              run=next(ln for ln in lines if "run time" in ln).strip())
    text, rc = _cli(main_fn, [*base, "--progressive"])
    first = [ln for ln in text.splitlines() if ln.startswith("First result")]
    if (rc != 0 or len(first) != 1 or "Validation = True" not in first[0]
            or "Validation = True" not in text.split(first[0])[1]):
        raise AssertionError(f"CLI --progressive failed (rc={rc}):\n{text}")
    phase("cli progressive", rc=rc, nnz=nnz, first=first[0].strip(),
          plan=next(ln for ln in text.splitlines()
                    if ln.startswith("Matrix:")).split("plan ")[-1],
          run=next(ln for ln in text.splitlines()
                   if "run time" in ln).strip())


def _fmt_ms(ms) -> str:
    return "none" if ms is None else f"{ms:.5f}"


def bf16_transport_dist(A, xd, yd, want, mesh, counters, none, kernels,
                        partition, run, title) -> None:
    """[bf16-transport] through a distributed path at world 1: shards of
    `partition(A, 1, config=bf16 transport)`, run by `run(shards)`: K2'
    stores bf16, K1 runs on the int16 main-route tables, gated at 2e-3."""
    import dataclasses as dc

    from sblas_tpu_torch.config import DEFAULT
    cfg = dc.replace(DEFAULT, routed_transport="bf16")
    t0 = time.perf_counter()
    shards = partition(A, 1, dtype=torch.float32, config=cfg,
                       device=mesh.device, rank=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    p = getattr(shards.local(0), "plan", shards.local(0))
    if shards.kind != "routed" or p.transport != "bf16":
        raise AssertionError(f"{title}: shards {shards.kind} at transport "
                             f"{getattr(p, 'transport', None)}, expected "
                             f"routed bf16")
    out, counts = launches_of(counters, lambda: run(shards))
    expect_launches(title, counts, dict(
        none, **k1_split(*routes_of(p)), tile_gather=1))
    by_variant = variant_launches(title, {
        **k1_variants("bf16_i16", p.schedule),
        **k1_variants("f32", p.xroute_schedule, p.unrank_schedule),
        "tile_gather_f32_bf16": 1})
    kernels["tile_gather[f32_bf16]"]["launches"] = 1
    phase("bf16-transport", path=f"{title} (world 1)",
          build_s=f"{build_s:.2f}", launches=counts, by_variant=by_variant,
          check=checked_bf16(title, out, want, bar=BF16_TRANSPORT_BAR),
          **call_times(lambda: run(shards), A.nnz))


def p1_compare(plan, x_slabs, title) -> dict:
    """[p1]: kernel P1 against its plain version on `plan`'s tables (i1 =
    the main route's first table cut to the tile rows) and `x_slabs`."""
    from sblas_tpu_torch.experiments.stage_fuse_probe import (
        stage_fuse_gather, stage_fuse_gather_plain)
    T_g = plan.n_gtiles
    i1 = plan.tables[0][: T_g * 128].reshape(T_g, 128, 128)
    args = (plan.gslab, x_slabs, plan.gidx, plan.gvals, i1)
    err, _, ms, plain_ms = compare(
        "stage_fuse_gather", lambda: stage_fuse_gather(*args),
        lambda: stage_fuse_gather_plain(*args), stage_fuse_gather)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **bound(nbytes(*args, plan.gvals), 0))
    phase("p1", shapes=title, n_gtiles=T_g, n_slabs=x_slabs.shape[0],
          bitwise_equal=True, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          bound_ms=f"{rec['bound_ms']:.5f}", bound_by=rec["bound_by"],
          share=f"{rec['bound_ms'] / ms:.3f}")
    return rec


def k1_k2_at(title, where, plan, ran) -> dict:
    """K1 on `plan`'s first main-route layer viewed as (route_n / 128, 128)
    and K2 on its tiles, every variant of each against its plain version
    (bitwise) on random values, beside `torch.gather` for K1; bound by
    bytes.  One `title` line a kernel and variant; `ran` is the path's
    launches by variant (`k1_k2_launches`): a variant the path ran gets
    its launches there, the others null.  Returns each reading as a `kernels` record's numbers, by
    (kernel, variant)."""
    from sblas_tpu_torch.ops.route import (LANE_SHUFFLE_VARIANTS, LANES,
                                           lane_shuffle, lane_shuffle_plain)
    from sblas_tpu_torch.ops.rspmv import (SLAB, SLAB_GATHER_VARIANTS,
                                           slab_gather, slab_gather_plain)
    card = card_line()
    dev = plan.gslab.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + plan.n_gtiles)
    table = plan.tables[0].reshape(-1, LANES).int()
    n_slabs = -(-plan.shape[1] // SLAB)
    runs = []
    for variant, (dt, it) in LANE_SHUFFLE_VARIANTS.items():
        x2d = torch.rand(table.shape, generator=gen, device=dev).to(dt)
        idx = table.to(it)
        runs.append(("K1 lane_shuffle", variant, lane_shuffle,
                     lambda x2d=x2d, idx=idx: lane_shuffle(x2d, idx),
                     lambda x2d=x2d, idx=idx: lane_shuffle_plain(x2d, idx),
                     (x2d, idx, x2d),
                     lambda x2d=x2d: torch.gather(x2d, 1, table)))
    for variant, (dt, ot) in SLAB_GATHER_VARIANTS.items():
        x_slabs = torch.rand((n_slabs, LANES, LANES), generator=gen,
                             device=dev).to(dt)
        args = (plan.gslab, x_slabs, plan.gidx, plan.gvals.to(dt), ot)
        out = torch.empty(plan.gidx.shape, dtype=ot or dt, device=dev)
        runs.append(("K2 slab_gather", variant, slab_gather,
                     lambda args=args: slab_gather(*args),
                     lambda args=args: slab_gather_plain(*args),
                     (*args[:4], out), None))
    recs = {}
    for kernel, variant, counter, run, plain, moved, lib in runs:
        err, _, ms, plain_ms = compare(f"{kernel}[{variant}] {where}", run,
                                       plain, counter)
        bnd = bound(nbytes(*moved), 0)
        lib_ms = _device_ms(lib) if lib is not None else None
        recs[counter.__name__, variant] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            **bnd)
        launches = ran.get(f"{counter.__name__}_{variant}")
        phase(title, where=where, kernel=f"{kernel}[{variant}]",
              shape=tuple(moved[2].shape), launches=launches,
              bitwise_equal=True,
              max_abs_err=err, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
              library_ms=(f"{lib_ms:.5f} (torch.gather)"
                          if lib_ms is not None else None),
              bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
              share=f"{bnd['bound_ms'] / ms:.3f}", card=card)
    return recs


def shard_k1_k2(plan, n, ran) -> None:
    """[xfoot-shard kernels]: the stock shard SpMV's kernels on the n-way
    worst shard's own tables (`k1_k2_at`), then the shard's whole main
    route as the SpMV launches it (its K1 layers, each transpose stored by
    the K1 launch before it)."""
    from sblas_tpu_torch.ops.route import apply_route
    k1_k2_at("xfoot-shard kernels", f"n={n} shard", plan, ran)
    gen = torch.Generator(device=plan.gslab.device)
    gen.manual_seed(SEED + n)
    contrib = torch.rand(plan.route_n, generator=gen,
                         device=plan.gslab.device)
    route_ms = _device_ms(lambda: apply_route(plan.schedule, contrib,
                                              plan.tables))
    phase("xfoot-shard kernels", n_shards=n, kernel="main route",
          route_n=plan.route_n, ops=len(plan.schedule),
          k1_layers=sum(op[0] == "gather" for op in plan.schedule),
          device_ms=f"{route_ms:.5f}", card=card_line())


def _tensors_of(obj) -> list:
    """Every tensor of a plan or shard container, in field order."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        for e in (v if isinstance(v, tuple) else (v,)):
            if isinstance(e, torch.Tensor):
                out.append(e)
            elif dataclasses.is_dataclass(e):
                out.extend(_tensors_of(e))
    return out


def xfoot_phases(A, x, xd, yd, want, mesh, counters, none,
                 kernels) -> None:
    """[xfoot], [xfoot-extract], [xfoot-shard] and [plancache] on the
    webbase-1M proxy: the footprint-compressed exchange at world 1, the
    extraction engines and the worst shard's compute at 4 and 16 shards,
    the fused SpMV (P1), and the plan cache on the card."""
    from sblas_tpu_torch import scaling
    from sblas_tpu_torch.containers import DenseVector
    from sblas_tpu_torch.experiments.stage_fuse_probe import (
        pass1_operands, pass1_tiles_stock, spmv_routed_fused1,
        stage_fuse_gather)
    from sblas_tpu_torch.io.plancache import load_plan, save_plan
    from sblas_tpu_torch.ops.cpu_reference import spmv_cpu
    from sblas_tpu_torch.ops.rspmv import RoutedPlan, spmv_routed, x_slabs_of
    from sblas_tpu_torch.parallel import (Mesh, partition_xfoot, spmv_xfoot,
                                          spmv_xfoot_nocomm,
                                          xfoot_worst_local)
    from sblas_tpu_torch.parallel.modes import row_block
    from sblas_tpu_torch.parallel.xfoot import (_xfoot_analyze, send_tables,
                                                xfoot_extract)
    dev, f32 = mesh.device, torch.float32

    # ---- [xfoot]: world 1, the chosen (routed) shard kind ----
    t0 = time.perf_counter()
    xs1 = partition_xfoot(A, 1, dtype=f32, device=dev, rank=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if xs1.kind != "routed":
        raise AssertionError(f"world-1 xfoot shards are {xs1.kind}, "
                             f"expected routed")
    p1 = xs1.local(0).plan
    routed = dict(none, **k1_split(*routes_of(p1)), tile_gather=1)
    run = lambda: spmv_xfoot(xs1, xd, ALPHA, BETA, yd, mesh)  # noqa: E731
    out, counts = launches_of(counters, run)
    expect_launches("spmv_xfoot", counts, routed)
    phase("xfoot", path="spmv_xfoot (world 1)", kind=xs1.kind,
          extract=xs1.extract_mode, w_ext=p1.shape[1],
          n_gtiles=p1.n_gtiles, build_s=f"{build_s:.2f}", launches=counts,
          check=checked("spmv_xfoot", out, want),
          **recorded("spmv_xfoot", call_times(run, A.nnz)))
    want_nc = spmv_cpu(A, x, 1.0, 0.0, DenseVector.constant(
        A.height, 0.0, dtype=np.float32))
    run = lambda: spmv_xfoot_nocomm(xs1, xd, mesh)  # noqa: E731
    out, counts = launches_of(counters, run)
    expect_launches("spmv_xfoot_nocomm", counts, routed)
    phase("xfoot", path="spmv_xfoot_nocomm (world 1)", launches=counts,
          check=checked("spmv_xfoot_nocomm", out, want_nc),
          **call_times(run, A.nnz))
    del out, want_nc
    bf16_transport_dist(
        A, xd, yd, want, mesh, counters, none, kernels, partition_xfoot,
        lambda xs: spmv_xfoot(xs, xd, ALPHA, BETA, yd, mesh),
        "spmv_xfoot bf16 transport")

    # ---- [xfoot-extract]: rank 0's extraction, each engine forced ----
    per_elem = {}
    for n in (4, 16):
        lay = _xfoot_analyze(A, n)
        used = torch.from_numpy(send_tables(lay, n)[1][0]).to(dev)
        res = {}
        for engine in ("flat", "route"):
            sh = partition_xfoot(A, n, dtype=f32, kind="coo", extract=engine,
                                 device=dev, rank=0)
            x_blk = row_block(xd, Mesh(None, 0, n, dev), sh.r_x * n)
            run = (lambda sh=sh, x_blk=x_blk:
                   xfoot_extract(sh, sh.local(0), x_blk))
            packed, counts = launches_of(counters, run)
            k1 = sum(op[0] == "gather" for op in sh.xroute_schedule)
            expect_launches(f"extraction {engine} n={n}", counts,
                            dict(none, **k1_split(sh.xroute_schedule)))
            res[engine] = (packed, _device_ms(run), k1)
        (pf, ms_f, _), (pr, ms_r, k1) = res["flat"], res["route"]
        if not torch.equal(pf[used], pr[used]):
            raise AssertionError(f"n={n}: flat and route extractions differ")
        out_slots, space = lay["Hmax"] + n * lay["P"], lay["route_space"]
        g_ns, r_ns = ms_f * 1e6 / out_slots, ms_r * 1e6 / space
        per_elem[n] = (g_ns, r_ns)
        st = lay["stats"]
        phase("xfoot-extract", n_shards=n, hot_total=st.hot_total,
              hot_own_max=st.hot_own_max, packet_pad=st.packet_pad,
              out_slots=out_slots, real_slots=int(used.sum()),
              route_space=space, k1_per_route=k1, bitwise_equal=True,
              flat_ms=f"{ms_f:.5f}", route_ms=f"{ms_r:.5f}",
              gather_ns=f"{g_ns:.5f}", route_ns=f"{r_ns:.5f}",
              engine_at_these=("flat" if g_ns * out_slots <= r_ns * space
                               else "route"),
              engine_chosen=st.extract_mode)
    g = float(np.mean([v[0] for v in per_elem.values()]))
    r = float(np.mean([v[1] for v in per_elem.values()]))
    phase("xfoot-extract", mean_gather_ns=f"{g:.5f}",
          mean_route_ns=f"{r:.5f}", constants=scaling.param_provenance())

    # ---- [xfoot-shard]: the worst shard's compute, stock and fused ----
    for n in (4, 16):
        t0 = time.perf_counter()
        local, (tg, srs, prs, sks) = xfoot_worst_local(A, n)
        plan = RoutedPlan.from_csr(local, dtype=f32, min_gtiles=tg,
                                   min_srows=srs, min_prows=prs,
                                   min_sranks=sks, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        xv = DenseVector.random(local.shape[1], dtype=np.float32)
        yv = DenseVector.constant(local.shape[0], 1.0, dtype=np.float32)
        xl = torch.from_numpy(xv.values).to(dev)
        yl = torch.from_numpy(yv.values).to(dev)
        want_l = spmv_cpu(local, xv, ALPHA, BETA, yv)
        runs = {"stock": lambda: spmv_routed(plan, xl, ALPHA, BETA, yl),
                "fused": lambda: spmv_routed_fused1(plan, xl, ALPHA, BETA,
                                                    yl)}
        # P1 does the main route's first gather (the peeled rows' part
        # of it stays a K1 row body): the rest of that route starts with
        # a transpose, which stays a copy
        k1_stock = k1_split(*routes_of(plan))
        k1_fused = k1_split(plan.xroute_schedule, plan.schedule[1:],
                            plan.unrank_schedule)
        k1_fused["lane_shuffle"] += 1 if plan.n_prows else 0
        expect = {"stock": dict(none, **k1_stock, slab_gather=1),
                  "fused": dict(none, stage_fuse_gather=1, **k1_fused)}
        checks, launched = {}, {}
        for name, run in runs.items():
            out, launched[name] = launches_of(counters, run)
            expect_launches(f"xfoot-shard {name} n={n}", launched[name],
                            expect[name])
            if name == "stock":
                ran = k1_k2_launches(f"xfoot-shard stock n={n}",
                                     dict(**k1_stock, slab_gather=1))
            checks[name] = checked(f"xfoot-shard {name} n={n}", out, want_l)
        if not torch.equal(stage_fuse_gather(*pass1_operands(plan, xl)),
                           pass1_tiles_stock(plan, xl)):
            raise AssertionError(f"n={n}: P1's pass-1 tiles differ from K2 "
                                 f"then K1")
        stage_fuse_gather.launches = 0
        phase("xfoot-shard", n_shards=n, shape=local.shape, nnz=local.nnz,
              n_gtiles=plan.n_gtiles, n_prows=plan.n_prows,
              route_n=plan.route_n, build_s=f"{build_s:.2f}",
              pass1_bitwise_equal=True, **{f"{k}_launches": v
                                           for k, v in launched.items()},
              **{f"{k}_check": v for k, v in checks.items()})
        for name in ("stock", "fused", "fused", "stock"):
            phase("xfoot-shard", n_shards=n, path=name,
                  **call_times(runs[name], local.nnz))
        shard_k1_k2(plan, n, ran)
        if n == 16:
            # the full plan's reading stays; the shard's goes beside it
            shard = p1_compare(plan, x_slabs_of(plan, xl),
                               "xfoot worst shard of 16")
            kernels["stage_fuse_gather"].update(
                launches=launched["fused"]["stage_fuse_gather"],
                shard16_n_gtiles=plan.n_gtiles,
                **{f"shard16_{k}": shard[k] for k in (
                    "ms", "plain_ms", "bound_ms", "max_abs_err")})
            plan16, xl16, yl16, want16 = plan, xl, yl, want_l

    # ---- [plancache]: save, load on the card, compare, run once ----
    with tempfile.TemporaryDirectory() as tmp:
        files = {"xfoot1": (xs1, os.path.join(tmp, "xfoot1.npz")),
                 "routed16": (plan16, os.path.join(tmp, "routed16.npz"))}
        t0 = time.perf_counter()
        for obj, path in files.values():
            save_plan(path, obj)
        save_s = time.perf_counter() - t0
        mb = sum(os.path.getsize(p) for _, p in files.values()) / 1e6
        t0 = time.perf_counter()
        loaded = {k: load_plan(p, dev) for k, (_, p) in files.items()}
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    for k, (obj, _) in files.items():
        a, b = _tensors_of(obj), _tensors_of(loaded[k])
        if len(a) != len(b) or not all(
                u.device == v.device and u.dtype == v.dtype
                and torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"plan cache: loaded {k} differs")
    phase("plancache", files=len(files), mb=f"{mb:.1f}",
          save_s=f"{save_s:.2f}", load_s=f"{load_s:.2f}",
          tensors=sum(len(_tensors_of(o)) for o, _ in files.values()),
          bitwise_equal=True,
          xfoot_check=checked("loaded xfoot shards", spmv_xfoot(
              loaded["xfoot1"], xd, ALPHA, BETA, yd, mesh), want),
          routed_check=checked("loaded routed plan", spmv_routed(
              loaded["routed16"], xl16, ALPHA, BETA, yl16), want16))


def p2_phase(A, Bd, counters, none, kernels) -> None:
    """[p2]: kernel P2, the B-row window gather, on webbase x K against
    its plain version, every gathered row against B, and its yardsticks:
    the flat `index_select` of the same rows in f32 and bf16, and the
    64-wide row permutation the unfused form would need as a bridge.
    Then [f64]: P2[f64] on the same windows of B at f64, the same
    checks, beside the f64 `index_select`."""
    import torch.nn.functional as F

    from sblas_tpu_torch.experiments.wcoo_gather_probe import (
        window_lane_gather, window_lane_gather_plain, window_layout)
    dev, K, n = Bd.device, Bd.shape[1], A.shape[1]
    n_pad = -(-n // 128) * 128
    B = F.pad(Bd, (0, 0, 0, n_pad - Bd.shape[0]))
    cols = np.sort(A.col_idx.astype(np.int32))
    wblk, lanes, slot, n_win = window_layout(cols)
    T = len(wblk)
    args = (B, torch.from_numpy(wblk).to(dev),
            torch.from_numpy(lanes).to(dev))
    err, _, ms, plain_ms = compare(
        "window_lane_gather", lambda: window_lane_gather(*args),
        lambda: window_lane_gather_plain(*args), window_lane_gather)
    out, counts = launches_of(counters, lambda: window_lane_gather(*args))
    expect_launches("window gather", counts, dict(none, window_lane_gather=1))
    cols_d = torch.from_numpy(cols.astype(np.int64)).to(dev)
    picked = out.transpose(1, 2).reshape(T * 128, K)
    if not torch.equal(picked[torch.from_numpy(slot).to(dev)],
                       torch.index_select(B, 0, cols_d)):
        raise AssertionError("P2: a gathered row differs from B's")
    del out, picked
    lib_ms = _device_ms(lambda: torch.index_select(B, 0, cols_d))
    B16 = B.to(torch.bfloat16)
    lib16_ms = _device_ms(lambda: torch.index_select(B16, 0, cols_d))
    del B16
    G = torch.index_select(B, 0, cols_d)
    perm = torch.randperm(len(cols), device=dev)
    bridge_ms = _device_ms(lambda: torch.index_select(G, 0, perm))
    del G
    rec = bound(T * K * 128 * B.element_size() + nbytes(*args[1:])
                + n_win * 128 * K * B.element_size(), 0)
    phase("p2", K=K, tiles=T, windows=n_win, fill=f"{T * 128 / A.nnz:.3f}",
          rows_checked=len(cols), bitwise_equal=True, launches=counts,
          ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          bound_ms=f"{rec['bound_ms']:.5f}", bound_by=rec["bound_by"],
          index_select_ms=f"{lib_ms:.5f}",
          index_select_bf16_ms=f"{lib16_ms:.5f}",
          bridge_ms=f"{bridge_ms:.5f}",
          bridge_ns_per_row=f"{bridge_ms * 1e6 / len(cols):.4f}")
    kernels["window_lane_gather"] = dict(
        name="window_lane_gather", route="cuda",
        source="sblas_tpu_torch/csrc/probe_kernels.cu",
        replaces="experiments/wcoo_gather_probe.py:112",
        launches=counts["window_lane_gather"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, **rec)

    t0 = time.perf_counter()
    args = (B.double(), *args[1:])
    del B
    err, _, ms, plain_ms = compare(
        "window_lane_gather[f64]", lambda: window_lane_gather(*args),
        lambda: window_lane_gather_plain(*args), window_lane_gather)
    out, counts = launches_of(counters, lambda: window_lane_gather(*args))
    expect_launches("window gather f64", counts,
                    dict(none, window_lane_gather=1))
    variant_launches("window gather f64", {"window_lane_gather_f64": 1})
    picked = out.transpose(1, 2).reshape(T * 128, K)
    if not torch.equal(picked[torch.from_numpy(slot).to(dev)],
                       torch.index_select(args[0], 0, cols_d)):
        raise AssertionError("P2[f64]: a gathered row differs from B's")
    del out, picked
    lib_ms = _device_ms(lambda: torch.index_select(args[0], 0, cols_d))
    kernels["window_lane_gather[f64]"] = dict(
        kernel_rec("window_lane_gather", "f64", "probe_kernels.cu",
                   "experiments/wcoo_gather_probe.py:112", err, ms,
                   plain_ms, lib_ms,
                   bound(T * K * 128 * 8 + nbytes(*args[1:])
                         + n_win * 128 * K * 8, 0)),
        launches=counts["window_lane_gather"])
    f64_line("window_lane_gather", kernels["window_lane_gather[f64]"],
             K=K, tiles=T, rows_checked=len(cols), bitwise_equal=True,
             card=card_line())
    F64_SECONDS["p2"] = time.perf_counter() - t0


def spmm_dist_webbase(A, wplan, Bd, Cd, want, mesh, counters, none) -> None:
    """[spmm-dist] on webbase x K: mode 2 over WCOO shards (K3) and mode 1
    over the WcooPlan (K3), world 1."""
    from sblas_tpu_torch.ops.wcoo import k_chunk_width
    from sblas_tpu_torch.parallel import (partition_row_plans, spmm_mode1,
                                          spmm_mode2_planned)
    K = Bd.shape[1]
    wsh = partition_row_plans(A, 1, dtype=torch.float32, device=mesh.device)
    if wsh.kind != "wcoo":
        raise AssertionError(f"webbase SpMM shards are {wsh.kind}, "
                             f"expected wcoo")
    kc = k_chunk_width(wsh.local(0).n_tiles, K)
    out, counts = launches_of(counters, lambda: spmm_mode2_planned(
        wsh, Bd, ALPHA, BETA, Cd, mesh))
    expect_launches("spmm_mode2_planned wcoo", counts,
                    dict(none, window_reduce=-(-K // kc)))
    phase("spmm-dist", path="spmm_mode2_planned psum (WCOO shards)", K=K,
          launches=counts, check=checked("2p wcoo", out, want),
          **recorded("spmm_mode2_planned wcoo", call_times(
              lambda: spmm_mode2_planned(wsh, Bd, ALPHA, BETA, Cd, mesh),
              A.nnz, K)))
    del wsh
    kc = k_chunk_width(wplan.n_tiles, K)
    out, counts = launches_of(counters, lambda: spmm_mode1(
        wplan, Bd, ALPHA, BETA, Cd, mesh))
    expect_launches("spmm_mode1 wcoo", counts,
                    dict(none, window_reduce=-(-K // kc)))
    phase("spmm-dist", path="spmm_mode1 (WcooPlan)", K=K, launches=counts,
          check=checked("mode1 wcoo", out, want),
          **recorded("spmm_mode1 wcoo", call_times(
              lambda: spmm_mode1(wplan, Bd, ALPHA, BETA, Cd, mesh), A.nnz,
              K, reps=10)))


def spmm_dist_shell(S, Bd, Cd, want, mesh, mesh2, counters, none) -> None:
    """[spmm-dist] on the shell x K, world 1: mode 2 over DIA shards and
    over COO segments, the halo SpMM and the 1x1 hier mode (one K5
    launch each over DIA shards)."""
    from sblas_tpu_torch.parallel import (partition_halo_dia,
                                          partition_row_plans,
                                          spmm_halo_planned, spmm_mode2,
                                          spmm_mode2_hier,
                                          spmm_mode2_planned)
    from sblas_tpu_torch.partition import partition_nnz_balanced
    dev, K, f32 = mesh.device, Bd.shape[1], torch.float32
    dia = partition_row_plans(S, 1, dtype=f32, kind="dia", device=dev)
    segs = partition_nnz_balanced(S, 1, dtype=f32, device=dev)
    halo = partition_halo_dia(S, 1, dtype=f32, device=dev)
    runs = {
        "spmm_mode2_planned psum (DIA shards)":
            lambda: spmm_mode2_planned(dia, Bd, ALPHA, BETA, Cd, mesh),
        "spmm_mode2 psum (COO segments)":
            lambda: spmm_mode2(segs, Bd, ALPHA, BETA, Cd, mesh),
        "spmm_halo_planned": lambda: spmm_halo_planned(halo, Bd, ALPHA, BETA,
                                                       Cd, mesh),
        "spmm_mode2_hier 1x1 (DIA shards)":
            lambda: spmm_mode2_hier(dia, Bd, ALPHA, BETA, Cd, mesh2),
    }
    for path, run in runs.items():
        out, counts = launches_of(counters, run)
        expect_launches(path, counts,
                        none if "COO" in path else dict(none, dia_spmm=1))
        phase("spmm-dist", path=path, K=K, launches=counts,
              check=checked(path, out, want),
              **recorded(path, call_times(run, S.nnz, K)))
    del dia, segs, halo
    halo16 = partition_halo_dia(S, 1, dtype=BF16, device=dev)
    B16, C16 = Bd.to(BF16), Cd.to(BF16)
    bf16_dist_run("spmm_halo_planned shell (DIA shards)", lambda:
                  spmm_halo_planned(halo16, B16, ALPHA, BETA, C16, mesh),
                  want, counters, none, {}, {}, F32_RECORD[
                      "spmm_halo_planned"], S.nnz, K)


def bench_phase(card) -> None:
    """[bench]: `python -m sblas_tpu_torch.bench --device cuda` at full
    size, in process (its oracle gates raise); its JSON line and the card
    line on one phase line."""
    from sblas_tpu_torch import bench
    t0 = time.perf_counter()
    text, rc = _cli(bench.main, ["--device", "cuda"])
    line = text.strip().splitlines()[-1]
    rec = json.loads(line)
    keys = {"spmm_shell", "spmv_webbase", "spmm_webbase_wcoo",
            "xfoot_shard4", "xfoot_shard16", "spmv_weak_shard4"}
    if (rc != 0 or not keys <= set(rec["repeats"])
            or not rec["value"] > 0 or not rec["device_value"] > 0):
        raise AssertionError(f"bench failed (rc={rc}):\n{text}")
    phase("bench", seconds=f"{time.perf_counter() - t0:.1f}", json=line,
          card=card)


def _host_residual(S, x, b) -> float:
    """||b - A x|| / ||b|| in float64 on the host (scipy CSR)."""
    r = b.astype(np.float64) - S @ x.cpu().numpy().astype(np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def solve_pair(title, run, check, counters, expect) -> dict:
    """[solve] one system: a CUDA-graph solve (its chunk captured on first
    use) with every launch counter from 0, then an eager solve, which must
    agree bitwise; `check(result)` holds it against numpy.  Then wall ms
    per iteration of whole solves (graph and eager in turns), and, from
    the solve's final state, wall and device ms per iteration of one
    replayed chunk and of one eager iteration, each timed on the same
    function (wall: the work and a synchronize, as the solver loop's flag
    read), and the idle share 1 - device / wall of each, unclamped.  The
    eager side is one iteration, not a chunk: a chunk's thousands of
    launches would fill the launch queue, and the host would then pace
    the device behind `device_time_ms`'s sleep."""
    from sblas_tpu_torch import solvers
    from sblas_tpu_torch.utils.timing import device_time_ms, wall_time_ms
    with solvers.recording() as rec:
        g, counts = launches_of(counters, lambda: run(True))
    prog, step, cond, chunk = rec[-1]
    del rec
    if prog.graph is None:
        raise AssertionError(f"{title}: no CUDA graph was captured")
    expect_launches(f"solve {title}", counts, expect)
    e = run(False)
    if g.iterations != e.iterations or not torch.equal(g.x, e.x):
        raise AssertionError(f"{title}: graph and eager solves differ "
                             f"({g.iterations} / {e.iterations} iterations)")
    host = check(g)
    walls = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        t0 = time.perf_counter()
        r = run(mode == "graph")
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) * 1e3 / r.iterations)
    work = {"graph": (prog.graph.replay, chunk),
            "eager": (lambda: solvers._masked(step, cond, prog.state,
                                              prog.consts), 1)}
    wall = {k: wall_time_ms(f, warmup=2, reps=10) / it
            for k, (f, it) in work.items()}
    dev = {k: device_time_ms(f, warmup=2, reps=10) / it
           for k, (f, it) in work.items()}
    phase("solve", system=title, iterations=g.iterations,
          converged=g.converged, residual=f"{g.residual:.3e}", check=host,
          graph_equals_eager_bitwise=True, launches=counts,
          chunk=chunk, captures=solvers.captures(),
          wall_ms_per_iter_solve_graph=" / ".join(f"{w:.5f}"
                                                  for w in walls["graph"]),
          wall_ms_per_iter_solve_eager=" / ".join(f"{w:.5f}"
                                                  for w in walls["eager"]),
          wall_ms_per_iter_replay=f"{wall['graph']:.5f}",
          wall_ms_per_iter_eager=f"{wall['eager']:.5f}",
          device_ms_per_iter_graph=f"{dev['graph']:.5f}",
          device_ms_per_iter_eager=f"{dev['eager']:.5f}",
          idle_share_graph=f"{1 - dev['graph'] / wall['graph']:.3f}",
          idle_share_eager=f"{1 - dev['eager'] / wall['eager']:.3f}")
    return dict(result=g, wall=wall, dev=dev)


def solve_phases(A, mesh, counters, none) -> None:
    """[solve] and [solve-dist]: CG (plain and Jacobi) on the shell SPD
    system, PageRank on the webbase-1M P^T (routed: K1, K2), BiCGSTAB on
    webbase-1M made diagonally dominant (routed), each through a CUDA
    graph and eagerly; then CG over routed `RowPlanShards` and PageRank
    over `XFootShards` in the world-1 NCCL group (eager chunks)."""
    from sblas_tpu_torch import solvers
    from sblas_tpu_torch.containers import CooMatrix
    from sblas_tpu_torch.examples.cg import build_spd, scipy_csr
    from sblas_tpu_torch.examples.pagerank import pagerank_numpy, transition
    from sblas_tpu_torch.ops import DiaPlan, make_plan
    from sblas_tpu_torch.ops.rspmv import RoutedPlan
    from sblas_tpu_torch.parallel import partition_row_plans, partition_xfoot
    dev, f32, tol, chunk = mesh.device, torch.float32, 1e-6, 16
    rng = np.random.RandomState(SEED)

    def routed_expect(plan, matvecs):
        return dict(none, slab_gather=matvecs,
                    **k1_split(*routes_of(plan), n=matvecs))

    def residual_check(S, b, bar):
        def check(res):
            rel = _host_residual(S, res.x, b)
            if not (res.converged and rel <= bar):
                raise AssertionError(f"host residual {rel:.3e} (bar {bar}), "
                                     f"converged {res.converged}")
            return f"host residual {rel:.3e} <= {bar}"
        return check

    # ---- CG on the shell SPD system (n ~ 90k) ----
    t0 = time.perf_counter()
    S = build_spd(90_449, np.float32)
    Ssp = scipy_csr(S)
    splan = make_plan(S, dtype=f32, op="spmv", device=dev)
    build_s = time.perf_counter() - t0
    x_true = rng.standard_normal(S.shape[0]).astype(np.float32)
    b = Ssp @ x_true
    bd = torch.from_numpy(b).to(dev)
    inv_d = solvers.jacobi_inv_diag(S, f32, device=dev)
    phase("solve", system="shell SPD", shape=S.shape, nnz=S.nnz,
          plan=type(splan).__name__, build_s=f"{build_s:.2f}")
    # over a DIA plan, K6 once a matvec: the eager initial residual, the
    # capture's warm-up step and the chunk's captured iterations
    cg_expect = (dict(none, dia_spmv=2 + chunk)
                 if isinstance(splan, DiaPlan) else none)
    cg_res = {}
    for label, M in (("cg", None), ("cg+jacobi", inv_d)):
        cg_res[label] = solve_pair(
            f"{label} shell SPD ({type(splan).__name__})",
            lambda graph, M=M: solvers.cg(splan, bd, tol=tol, maxiter=1000,
                                          M=M, chunk=chunk, graph=graph),
            residual_check(Ssp, b, 10 * tol), counters, cg_expect)
    del splan

    # ---- PageRank on the webbase-1M P^T (routed) ----
    t0 = time.perf_counter()
    PT, dangling = transition(A, np.float32)
    pplan = make_plan(PT, dtype=f32, op="spmv", device=dev)
    if not isinstance(pplan, RoutedPlan):
        raise AssertionError(f"P^T plan {type(pplan).__name__}, expected "
                             f"RoutedPlan")
    build_s = time.perf_counter() - t0
    n = PT.shape[0]
    dang = torch.from_numpy(dangling).to(dev)
    want_r = pagerank_numpy(PT, dangling, 0.85, tol)
    phase("solve", system="webbase-1M P^T", nnz=PT.nnz,
          plan="RoutedPlan", build_s=f"{build_s:.2f}",
          k1_per_spmv=pplan.n_route_gathers)

    def pr_check(res):
        r = res.x.cpu().numpy().astype(np.float64)
        err = float(np.abs(r - want_r).sum())
        if not (res.converged and abs(r.sum() - 1) < 1e-3 and err <= 10 * tol):
            raise AssertionError(f"PageRank: L1 {err:.3e} to numpy, sum "
                                 f"{r.sum()}, converged {res.converged}")
        return f"L1 to numpy {err:.3e} <= {10 * tol}"

    solve_pair("pagerank webbase-1M P^T (RoutedPlan)",
               lambda graph: solvers.pagerank(pplan, n, dangling=dang,
                                              tol=tol, maxiter=200,
                                              chunk=chunk, graph=graph),
               pr_check, counters, routed_expect(pplan, 1 + chunk))
    del pplan

    # ---- BiCGSTAB on webbase-1M made diagonally dominant (routed) ----
    coo = A.to_coo()
    rowsum = np.zeros(A.shape[0])
    np.add.at(rowsum, coo.row_idx, np.abs(coo.values))
    d = np.arange(A.shape[0])
    D = CooMatrix(np.concatenate([coo.row_idx, d]),
                  np.concatenate([coo.col_idx, d]),
                  np.concatenate([coo.values,
                                  1.0 + rowsum]).astype(np.float32),
                  A.shape).to_csr()
    del coo
    dplan = make_plan(D, dtype=f32, op="spmv", device=dev)
    if not isinstance(dplan, RoutedPlan):
        raise AssertionError(f"diagonally dominant webbase plan "
                             f"{type(dplan).__name__}, expected RoutedPlan")
    Dsp = scipy_csr(D)
    xd_true = rng.standard_normal(D.shape[0]).astype(np.float32)
    bD = Dsp @ xd_true
    bDd = torch.from_numpy(bD).to(dev)
    # off-diagonal mass nearly equal to the diagonal on the heavy rows:
    # about 150 iterations to 1e-5 at 200k rows, and f32's recurrence
    # stalls near 1e-6
    solve_pair("bicgstab webbase-1M + diag (RoutedPlan)",
               lambda graph: solvers.bicgstab(dplan, bDd, tol=10 * tol,
                                              maxiter=1000, chunk=chunk,
                                              graph=graph),
               residual_check(Dsp, bD, 100 * tol), counters,
               routed_expect(dplan, 1 + 2 * (1 + chunk)))
    del dplan, D, Dsp

    # ---- [solve-dist]: shards in the world-1 NCCL group, eager ----
    t0 = time.perf_counter()
    rsh = partition_row_plans(S, 1, dtype=f32, kind="routed", device=dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, counts = launches_of(counters, lambda: solvers.cg(
        rsh, bd, tol=tol, maxiter=1000, chunk=chunk, mesh=mesh))
    wall = (time.perf_counter() - t0) * 1e3 / res.iterations
    if counts["tile_gather"] == 0 or counts["slab_gather"]:
        raise AssertionError(f"CG over routed shards: launches {counts}")
    phase("solve-dist", system="cg shell SPD, routed RowPlanShards (world 1)",
          build_s=f"{build_s:.2f}", iterations=res.iterations,
          single_plan_iterations=cg_res["cg"]["result"].iterations,
          launches=counts,
          check=residual_check(Ssp, b, 10 * tol)(res),
          wall_ms_per_iter_eager=f"{wall:.5f}")
    del rsh
    t0 = time.perf_counter()
    xsh = partition_xfoot(PT, 1, dtype=f32, device=dev, rank=0)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, counts = launches_of(counters, lambda: solvers.pagerank(
        xsh, n, dangling=dang, tol=tol, maxiter=200, chunk=chunk,
        mesh=mesh))
    wall = (time.perf_counter() - t0) * 1e3 / res.iterations
    if counts["tile_gather"] == 0 or counts["slab_gather"]:
        raise AssertionError(f"PageRank over xfoot shards: launches {counts}")
    phase("solve-dist", system="pagerank webbase-1M P^T, XFootShards "
          "(world 1)", kind=xsh.kind, extract=xsh.extract_mode,
          build_s=f"{build_s:.2f}", iterations=res.iterations,
          launches=counts, check=pr_check(res),
          wall_ms_per_iter_eager=f"{wall:.5f}")
    solvers.clear_programs()


# ---- host-streamed execution (the UM analog) ----

UM_BUDGET_WEB = 16 << 20     # webbase-1M: 12 WCOO bands
UM_BUDGET_SHELL = 32 << 20   # the shell: ELL bands
UM_BUDGET_DENSE = 8 << 20    # below the shell's 23 MB C at K = 64


def pinned_copy(nbytes: int) -> dict:
    """A plain pinned host-to-device copy of `nbytes`, timed with events:
    the streaming roofline of an untuned call that copies as much."""
    from sblas_tpu_torch.utils.timing import device_time_ms
    src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = device_time_ms(lambda: dst.copy_(src, non_blocking=True), reps=20)
    return dict(ms=ms, gb_per_s=nbytes / ms / 1e6)


def um_run(title, hp, run, want, counters, none, k3_per_call, nnz, k=1,
           deterministic=True, budget=0, operands=(), tag="um",
           check=checked, variants=None, f32=None) -> torch.Tensor:
    """[um]: one streamed call of `run(tuning)` counted (K3 launches, by
    variant where `variants` is given, bands, bytes, the most bands on
    the device, peak device memory beside the budget and the dense
    operands' bytes), then a tuned one; both against the oracle with
    `check`, tuned = streamed bitwise where the band op is deterministic,
    wall and device ms of each, and the streamed call's device time
    against a plain pinned copy of its bytes.  The streamed call's bytes
    and device ms are kept under `title`; `f32` names an earlier title
    whose numbers are printed beside these."""
    from sblas_tpu_torch.memory.host import _INFLIGHT
    hp.remove_gpu_tuning()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, counts = launches_of(counters, lambda: run(False))
    peak = torch.cuda.max_memory_allocated() - base
    expect_launches(f"{title} streamed", counts,
                    dict(none, window_reduce=k3_per_call))
    by_variant = (variant_launches(f"{title} streamed", variants)
                  if variants is not None else None)
    st = hp.last_stream
    if st.bands != hp.n_bands or st.peak_resident > _INFLIGHT:
        raise AssertionError(f"{title}: streamed {st}, {hp.n_bands} bands")
    t0 = recorded(title, call_times(lambda: run(False), nnz, k, reps=15))
    F32_RECORD[f"{title} bytes"] = st.bytes
    copy = pinned_copy(st.bytes)
    beside = {} if f32 is None else dict(
        f32_bytes_streamed=F32_RECORD[f"{f32} bytes"],
        f32_device_ms=f"{F32_RECORD[f32]:.5f}")
    phase(tag, path=f"{title} tuning=0", bands=f"{hp.n_bands}x{hp.kind}",
          band_rows=hp.band_rows, dtype=hp.dtype, launches=counts,
          **({} if by_variant is None else dict(by_variant=by_variant)),
          check=check(f"{title} streamed", out, want),
          bytes_streamed=st.bytes, **beside,
          peak_resident_bands=st.peak_resident,
          max_memory_allocated=peak, budget=budget,
          operand_bytes=nbytes(*operands), result_bytes=nbytes(out),
          copy_ms=f"{copy['ms']:.5f}", copy_gb_s=f"{copy['gb_per_s']:.2f}",
          copy_share=f"{copy['ms'] / float(t0['device_ms']):.3f}", **t0)
    got, counts = launches_of(counters, lambda: run(True))
    expect_launches(f"{title} tuned", counts,
                    dict(none, window_reduce=k3_per_call))
    bitwise = torch.equal(got, out)
    if deterministic and not bitwise:
        raise AssertionError(f"{title}: tuned differs from streamed")
    phase(tag, path=f"{title} tuning=1", launches=counts,
          check=check(f"{title} tuned", got, want),
          tuned_equals_streamed_bitwise=bitwise,
          bitwise_required=deterministic,
          **call_times(lambda: run(True), nnz, k, reps=15))
    hp.remove_gpu_tuning()
    return counts["window_reduce"]


def um_webbase_phases(A, Bd, Cd, want_mm, mesh, counters, none,
                      kernels) -> None:
    """[um], [k3-band], [um-dist] on webbase-1M at UM_BUDGET_WEB: WCOO
    bands, K3 on every band."""
    from sblas_tpu_torch.containers import DenseVector
    from sblas_tpu_torch.memory import (host_resident_plan,
                                        host_resident_shards, spmm_um,
                                        spmm_um_dist, spmm_um_mode1, spmv_um,
                                        spmv_um_dist)
    from sblas_tpu_torch.ops.cpu_reference import spmv_cpu
    from sblas_tpu_torch.ops.wcoo import (k_chunk_width, window_reduce,
                                          window_reduce_plain)
    dev, K = Bd.device, Bd.shape[1]
    t0 = time.perf_counter()
    hp = host_resident_plan(A, dtype=torch.float32,
                            hbm_budget_bytes=UM_BUDGET_WEB, device=dev)
    build_s = time.perf_counter() - t0
    if hp.kind != "wcoo":
        raise AssertionError(f"webbase bands are {hp.kind}, expected wcoo")
    pinned = all(getattr(b, f).is_pinned() for b in hp.bands
                 for f in ("vals", "xblk", "k3_units"))
    if not pinned:
        raise AssertionError("webbase bands are not pinned")
    phase("um", plan="host_resident_plan webbase-1M",
          budget=UM_BUDGET_WEB, bands=f"{hp.n_bands}x{hp.kind}",
          band_mb=f"{hp.band_bytes / 2**20:.1f}", pinned=pinned,
          build_s=f"{build_s:.2f}")
    x = DenseVector.random(A.width, dtype=np.float32)
    y = DenseVector.constant(A.height, 1.0, dtype=np.float32)
    xd, yd = (torch.from_numpy(v.values).to(dev) for v in (x, y))
    want_mv = spmv_cpu(A, x, ALPHA, BETA, y)
    um_run("spmv_um webbase-1M", hp,
           lambda t: spmv_um(hp, xd, ALPHA, BETA, yd, tuning=t), want_mv,
           counters, none, 0, A.nnz, deterministic=False,
           budget=UM_BUDGET_WEB, operands=(xd, yd))
    chunks = -(-K // k_chunk_width(hp.bands[0].n_tiles, K))
    k3 = um_run(f"spmm_um webbase-1M K={K}", hp,
                lambda t: spmm_um(hp, Bd, ALPHA, BETA, Cd, tuning=t),
                want_mm, counters, none, hp.n_bands * chunks, A.nnz, K,
                budget=UM_BUDGET_WEB, operands=(Bd, Cd))
    kernels["window_reduce"]["um_launches"] = k3

    # [k3-band]: K3 at one streamed band's tables, its pad tiles included
    band = max(hp.bands, key=lambda b: int(
        (b.vals.reshape(b.n_tiles, -1) == 0).all(dim=1).sum())).to(dev)
    kc = k_chunk_width(band.n_tiles, K)
    args = (band.k3, band.wb, band.relrow, band.vals, band.xblk, band.lane,
            Bd, 0, kc)
    err, rel, ms, plain_ms = compare(
        "window_reduce (band)", lambda: window_reduce(*args),
        lambda: window_reduce_plain(*args), window_reduce, F32_REL_TOL)
    phase("k3-band", n_tiles=band.n_tiles,
          units=band.k3_units.shape[0], k3_rows=band.k3_rows.shape[0],
          max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", tol=F32_REL_TOL,
          deterministic=True, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}")
    del band, args

    # [um-dist]: v2 over one shard's bands, v1 over the whole plan
    hs = host_resident_shards(A, 1, dtype=torch.float32,
                              hbm_budget_bytes=UM_BUDGET_WEB, device=dev,
                              rank=0)
    runs = (("spmv_um_dist", want_mv, 0, 1, lambda t: spmv_um_dist(
                hs, xd, ALPHA, BETA, yd, mesh, tuning=t)),
            ("spmm_um_dist", want_mm, hs.n_bands * chunks, K,
             lambda t: spmm_um_dist(hs, Bd, ALPHA, BETA, Cd, mesh,
                                    tuning=t)),
            ("spmm_um_mode1", want_mm, hp.n_bands * chunks, K,
             lambda t: spmm_um_mode1(hp, Bd, ALPHA, BETA, Cd, mesh,
                                     tuning=t)))
    for name, want, k3_calls, k, run in runs:
        for tuning in (False, True):
            out, counts = launches_of(counters, lambda: run(tuning))
            expect_launches(name, counts, dict(none,
                                               window_reduce=k3_calls))
            phase("um-dist", path=f"{name} tuning={int(tuning)} (world 1)",
                  bands=f"{hs.n_bands}x{hs.kind}", launches=counts,
                  check=checked(name, out, want),
                  **recorded(f"{name} tuning={int(tuning)}", call_times(
                      lambda: run(tuning), A.nnz, k, reps=10)))
        hs.remove_gpu_tuning()
        hp.remove_gpu_tuning()


def bf16_dist_run(path, run, want, counters, none, expect, variants,
                  f32_ms, nnz, k=1, tag="bf16-dist", **extra) -> None:
    """[bf16-dist]: one run of a path over bf16 containers, its launches
    counted by counter (`expect`) and by variant (`variants`, exactly),
    its result bf16 and within the JAX package's bf16 bound of the oracle
    (max_rel printed), then wall and device ms beside the f32
    counterpart's device ms."""
    out, counts = launches_of(counters, run)
    expect_launches(path, counts, dict(none, **expect))
    by_variant = variant_launches(path, variants)
    if out.dtype != BF16:
        raise AssertionError(f"{path}: result is {out.dtype}, not bf16")
    phase(tag, path=path, **extra, launches=counts,
          by_variant=by_variant, check=checked_bf16(path, out, want),
          f32_device_ms=f"{f32_ms:.5f}",
          **call_times(run, nnz, k, reps=10))


def bf16_dist_webbase(A, wp, wplan, Bd, Cd, want_mm, mesh, counters,
                      none) -> None:
    """[bf16-dist] on webbase-1M in the world-1 group: mode 1 over the bf16
    WcooPlan (K3 `bf16`), mode 2 and the distributed SpMV over bf16 COO
    segments (f32 partials), the planned SpMV over bf16 routed shards (K1
    and K2' `bf16`), mode 2 over bf16 WCOO shards (K3 `bf16`) and the
    xfoot SpMV over a bf16 routed shard."""
    from sblas_tpu_torch.containers import DenseVector
    from sblas_tpu_torch.ops.cpu_reference import spmv_cpu
    from sblas_tpu_torch.ops.wcoo import k_chunk_width
    from sblas_tpu_torch.parallel import (partition_row_plans,
                                          partition_xfoot, spmm_mode1,
                                          spmm_mode2, spmm_mode2_nocomm,
                                          spmm_mode2_planned, spmv_dist,
                                          spmv_dist_planned, spmv_xfoot)
    from sblas_tpu_torch.partition import partition_nnz_balanced
    dev, K = Bd.device, Bd.shape[1]
    B16, C16 = Bd.to(BF16), Cd.to(BF16)
    x = DenseVector.random(A.width, dtype=np.float32)
    y = DenseVector.constant(A.height, 1.0, dtype=np.float32)
    x16, y16 = (torch.from_numpy(v.values).to(dev).to(BF16) for v in (x, y))
    want_mv = spmv_cpu(A, x, ALPHA, BETA, y)
    chunks = -(-K // k_chunk_width(wp.n_tiles, K))
    bf16_dist_run("spmm_mode1 (WcooPlan bf16)", lambda: spmm_mode1(
        wp, B16, ALPHA, BETA, C16, mesh), want_mm, counters, none,
        dict(window_reduce=chunks), {"window_reduce_bf16": chunks},
        F32_RECORD["spmm_mode1 wcoo"], A.nnz, K)

    segs = partition_nnz_balanced(A, 1, dtype=BF16, device=dev)
    segs32 = partition_nnz_balanced(A, 1, dtype=torch.float32, device=dev)
    partial = spmm_mode2_nocomm(segs, B16, mesh)
    f32_ms = _device_ms(lambda: spmm_mode2(segs32, Bd, ALPHA, BETA, Cd,
                                           mesh))
    del segs32
    bf16_dist_run("spmm_mode2 psum (COO segments bf16)", lambda: spmm_mode2(
        segs, B16, ALPHA, BETA, C16, mesh), want_mm, counters, none, {}, {},
        f32_ms, A.nnz, K, partial=partial.dtype,
        all_reduce_bytes=nbytes(partial))
    del partial
    bf16_dist_run("spmv_dist psum (COO segments bf16)", lambda: spmv_dist(
        segs, x16, ALPHA, BETA, y16, mesh), want_mv, counters, none, {}, {},
        F32_RECORD["spmv_dist"], A.nnz)
    del segs

    for title, build, run, f32_path in (
            ("spmv_dist_planned psum (routed shards bf16)",
             lambda: partition_row_plans(A, 1, dtype=BF16, op="spmv",
                                         device=dev),
             lambda sh: spmv_dist_planned(sh, x16, ALPHA, BETA, y16, mesh),
             "spmv_dist_planned psum"),
            ("spmv_xfoot (world 1, bf16)",
             lambda: partition_xfoot(A, 1, dtype=BF16, device=dev, rank=0),
             lambda xs: spmv_xfoot(xs, x16, ALPHA, BETA, y16, mesh),
             "spmv_xfoot")):
        t0 = time.perf_counter()
        sh = build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        p = sh.local(0)
        p = getattr(p, "plan", p)
        if sh.kind != "routed" or p.dtype != BF16:
            raise AssertionError(f"{title}: {sh.kind} shards of {p.dtype}")
        bf16_dist_run(title, lambda: run(sh), want_mv, counters, none,
                      dict(**k1_split(*routes_of(p)), tile_gather=1),
                      {**k1_variants("bf16", *routes_of(p)),
                       "tile_gather_bf16": 1}, F32_RECORD[f32_path], A.nnz,
                      build_s=f"{build_s:.2f}", k1_per_spmv=p.n_route_gathers)
        del sh, p

    t0 = time.perf_counter()
    wsh = partition_row_plans(A, 1, dtype=BF16, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if wsh.kind != "wcoo" or wsh.local(0).dtype != BF16:
        raise AssertionError(f"webbase bf16 SpMM shards are {wsh.kind}")
    chunks = -(-K // k_chunk_width(wsh.local(0).n_tiles, K))
    bf16_dist_run("spmm_mode2_planned psum (WCOO shards bf16)",
                  lambda: spmm_mode2_planned(wsh, B16, ALPHA, BETA, C16,
                                             mesh),
                  want_mm, counters, none, dict(window_reduce=chunks),
                  {"window_reduce_bf16": chunks},
                  F32_RECORD["spmm_mode2_planned wcoo"], A.nnz, K,
                  build_s=f"{build_s:.2f}")


def um_bf16_phases(A, Bd, Cd, want_mm, mesh, counters, none) -> None:
    """[um bf16] on webbase-1M at UM_BUDGET_WEB: bf16 bands, sized by
    2-byte values and pinned as bf16, streamed and tuned (spmv_um;
    spmm_um through K3 `bf16` once a band), beside the f32 plan's bytes
    and device ms; then the world-1 UM modes over bf16 shards."""
    from sblas_tpu_torch.containers import DenseVector
    from sblas_tpu_torch.memory import (host_resident_plan,
                                        host_resident_shards, spmm_um,
                                        spmm_um_dist, spmm_um_mode1, spmv_um,
                                        spmv_um_dist)
    from sblas_tpu_torch.memory.host import tensor_fields
    from sblas_tpu_torch.ops.cpu_reference import spmv_cpu
    from sblas_tpu_torch.ops.wcoo import k_chunk_width
    dev, K = Bd.device, Bd.shape[1]
    t0 = time.perf_counter()
    hp = host_resident_plan(A, dtype=BF16, hbm_budget_bytes=UM_BUDGET_WEB,
                            device=dev)
    build_s = time.perf_counter() - t0
    pinned = all(getattr(b, f).is_pinned() for b in hp.bands
                 for f in tensor_fields(b))
    if hp.kind != "wcoo" or hp.dtype != BF16 or not pinned or any(
            b.vals.dtype != BF16 for b in hp.bands):
        raise AssertionError(f"webbase bf16 bands: {hp.kind}, {hp.dtype}, "
                             f"pinned={pinned}")
    phase("um bf16", plan="host_resident_plan webbase-1M bf16",
          budget=UM_BUDGET_WEB, bands=f"{hp.n_bands}x{hp.kind}",
          band_rows=hp.band_rows, band_mb=f"{hp.band_bytes / 2**20:.1f}",
          value_bytes=sum(nbytes(b.vals) for b in hp.bands), pinned=pinned,
          build_s=f"{build_s:.2f}")
    x = DenseVector.random(A.width, dtype=np.float32)
    y = DenseVector.constant(A.height, 1.0, dtype=np.float32)
    x16, y16 = (torch.from_numpy(v.values).to(dev).to(BF16) for v in (x, y))
    B16, C16 = Bd.to(BF16), Cd.to(BF16)
    want_mv = spmv_cpu(A, x, ALPHA, BETA, y)
    um_run("spmv_um webbase-1M bf16", hp,
           lambda t: spmv_um(hp, x16, ALPHA, BETA, y16, tuning=t), want_mv,
           counters, none, 0, A.nnz, deterministic=False,
           budget=UM_BUDGET_WEB, operands=(x16, y16), tag="um bf16",
           check=checked_bf16, variants={}, f32="spmv_um webbase-1M")
    chunks = -(-K // k_chunk_width(hp.bands[0].n_tiles, K))
    um_run(f"spmm_um webbase-1M K={K} bf16", hp,
           lambda t: spmm_um(hp, B16, ALPHA, BETA, C16, tuning=t), want_mm,
           counters, none, hp.n_bands * chunks, A.nnz, K,
           budget=UM_BUDGET_WEB, operands=(B16, C16), tag="um bf16",
           check=checked_bf16,
           variants={"window_reduce_bf16": hp.n_bands * chunks},
           f32=f"spmm_um webbase-1M K={K}")

    hs = host_resident_shards(A, 1, dtype=BF16,
                              hbm_budget_bytes=UM_BUDGET_WEB, device=dev,
                              rank=0)
    k3 = {"spmv_um_dist": 0, "spmm_um_dist": hs.n_bands * chunks,
          "spmm_um_mode1": hp.n_bands * chunks}
    runs = {"spmv_um_dist": (want_mv, 1, lambda: spmv_um_dist(
                hs, x16, ALPHA, BETA, y16, mesh)),
            "spmm_um_dist": (want_mm, K, lambda: spmm_um_dist(
                hs, B16, ALPHA, BETA, C16, mesh)),
            "spmm_um_mode1": (want_mm, K, lambda: spmm_um_mode1(
                hp, B16, ALPHA, BETA, C16, mesh))}
    for name, (want, k, run) in runs.items():
        variants = {"window_reduce_bf16": k3[name]} if k3[name] else {}
        bf16_dist_run(f"{name} tuning=0 (world 1, bf16 bands)", run, want,
                      counters, none, dict(window_reduce=k3[name]), variants,
                      F32_RECORD[f"{name} tuning=0"], A.nnz, k,
                      tag="um bf16", bands=f"{hs.n_bands}x{hs.kind}")


def um_shell_phases(S, Bs, Cs, Bd, Cd, want_mm, counters, none) -> None:
    """[um] on the shell at UM_BUDGET_SHELL (ELL bands), then [um-dense]:
    A, B and C host-resident with a budget below C."""
    from sblas_tpu_torch.containers import DenseVector
    from sblas_tpu_torch.memory import (HostDense, host_resident_grid,
                                        host_resident_plan, spmm_um,
                                        spmm_um_hostdense, spmv_um_hostdense)
    from sblas_tpu_torch.ops.cpu_reference import spmv_cpu
    from sblas_tpu_torch.utils.timing import wall_time_ms
    dev, K = Bd.device, Bd.shape[1]
    hp = host_resident_plan(S, dtype=torch.float32,
                            hbm_budget_bytes=UM_BUDGET_SHELL, device=dev)
    if hp.kind != "ell":
        raise AssertionError(f"shell bands are {hp.kind}, expected ell")
    um_run(f"spmm_um shell K={K}", hp,
           lambda t: spmm_um(hp, Bd, ALPHA, BETA, Cd, tuning=t), want_mm,
           counters, none, 0, S.nnz, K, budget=UM_BUDGET_SHELL,
           operands=(Bd, Cd))
    del hp

    grid = host_resident_grid(S, dtype=torch.float32,
                              hbm_budget_bytes=UM_BUDGET_DENSE, k=K,
                              device=dev)
    Bh = HostDense.from_array(Bs, device=dev)
    Ch = HostDense.from_array(Cs, device=dev)
    outs, walls = [], []
    for tuning in (False, True):
        grid.remove_gpu_tuning()
        Bh.remove_gpu_tuning()
        out, counts = launches_of(counters, lambda: spmm_um_hostdense(
            grid, Bh, ALPHA, BETA, Ch, tuning=tuning))
        expect_launches("spmm_um_hostdense", counts, none)
        outs.append(out.to_numpy().copy())
        walls.append(wall_time_ms(lambda: spmm_um_hostdense(
            grid, Bh, ALPHA, BETA, Ch, tuning=tuning), warmup=2, reps=5))
        phase("um-dense", path=f"spmm_um_hostdense shell K={K} "
              f"tuning={int(tuning)}", budget=UM_BUDGET_DENSE,
              c_bytes=Cs.nbytes, grid=f"{grid.n_bands}x{grid.n_chunks}",
              cells=len(grid.cells), kind=grid.kind,
              pinned=out.values.is_pinned(),
              check=checked("spmm_um_hostdense", torch.from_numpy(outs[-1]),
                            want_mm), wall_ms=f"{walls[-1]:.5f}")
    if not np.array_equal(*outs):
        raise AssertionError("spmm_um_hostdense: tuned differs from "
                             "streamed")
    grid.remove_gpu_tuning()
    Bh.remove_gpu_tuning()
    del grid, Bh, Ch
    # [um bf16]: the same grid with bf16 cells and bf16 pinned operands
    grid16 = host_resident_grid(S, dtype=BF16,
                                hbm_budget_bytes=UM_BUDGET_DENSE, k=K,
                                device=dev)
    Bh16, Ch16 = (HostDense.from_array(torch.from_numpy(v).to(BF16),
                                       device=dev) for v in (Bs, Cs))
    run16 = lambda: spmm_um_hostdense(  # noqa: E731
        grid16, Bh16, ALPHA, BETA, Ch16)
    out, counts = launches_of(counters, run16)
    expect_launches("spmm_um_hostdense bf16", counts, none)
    variant_launches("spmm_um_hostdense bf16", {})
    pinned = all(c.vals.dtype == BF16 and c.vals.is_pinned()
                 for c in grid16.cells.values())
    if not pinned or out.values.dtype != BF16 or not \
            out.values.is_pinned():
        raise AssertionError("spmm_um_hostdense bf16: cells or result not "
                             "pinned bf16")
    phase("um bf16", path=f"spmm_um_hostdense shell K={K} bf16",
          budget=UM_BUDGET_DENSE, grid=f"{grid16.n_bands}x{grid16.n_chunks}",
          cells=len(grid16.cells), kind=grid16.kind, pinned_bf16=pinned,
          check=checked_bf16("spmm_um_hostdense bf16", out.values, want_mm),
          wall_ms=f"{wall_time_ms(run16, warmup=2, reps=5):.5f}",
          f32_wall_ms=f"{walls[0]:.5f}")
    del grid16, Bh16, Ch16, out
    grid1 = host_resident_grid(S, dtype=torch.float32,
                               hbm_budget_bytes=UM_BUDGET_DENSE, k=1,
                               device=dev)
    x = DenseVector.random(S.width, dtype=np.float32)
    y = DenseVector.constant(S.height, 1.0, dtype=np.float32)
    xh, yh = (HostDense.from_array(v.values, device=dev) for v in (x, y))
    got = spmv_um_hostdense(grid1, xh, ALPHA, BETA, yh)
    phase("um-dense", path="spmv_um_hostdense shell",
          grid=f"{grid1.n_bands}x{grid1.n_chunks}", cells=len(grid1.cells),
          check=checked("spmv_um_hostdense",
                        torch.from_numpy(got.to_numpy().copy()),
                        spmv_cpu(S, x, ALPHA, BETA, y)),
          wall_ms=f"{wall_time_ms(lambda: spmv_um_hostdense(grid1, xh, ALPHA, BETA, yh), warmup=2, reps=5):.5f}")


def um_cli_phases(path, nnz, K) -> None:
    """spmv_test_um (tuning 0, 1) and spmm_test_um (methods 1 and 2, on
    one rank: n_devices 2 in a world of one, tuning 0, 1) on `path`, with
    a budget that makes several bands."""
    from sblas_tpu_torch.cli import spmm_test_um, spmv_test_um
    os.environ["SBLAS_HBM_BUDGET"] = str(4 << 20)
    try:
        runs = [(spmv_test_um.main, "spmv_test_um",
                 [path, str(ALPHA), str(BETA), "1", t, "f32"])
                for t in ("0", "1")]
        runs += [(spmm_test_um.main, f"spmm_test_um method {m}",
                  [m, path, str(K), str(ALPHA), str(BETA), "2", t, "f32"])
                 for m in ("1", "2") for t in ("0", "1")]
        for main_fn, label, argv in runs:
            text, rc = _cli(main_fn, [*argv, "--device", "cuda"])
            if rc != 0 or "Validation = True" not in text:
                raise AssertionError(f"{label} {argv} failed (rc={rc}):\n"
                                     f"{text}")
            lines = text.splitlines()
            phase("cli um", cli=label, tuning=argv[-2], rc=rc, nnz=nnz,
                  validation=True,
                  matrix=next(ln for ln in lines if "band(s)" in ln
                              ).split("device(s)")[-1].strip(),
                  run=next(ln for ln in lines if "run time" in ln).strip())
    finally:
        del os.environ["SBLAS_HBM_BUDGET"]


def profiling_phase(dev) -> None:
    """[profiling]: `python -m sblas_tpu_torch.profiling --small`'s four
    traces, and one of a streamed WCOO SpMM (K3 inside), to a temp dir:
    each non-empty, naming its band ranges."""
    from sblas_tpu_torch import profiling
    from sblas_tpu_torch.io.generate import webbase_like
    from sblas_tpu_torch.memory import host_resident_plan, spmm_um
    with tempfile.TemporaryDirectory() as tmp:
        text, rc = _cli(profiling.main, [tmp, "--small", "--device",
                                         "cuda"])
        if rc != 0:
            raise AssertionError(f"profiling failed (rc={rc}):\n{text}")
        W = webbase_like(n=50_000, dtype=np.float32)
        hp = host_resident_plan(W, dtype=torch.float32,
                                hbm_budget_bytes=1 << 20, device=dev)
        B = torch.rand((W.width, 64), device=dev)
        C = torch.ones((W.height, 64), device=dev)
        profiling.trace("spmm_um_wcoo_tuning0", hp,
                        lambda: spmm_um(hp, B, 1.0, 1.0, C), tmp, dev)
        for name in ("spmm_um_tuning0", "spmm_um_tuning1",
                     "spmv_um_tuning0", "spmv_um_tuning1",
                     "spmm_um_wcoo_tuning0"):
            p = os.path.join(tmp, f"{name}.json")
            with open(p) as fh:
                events = json.load(fh)["traceEvents"]
            names = {e.get("name", "") for e in events}
            want = {f"sblas.profile run={name}",
                    "sblas.um.compute band=0"} | (
                {"sblas.um.copy band=0"} if name.endswith("0") else set())
            k3 = sum("unit_reduce_kernel" in n for n in names)
            if not want <= names or (name.endswith("wcoo_tuning0")
                                     and not k3):
                raise AssertionError(f"trace {name}: missing "
                                     f"{sorted(want - names)} or K3")
            phase("profiling", trace=name, events=len(events),
                  kb=f"{os.path.getsize(p) / 1024:.0f}",
                  band_ranges=sum(n.startswith("sblas.um.") for n in names),
                  k3_kernel_names=k3,
                  gpu_events=sum(e.get("cat") == "kernel" for e in events))


def _device_ms(fn) -> float:
    from sblas_tpu_torch.utils.timing import device_time_ms
    return device_time_ms(fn, reps=20, inner=10)


def _spmv_phase(title, A, plan, kind, counters, none) -> None:
    """One counted SpMV over `plan` (which must be of class `kind`), the
    oracle check and the times; these plain-torch paths launch no
    kernel."""
    from sblas_tpu_torch.containers import DenseVector
    from sblas_tpu_torch.ops import spmv
    from sblas_tpu_torch.ops.cpu_reference import spmv_cpu
    if not isinstance(plan, kind):
        raise AssertionError(f"{title}: plan {type(plan).__name__}, "
                             f"expected {kind.__name__}")
    x = DenseVector.random(A.width, dtype=np.float32)
    y = DenseVector.constant(A.height, 1.0, dtype=np.float32)
    xd = torch.from_numpy(x.values).to(plan.device)
    yd = torch.from_numpy(y.values).to(plan.device)
    out, counts = launches_of(counters,
                              lambda: spmv(plan, xd, ALPHA, BETA, yd))
    expect_launches(title, counts, none)
    phase(title, plan=kind.__name__, shape=A.shape, nnz=A.nnz,
          launches=counts,
          check=checked(title, out, spmv_cpu(A, x, ALPHA, BETA, y)),
          **call_times(lambda: spmv(plan, xd, ALPHA, BETA, yd), A.nnz))


def _cli(main_fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return buf.getvalue(), rc


if __name__ == "__main__":
    try:
        code = main()
    finally:
        # a phase that fails leaves its NCCL group up; close it on the way
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(code)
