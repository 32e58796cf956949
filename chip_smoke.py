"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `sblas_tpu_torch/csrc/`, holds
each against its plain PyTorch version at the shapes its main path gives
it (K1/K2 bitwise, K3/K4 within a stated tolerance, each deterministic),
then runs every main path at full size, counting kernel launches on each:

    webbase_like() (1M rows, f32) -> make_plan(op="spmv") -> RoutedPlan
        -> spmv (K1, K2), and the tier-0 COO SpMV beside it
    webbase_like() x K=64 -> make_plan(op="spmm") -> WcooPlan -> spmm (K3)
    fem_shell_like() x K=64 -> make_plan(op="spmm") -> DiaPlan -> spmm,
        and the tier-0 COO SpMM beside it
    fem_banded_like() x K=256 -> BsrPlan -> spmm (K4); x K=64 -> spmm
        (batched matmuls, no K4)
    SpMV over DiaPlan (shell) and BsrPlan (band-73), after each SpMM

each checked against the numpy oracle, and the single-device SpMV and
SpMM CLIs on a 200k-row `.mtx`.  Each phase prints one line; any failure
raises and the script exits non-zero.  The line before the last is the
card's name and power limit, the one before that the kernels' JSON
record; the last line is the device JSON.  Without a CUDA device it exits
1 and prints no result.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
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
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and the
# float32 CUDA-core rate; `bound_ms` is the larger of the two times.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# K3/K4 sum in another order than their plain versions (index_add_,
# einsum): max |kernel - plain| / max(1, max |plain|) must stay below this
F32_REL_TOL = 1e-5
ORACLE_COLS = 64   # spmm_cpu column chunk: bounds its (nnz, cols) transient


def phase(title: str, /, **fields) -> None:
    body = ", ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{title}] {body}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: int, flops: int) -> dict:
    """Least time the card could take: bytes over the HBM rate or
    operations over the f32 peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, kernel_fn, plain_fn, counter, rel_tol=0.0):
    """Kernel vs plain version on the same inputs: two kernel launches
    must agree bitwise (deterministic); the kernel must equal the plain
    version (rel_tol 0) or stay within rel_tol of it, normwise.  Returns
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
    ok = torch.equal(got, want) if rel_tol == 0.0 else rel <= rel_tol
    if not ok:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max_abs_err={err}, rel={rel})")
    ms = device_time_ms(kernel_fn, reps=20, inner=10)
    plain_ms = device_time_ms(plain_fn, reps=20, inner=10)
    counter.launches = 0
    return err, rel, ms, plain_ms


def call_times(fn, nnz: int, k: int = 1) -> dict:
    """Wall ms per synchronous call, device ms, the device's idle share,
    nnz/s and GFLOP/s over the wall time (medians of 30 runs after 5
    warm-ups)."""
    from sblas_tpu_torch.utils.timing import (device_time_ms, gflops,
                                              nnz_per_s, spmm_flops,
                                              wall_time_ms)
    wall = wall_time_ms(fn, warmup=5, reps=30)
    busy = device_time_ms(fn, warmup=5, reps=30)
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
    result and the counts just after."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counters.items()}


def expect_launches(title, counts, expect):
    if counts != expect:
        raise AssertionError(f"{title}: kernel launches {counts}, expected "
                             f"{expect}")


def sparse_csr(A, dev):
    """A as a torch sparse CSR tensor on `dev` (f32), for the library
    yardstick calls only."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.row_ptr), torch.from_numpy(A.col_idx),
        torch.from_numpy(A.values.astype(np.float32)), size=A.shape,
        device=dev, check_invariants=False)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
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
    from sblas_tpu_torch.ops.route import (LANES, lane_shuffle,
                                           lane_shuffle_plain)
    from sblas_tpu_torch.ops.rspmv import (SLAB, RoutedPlan, slab_gather,
                                           slab_gather_plain)
    from sblas_tpu_torch.ops.wcoo import (k_chunk_width, window_reduce,
                                          window_reduce_plain)

    counters = {"lane_shuffle": lane_shuffle, "slab_gather": slab_gather,
                "window_reduce": window_reduce, "bell_spmm": bell_spmm}
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
    del x_slabs

    # ---- SpMV main path: one counted SpMV, oracle check, then timing ----
    x = DenseVector.random(A.width, dtype=np.float32)
    y = DenseVector.constant(A.height, 1.0, dtype=np.float32)
    xd = torch.from_numpy(x.values).to(dev)
    yd = torch.from_numpy(y.values).to(dev)
    want = spmv_cpu(A, x, ALPHA, BETA, y)
    out, counts = launches_of(counters,
                              lambda: spmv(plan, xd, ALPHA, BETA, yd))
    expect_launches("routed SpMV", counts, dict(
        none, lane_shuffle=plan.n_route_gathers, slab_gather=1))
    for name in ("lane_shuffle", "slab_gather"):
        kernels[name]["launches"] = counts[name]
    phase("main path", plan="RoutedPlan", launches=counts,
          check=checked("routed SpMV", out, want),
          **call_times(lambda: spmv(plan, xd, ALPHA, BETA, yd), A.nnz))

    # ---- tier 0: COO SpMV on the same matrix ----
    coo = make_plan(A, dtype=torch.float32, force="coo", device=dev)
    phase("tier0 coo", check=checked(
        "COO SpMV", spmv(coo, xd, ALPHA, BETA, yd), want),
          **call_times(lambda: spmv(coo, xd, ALPHA, BETA, yd), A.nnz))
    del plan, coo, xd, yd, out

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
    k3_args = (wplan.tstart, wplan.wb, wplan.relrow, wplan.vals, wplan.xblk,
               wplan.lane, Bd, 0, kc)
    err, rel, ms, plain_ms = compare(
        "window_reduce", lambda: window_reduce(*k3_args),
        lambda: window_reduce_plain(*k3_args), window_reduce, F32_REL_TOL)
    A_csr = sparse_csr(A, dev)
    lib_ms = _device_ms(lambda: torch.sparse.mm(A_csr, Bd[:, :kc]))
    phase("K3 window_reduce", n_tiles=wplan.n_tiles, kc=kc,
          nb=wplan.n_row_blocks, max_abs_err=f"{err:.3e}",
          rel_err=f"{rel:.3e}", tol=F32_REL_TOL, deterministic=True,
          ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=f"{lib_ms:.5f}")
    kernels["window_reduce"] = dict(
        name="window_reduce", route="cuda",
        source="sblas_tpu_torch/csrc/wcoo_kernels.cu",
        replaces="sblas_tpu/ops/wcoo.py:291", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms,
        **bound(nbytes(*k3_args[:6]) + Bd.shape[0] * kc * 4
                + wplan.n_row_blocks * 128 * kc * 4, 2 * A.nnz * kc))
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
    del wplan, Bd, Cd, out, want, A

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
    out, counts = launches_of(counters,
                              lambda: spmm(splan, Bd, ALPHA, BETA, Cd))
    expect_launches("DIA SpMM", counts, none)
    phase("spmm headline", plan="DiaPlan", shape=S.shape, nnz=S.nnz, K=K,
          n_diags=len(splan.offsets), launches=counts,
          check=checked("DIA SpMM", out, want),
          **call_times(lambda: spmm(splan, Bd, ALPHA, BETA, Cd), S.nnz, K))
    coo = make_plan(S, dtype=torch.float32, force="coo", device=dev)
    phase("tier0 coo spmm", check=checked(
        "COO SpMM", spmm(coo, Bd, ALPHA, BETA, Cd), want),
          **call_times(lambda: spmm(coo, Bd, ALPHA, BETA, Cd), S.nnz, K))
    del coo, Bd, Cd, out, want

    # ---- SpMV over the DIA plan (shell) ----
    sv = make_plan(S, dtype=torch.float32, op="spmv", device=dev)
    _spmv_phase("dia spmv", S, sv, DiaPlan, counters, none)
    del splan, sv, S

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
    phase("K4 bell_spmm", n_brows=bplan.vals.shape[0], slots=bplan.slots,
          n_blocks=n_blocks, K=K4, max_abs_err=f"{err:.3e}",
          rel_err=f"{rel:.3e}", tol=F32_REL_TOL, deterministic=True,
          ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=f"{lib_ms:.5f}")
    kernels["bell_spmm"] = dict(
        name="bell_spmm", route="cuda",
        source="sblas_tpu_torch/csrc/bsr_kernels.cu",
        replaces="sblas_tpu/ops/bsr_pallas.py:37", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms,
        **bound(nbytes(bplan.vals, bplan.bcol, Bd, Cd, Cd),
                2 * n_blocks * 128 * 128 * K4))
    del F_csr
    want = oracle_spmm(F, Bb, Cb)
    out, counts = launches_of(counters,
                              lambda: spmm(bplan, Bd, ALPHA, BETA, Cd))
    expect_launches("BELL SpMM K=256", counts, dict(none, bell_spmm=1))
    kernels["bell_spmm"]["launches"] = counts["bell_spmm"]
    phase("bell spmm", plan="BsrPlan", K=K4, launches=counts,
          check=checked("BELL SpMM K=256", out, want),
          **call_times(lambda: spmm(bplan, Bd, ALPHA, BETA, Cd), F.nnz, K4))
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

    # ---- CLIs on the card: SpMV single mode, SpMM method 1 ----
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
        text, rc = _cli(spmm_test.main, ["1", path, str(K), str(ALPHA),
                                         str(BETA), "1", "f32", "--device",
                                         "cuda"])
    if rc != 0 or "Validation = True" not in text:
        raise AssertionError(f"spmm_test method 1 failed (rc={rc}):\n{text}")
    lines = text.splitlines()
    phase("cli spmm", rc=rc, nnz=W.nnz, K=K, validation=True,
          plan=next(ln for ln in lines if "plan" in ln).split()[-1],
          run=next(ln for ln in lines if "run time" in ln).strip(),
          gflops=next(ln for ln in lines if "GFLOPS" in ln).split()[-1])

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in kernels.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    sys.exit(main())
