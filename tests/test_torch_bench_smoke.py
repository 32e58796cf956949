"""`sblas_tpu_torch.bench` wiring smoke test (mirrors
tests/test_bench_smoke.py).

The real bench runs on the card; a wiring fault in a rarely taken branch
(the plan cache, the weak cell's sidecar, the scorecard) would otherwise
show only there.  The workload generators are shrunk to toy sizes and
`main` runs end to end on the CPU in a temporary directory, cold and then
warm: the JSON line, the scorecard block, and every cache hitting on the
warm pass.  `--device cuda` with no card raises."""

import json

import numpy as np
import pytest
import torch


@pytest.fixture()
def tiny_bench(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # .bench_cache isolation
    import sblas_tpu_torch.bench as bench
    import sblas_tpu_torch.io.generate as gen
    import sblas_tpu_torch.utils.timing as timing
    real_shell, real_web = gen.fem_shell_like, gen.webbase_like

    def small_shell(*a, **kw):
        return real_shell(nx=12, ny=6, dof=6, n_target=12 * 6 * 6,
                          dtype=kw.get("dtype", np.float32))

    def small_web(*a, **kw):
        return real_web(n=4096, avg_deg=3.0, seed=3, local_scale=60.0,
                        dtype=kw.get("dtype", np.float32))

    monkeypatch.setattr(gen, "fem_shell_like", small_shell)
    monkeypatch.setattr(gen, "webbase_like", small_web)
    real_host = timing.host_time_ms

    def fast_host(fn, warmup=1, reps=5):   # cheap timing: 1 run, 2 reps
        return real_host(fn, warmup=1, reps=2)

    monkeypatch.setattr(timing, "host_time_ms", fast_host)
    return bench


def _run(bench, capsys):
    rc = bench.main(["--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 0
    line = json.loads(cap.out.strip().splitlines()[-1])
    return line, cap.err


def test_bench_main_cold_and_warm(tiny_bench, capsys):
    line, err = _run(tiny_bench, capsys)
    assert line["metric"] == "ref_workloads_geomean_speedup"
    assert line["unit"] == "x" and line["value"] > 0
    # a CPU run reports no device number
    assert line["device"] == "cpu" and line["device_value"] is None
    assert {"spmm_shell", "spmv_webbase", "spmm_webbase_wcoo",
            "xfoot_shard4", "xfoot_shard16",
            "spmv_weak_shard4"} <= set(line["repeats"])
    for r in line["repeats"].values():
        assert r["min_ms"] > 0 and r["median_ms"] >= r["min_ms"]
        assert r["spread"] >= 0 and "device_median_ms" not in r
    assert "BASELINE scorecard" in err
    assert "1 card → 16 cards" in err and "v5e" not in err
    assert "spmm shell K=64" in err and "spmv webbase-1M" in err
    assert "strong n=16" in err and ("meets" in err or "MISSES" in err)
    assert "speed-of-light regime" in err
    # the JAX bench's bf16-transport line; the toy webbase's best plan
    # has no route (tests/test_torch_bf16.py times a routed one)
    assert "spmv webbase bf16 transport: best[" in err
    # warm pass: every cache (plans, the weak cell's sidecar) hits
    line2, err2 = _run(tiny_bench, capsys)
    assert line2["metric"] == line["metric"]
    assert set(line2["repeats"]) == set(line["repeats"])
    assert "unusable" not in err2 and "stale" not in err2


def test_bench_reports_a_drifted_cache(tiny_bench, capsys, tmp_path):
    _run(tiny_bench, capsys)
    for f in (tmp_path / ".bench_cache" / "torch").iterdir():
        f.write_bytes(b"not a plan")
    _, err = _run(tiny_bench, capsys)
    assert "unusable" in err


def test_bench_cuda_without_a_card_raises(monkeypatch):
    import sblas_tpu_torch.bench as bench
    from sblas_tpu_torch.utils.errors import KernelError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelError, match="no CUDA device"):
        bench.main(["--device", "cuda"])
