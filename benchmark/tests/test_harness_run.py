"""A run of each cell, at a size the CPU holds, gives the contract's
result line; the harness refuses what it must refuse."""

import os
import shutil
import subprocess
import sys
import types

import pytest

import small
from harness import core

SINGLE = ["s3dkq4m2.spmm_k64", "webbase1m.spmm_k64", "webbase1m.pagerank"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _line_ok(res, cell, trace):
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = core.Bench()
    want = (bench.per_layer(cell) if trace else bench.end_to_end(cell))
    names = {m["name"]: m["unit"] for m in want}
    assert set(res["metrics"]) <= set(names)
    for name, m in res["metrics"].items():
        assert m["unit"] == names[name] and m["value"] > 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}


@pytest.mark.parametrize("cell", SINGLE)
@pytest.mark.parametrize("trace", [False, True])
def test_small_run_gives_the_result_line(cell, trace):
    res = small.run(cell, trace=trace)
    _line_ok(res, cell, trace)
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "plan_build_s" in res["metrics"]
    else:
        assert set(res["metrics"]) == {
            m["name"] for m in core.Bench().end_to_end(cell)}


def test_small_mode2_on_four_ranks():
    cell = "webbase1m_4gpu.spmm_mode2_k64"
    res = small.run_ranks(cell)
    _line_ok(res, cell, False)
    assert res["device"]["count"] == 4
    assert set(res["metrics"]) == {"dist_gflops", "setup_s"}


def test_same_seed_same_inputs():
    a = small.run("webbase1m.spmm_k64", seed=2**31 + 11)
    b = small.run("webbase1m.spmm_k64", seed=2**31 + 11)
    assert a["checks"] == b["checks"]


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("sblas_tpu_torch.ops", "jaxfoo", "sblas_tpu_torchx"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "sblas_tpu.ops",
                        types.ModuleType("sblas_tpu.ops"))
    assert core.forbidden_modules() == ["jax", "sblas_tpu"]


def test_harness_and_reference_import_no_jax_nor_the_program():
    code = ("import sys; sys.path[:0] = [{!r}]; "
            "from harness import core, reference, control, trace, work, "
            "stream, readers; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'sblas_tpu', 'sblas_tpu_torch')]; "
            "print(bad); assert not bad").format(small.BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd="/")
    assert out.returncode == 0, out.stderr


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(core.BENCH_DIR, "run.py"),
         "--workload", "s3dkq4m2.spmm_k64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=core.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_cannot_run_the_program(tmp_path):
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['benchmark']; "
            "from harness.program import Program; Program()")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path)
    assert out.returncode != 0
    assert "sblas_tpu_torch" in out.stderr


def test_rank_processes_are_waited_for_and_stopped(monkeypatch, tmp_path):
    script = tmp_path / "rank.py"
    script.write_text("import sys, time\n"
                      "r = int(sys.argv[sys.argv.index('--rank') + 1])\n"
                      "time.sleep(60 if r == 2 else 0)\n"
                      "sys.exit(r)\n")
    monkeypatch.setattr(core, "RUN_PY", str(script))
    procs = core.start_ranks(["--workload", "x"], 3, 12345)
    assert len(procs) == 2
    codes = core.stop_ranks(procs, timeout=3.0)
    assert codes[0] == 1 and codes[1] != 0
    assert all(p.poll() is not None for p in procs)
