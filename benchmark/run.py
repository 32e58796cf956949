"""Run one cell of the benchmark of sblas_tpu_torch.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for (BENCHMARK.json, `workloads`).  The last line of standard output is
the result (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` `breakdown`, and `checks` last); everything else goes to
standard error, whose last lines are the numbers checked, each beside
its limit.  A cell on several cards starts one process a card itself;
rank 0 prints the result.  Exits non-zero, printing no result, without
enough CUDA cards, or when jax, jaxlib, flax or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program under test is the package at the checkout's root
sys.path.insert(1, ROOT)
# build and kernel caches inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ.setdefault(var, os.path.join(ROOT, ".bench_cache", sub))
os.environ.setdefault("USE_FLAX", "0")


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 for the other ranks of a cell on several cards
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--store-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    import torch

    from harness import core
    bench = core.Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        core.say(f"needs {chips} CUDA card(s); this machine has {cards}")
        return 2
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    # float32 is computed as float32 (the control's TF32 is the step below)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace)]
    procs = []
    ok = False
    try:
        with contextlib.redirect_stdout(sys.stderr):
            res = core.run_cell(
                bench, args.workload, args.seed, args.seconds,
                bool(args.trace), device, args.rank, chips,
                args.store_port, t0=T0,
                on_store=lambda port: procs.extend(
                    core.start_ranks(base, chips, port)))
        ok = True
    finally:
        codes = core.stop_ranks(procs, 120.0 if ok else 30.0)
    if args.rank != 0:
        return 0
    if any(codes):
        core.say(f"a rank failed: exit codes {codes}")
        return 1
    bad = core.forbidden_modules()
    if bad:
        core.say(f"forbidden modules loaded: {bad}")
        return 3
    for name, c in res["checks"].items():
        core.say(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
