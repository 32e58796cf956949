"""Readings that set a cell's limits: the program's on many seeds, and
the control's (the TF32 reference in the program's place) on a few.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--control] [--seconds 3]

Runs the cell once per seed in this one process, on card 0, with a
short window at the cell's own load (set-up, warm-up and the check as in
a benchmark run), and prints one line a seed: `program` or `control`,
the seed, `correct`, and each checked number.  The benchmark's runs do
not run it.  A cell on several cards runs here only with `--control`,
in a world of one: the control distributes nothing, so its readings are
those of the same product on one card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))
os.environ.setdefault("USE_FLAX", "0")


class _OneRank:
    """The control's world of one for a cell on several cards."""

    def __init__(self, bench):
        self.bench = bench

    def __getattr__(self, name):
        return getattr(self.bench, name)

    def config(self, name):
        cfg = self.bench.config(name)
        cfg["shards"] = 1
        return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from harness import core
    from harness.control import ControlProgram
    bench = core.Bench()
    if not torch.cuda.is_available():
        core.say("needs a CUDA card")
        return 2
    if bench.workload(args.workload)["chips"] > 1:
        if not args.control:
            core.say("the program's readings of a cell on several cards "
                     "come from its benchmark runs")
            return 2
        bench = _OneRank(bench)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        prog = ControlProgram() if args.control else None
        res = core.run_cell(bench, args.workload, seed, args.seconds, False,
                            dev, program=prog, t0=t)
        print(json.dumps({
            "side": "control" if args.control else "program",
            "seed": seed, "correct": res["correct"],
            "attempted": res["attempted"], "failed": res["failed"],
            "checks": {k: c["value"] for k, c in res["checks"].items()},
            "seconds": time.perf_counter() - t}), flush=True)
    bad = core.forbidden_modules()
    if bad:
        core.say(f"forbidden modules loaded: {bad}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
