"""Exposed all-reduce of mode 2 on webbase-1M x K=64: f32 values against
bf16 values, whose partials stay in f32.

    torchrun --nproc_per_node=4 -m sblas_tpu_torch.tools.mode2_comm

Each rank joins the launcher's NCCL group on card LOCAL_RANK, builds the
nnz segments of `webbase_like()` (1M rows) with f32 and with bf16 values,
and times two steps of one SpMM at K=64 (f32 B and C, or the same rounded
to bf16): `spmm_mode2_nocomm`, the rank's full-height partial, and
`spmm_mode2`, the partial, its all-reduce and the epilogue.  The steps
run in turns, f32 then bf16 then bf16 then f32, each as the median of CUDA
event times after a warm-up (`utils.timing.device_time_ms`).  The exposed
all-reduce is the whole call less the partial, per rank; rank 0 prints
every reading with the slowest rank's, the partial's dtype and bytes, and
the card's name and power limit.  Needs CUDA and a world of at least two
ranks; exits 1 otherwise.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

K = 64
ALPHA, BETA = 3.0, 4.0


def main() -> int:
    if not torch.cuda.is_available() or "WORLD_SIZE" not in os.environ:
        print("mode2_comm needs CUDA and a torchrun launch", file=sys.stderr)
        return 1
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="env://", device_id=dev)
    try:
        return _run(dev)
    finally:
        dist.destroy_process_group()


def _run(dev) -> int:
    from ..containers import DenseMatrix
    from ..io.generate import webbase_like
    from ..parallel import make_mesh, spmm_mode2, spmm_mode2_nocomm
    from ..partition import partition_nnz_balanced
    from ..utils.timing import device_time_ms
    n, rank = dist.get_world_size(), dist.get_rank()
    if n < 2:
        print("mode2_comm needs at least two ranks", file=sys.stderr)
        return 1
    mesh = make_mesh(n, device=dev)
    A = webbase_like(dtype=np.float32)
    B = torch.from_numpy(DenseMatrix.random(A.width, K,
                                            dtype=np.float32).values).to(dev)
    C = torch.ones((A.height, K), dtype=torch.float32, device=dev)
    cases = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        segs = partition_nnz_balanced(A, n, dtype=dtype, device=dev)
        Bd, Cd = B.to(dtype), C.to(dtype)
        partial = spmm_mode2_nocomm(segs, Bd, mesh)
        cases[name] = (partial.dtype, partial.numel() * partial.element_size(),
                       {"nocomm": lambda s=segs, b=Bd: spmm_mode2_nocomm(
                           s, b, mesh),
                        "spmm_mode2": lambda s=segs, b=Bd, c=Cd: spmm_mode2(
                            s, b, ALPHA, BETA, c, mesh)})
    reads = {name: {step: [] for step in cases[name][2]} for name in cases}
    for name in ("f32", "bf16", "bf16", "f32"):
        for step, fn in cases[name][2].items():
            dist.barrier()
            reads[name][step].append(device_time_ms(fn, warmup=5, reps=30))
    mine = torch.tensor([[np.mean(reads[name][step]) for step in
                          ("nocomm", "spmm_mode2")] for name in cases],
                        dtype=torch.float64, device=dev)
    every = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(every, mine)
    if rank == 0:
        slowest = torch.stack(every).amax(dim=0).cpu().numpy()
        for i, name in enumerate(cases):
            p_dtype, p_bytes, _ = cases[name]
            r = reads[name]
            print(f"[mode2_comm] values={name} ranks={n} K={K} nnz={A.nnz} "
                  f"partial={p_dtype} partial_bytes={p_bytes} "
                  f"nocomm_ms={' / '.join(f'{t:.5f}' for t in r['nocomm'])} "
                  f"spmm_mode2_ms="
                  f"{' / '.join(f'{t:.5f}' for t in r['spmm_mode2'])} "
                  f"exposed_allreduce_ms={float(mine[i, 1] - mine[i, 0]):.5f} "
                  f"slowest_rank_nocomm_ms={slowest[i, 0]:.5f} "
                  f"slowest_rank_spmm_mode2_ms={slowest[i, 1]:.5f}",
                  flush=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
