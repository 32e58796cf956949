"""NCCL all-reduce bus bandwidth between the cards of one box.

    torchrun --nproc_per_node=4 -m sblas_tpu_torch.tools.link_bw

Each rank joins the launcher's NCCL group on card LOCAL_RANK and
all-reduces f32 buffers of 16 to 256 MB: for each size, after warm-up,
CUDA events time a run of back-to-back all-reduces on every rank, and
rank 0 prints the median time per call and the bus bandwidth

    busbw = 2 * S * (n - 1) / n / t

(the bytes each rank sends and receives in a ring all-reduce, over the
time), then the median over the sizes and the card's name and power
limit.  `scaling.ICI_BW_DEFAULT` holds the median it measured.  Needs
CUDA and a world of at least two ranks; exits 1 otherwise.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

SIZES_MB = (16, 32, 64, 128, 256)
WARMUP, CALLS, REPS = 5, 10, 7


def busbw(size_bytes: int, n: int, ms: float) -> float:
    """Bytes/s a ring all-reduce of `size_bytes` over `n` ranks moves per
    rank, over `ms` per call."""
    return 2.0 * size_bytes * (n - 1) / n / (ms * 1e-3)


def main() -> int:
    if not torch.cuda.is_available() or "WORLD_SIZE" not in os.environ:
        print("link_bw needs CUDA and a torchrun launch", file=sys.stderr)
        return 1
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="env://", device_id=dev)
    try:
        n, rank = dist.get_world_size(), dist.get_rank()
        if n < 2:
            print("link_bw needs at least two ranks", file=sys.stderr)
            return 1
        rates = []
        for mb in SIZES_MB:
            buf = torch.ones(mb * (1 << 20) // 4, dtype=torch.float32,
                             device=dev)
            for _ in range(WARMUP):
                dist.all_reduce(buf)
            torch.cuda.synchronize(dev)
            ts = []
            for _ in range(REPS):
                dist.barrier()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(CALLS):
                    dist.all_reduce(buf)
                stop.record()
                stop.synchronize()
                ts.append(start.elapsed_time(stop) / CALLS)
            ms = float(np.median(ts))
            rate = busbw(buf.numel() * 4, n, ms)
            rates.append(rate)
            if rank == 0:
                print(f"[link_bw] size_mb={mb} ranks={n} ms={ms:.5f} "
                      f"busbw_GBps={rate / 1e9:.3f}", flush=True)
            del buf
        if rank == 0:
            print(f"[link_bw] median_busbw_Bps={float(np.median(rates)):.6e}"
                  f" sizes_mb={list(SIZES_MB)} ranks={n}")
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip())
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
