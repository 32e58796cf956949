"""The windowed-COO B-row gather question on webbase-1M x K=64.

    python -m sblas_tpu_torch.experiments.wcoo_gather_probe
        [--device cuda|cpu]

Port of `experiments/wcoo_gather_probe.py`: can a gather that reads B
through 128-row windows (each gather tile of 128 entries lies in one
window) replace the flat B-row gather of the WCOO SpMM?  Three parts:

1. host: the reduce-tile fill if WCOO tiles were cut to column slabs (the
   fused gather + reduce form), counted as the JAX probe counts it;
2. host: the column-window layout (tiles of 128 entries, each within one
   window: `window_layout`);
3. device: the window gather itself, kernel P2 (`window_lane_gather`,
   csrc/probe_kernels.cu), checked on every gathered row against B,
   beside the status quo `torch.index_select(B, 0, cols)` in f32 and
   bf16, and the bridge the unfused form would need: a 64-wide row
   permutation of the (nnz, 64) gathered rows, measured as one
   `index_select` (the JAX probe took it as a constant from another
   run).

On CUDA the times are device times; on the CPU host times, labelled so.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import _kernels

K = 64
LANES = 128

USAGE = ("usage: python -m sblas_tpu_torch.experiments.wcoo_gather_probe "
         "[--device cuda|cpu]")


def window_lane_gather_plain(B, wblk, idx) -> torch.Tensor:
    """Plain PyTorch P2 through the TPU kernel's (nb, K, 128) view:
    out[t, k, l] = Bt[wblk[t], k, idx[t, 0, l]], Bt[w, k, l] = B[w*128 + l,
    k]."""
    nb = B.shape[0] // LANES
    Bt = B.reshape(nb, LANES, B.shape[1]).transpose(1, 2)
    tiles = torch.index_select(Bt, 0, wblk)
    return torch.gather(tiles, 2, idx.expand(-1, B.shape[1], -1))


def window_lane_gather(B, wblk, idx) -> torch.Tensor:
    """The B-row window gather (see `window_lane_gather_plain`): B
    (n_pad, K) with n_pad a multiple of 128, wblk (T,) window ids, idx
    (T, 1, 128) lanes; returns (T, K, 128).  CPU tensors take the plain
    version; CUDA tensors launch kernel P2 (csrc/probe_kernels.cu) or
    raise."""
    if B.device.type == "cpu":
        return window_lane_gather_plain(B, wblk, idx)
    from ..utils.errors import KernelError, require
    dev = B.device
    require(dev.type == "cuda", KernelError,
            f"window_lane_gather runs on cpu or cuda, not {dev}")
    fn = _kernels.launcher("window_lane_gather", _kernels.value_suffix(B.dtype))
    require(B.dim() == 2 and B.shape[0] % LANES == 0, KernelError,
            f"B must be (n_pad, K) with n_pad a multiple of {LANES}, got "
            f"{tuple(B.shape)}")
    T, k = wblk.shape[0], B.shape[1]
    _kernels.check_operand(B, "B", B.dtype, B.shape, dev)
    _kernels.check_operand(wblk, "wblk", torch.int32, (T,), dev)
    _kernels.check_operand(idx, "idx", torch.int32, (T, 1, LANES), dev)
    out = torch.empty((T, k, LANES), dtype=B.dtype, device=dev)
    _kernels.launch(fn, dev, B, wblk, idx, out, T, k)
    window_lane_gather.launches += 1
    return out


window_lane_gather.launches = 0   # P2 launches since the last reset


def reduce_fill_lines(W) -> list:
    """Part 1: the WCOO reduce-tile count of the status quo and under
    column slabs of 16k, 64k and 256k columns (the JAX probe's lines)."""
    from ..ops.wcoo import TILE, wcoo_tile_count
    coo = W.to_coo()
    nnz, n = W.nnz, W.shape[1]
    base_tiles = wcoo_tile_count(W)
    lines = [f"reduce fill status quo: {base_tiles} tiles "
             f"({base_tiles * TILE / nnz:.2f})"]
    for slab_cols in (16384, 65536, 262144):
        total = 0
        for c0 in range(0, n, slab_cols):
            sel = (coo.col_idx >= c0) & (coo.col_idx < c0 + slab_cols)
            rows = coo.row_idx[sel]
            if not len(rows):
                continue
            anchors = ((rows >> 7) + 2) * 128
            limit = np.searchsorted(rows, anchors, side="left")
            i = cnt = 0
            while i < len(rows):
                cnt += 1
                i = min(i + TILE, int(limit[i]))
            total += cnt
        lines.append(f"reduce fill @ col-slab {slab_cols}: {total} tiles "
                     f"({total * TILE / nnz:.2f}, {total / base_tiles:.1f}x)")
    return lines


def window_layout(cols: np.ndarray):
    """Part 2, the column-window layout of sorted int32 column ids: (wblk
    (T,) i32 window per tile, lanes (T, 1, 128) i32, slot (nnz,) i64 slot
    t*128 + position of each entry, number of windows).  Each window's
    entries fill its tiles in order; the last tile's tail lanes are 0."""
    nnz = len(cols)
    win = cols >> 7
    lane = (cols & 127).astype(np.int32)
    uniq, counts = np.unique(win, return_counts=True)
    tiles_per_win = -(-counts // LANES)
    T = int(tiles_per_win.sum())
    wblk = np.repeat(uniq, tiles_per_win).astype(np.int32)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tile0 = np.concatenate([[0], np.cumsum(tiles_per_win)[:-1]])
    which = np.repeat(np.arange(len(uniq)), counts)
    slot = (tile0[which] * LANES
            + (np.arange(nnz) - first[which])).astype(np.int64)
    lanes = np.zeros(T * LANES, dtype=np.int32)
    lanes[slot] = lane
    return wblk, lanes.reshape(T, 1, LANES), slot, len(uniq)


def _ms(fn, dev) -> float:
    from ..utils.timing import device_time_ms, host_time_ms
    if dev.type == "cuda":
        return device_time_ms(fn, reps=10, inner=3)
    return host_time_ms(fn)


def main(argv=None) -> int:
    from ..cli.common import cuda_missing, flag_value
    from ..io.generate import webbase_like

    argv = sys.argv[1:] if argv is None else argv
    device = flag_value(argv, "--device", "cuda", usage=USAGE)
    if device not in ("cuda", "cpu"):
        print(USAGE, file=sys.stderr)
        return 2
    if cuda_missing(device):
        return 2
    dev = torch.device(device)
    clock = "device" if dev.type == "cuda" else "cpu host"
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device {name}", file=sys.stderr)

    W = webbase_like(dtype=np.float32)
    nnz, n = W.nnz, W.shape[1]
    n_pad = ((n + LANES - 1) // LANES) * LANES
    for line in reduce_fill_lines(W):
        print(line)

    cols = np.sort(W.col_idx.astype(np.int32))
    wblk, lanes, slot, n_win = window_layout(cols)
    T = len(wblk)
    print(f"gather tiles: {T} (fill {T * LANES / nnz:.2f}) over "
          f"{n_win} windows")

    rng = np.random.default_rng(0)
    B = torch.from_numpy(rng.normal(size=(n_pad, K)).astype(np.float32)
                         ).to(dev)
    wblk_d = torch.from_numpy(wblk).to(dev)
    lanes_d = torch.from_numpy(lanes).to(dev)
    cols_d = torch.from_numpy(cols.astype(np.int64)).to(dev)
    slot_d = torch.from_numpy(slot).to(dev)

    # every gathered row against B's row (the JAX probe checked 4,096)
    out = window_lane_gather(B, wblk_d, lanes_d)
    picked = out.transpose(1, 2).reshape(T * LANES, K)
    if not torch.equal(picked[slot_d], torch.index_select(B, 0, cols_d)):
        print("window lane gather oracle: MISMATCH")
        return 1
    print(f"window lane gather oracle: OK ({nnz} rows)")
    del out, picked

    ms_p = _ms(lambda: window_lane_gather(B, wblk_d, lanes_d), dev)
    ms_x = _ms(lambda: torch.index_select(B, 0, cols_d), dev)
    B16 = B.to(torch.bfloat16)
    ms_x16 = _ms(lambda: torch.index_select(B16, 0, cols_d), dev)
    del B16
    G = torch.index_select(B, 0, cols_d)
    perm = torch.from_numpy(rng.permutation(nnz)).to(dev)
    ms_b = _ms(lambda: torch.index_select(G, 0, perm), dev)
    del G
    print(f"column-window gather (P2): {ms_p:.4f} ms {clock} "
          f"({ms_p * 1e6 / nnz:.3f} ns/row incl. fill)")
    print(f"flat row gather (index_select): {ms_x:.4f} ms {clock} "
          f"({ms_x * 1e6 / nnz:.3f} ns/row)")
    print(f"flat row gather (bf16): {ms_x16:.4f} ms {clock} "
          f"({ms_x16 * 1e6 / nnz:.3f} ns/row)")
    print(f"bridge (64-wide row permutation, index_select): {ms_b:.4f} ms "
          f"{clock} ({ms_b * 1e6 / nnz:.3f} ns/row)")
    print(f"go/no-go: unfused total = P2 {ms_p:.4f} + bridge {ms_b:.4f} ms "
          f"{'< ' if ms_p + ms_b < ms_x else '>='} status quo {ms_x:.4f} "
          f"ms; fused form killed by reduce fill above")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
