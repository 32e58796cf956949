"""Routed static permutations: arbitrary device-side data movement built
from two primitives, row-local lane shuffles and axis transposes.

Port of `sblas_tpu/ops/route.py`.  The TPU had no fast arbitrary
gather/scatter (XLA lowered elementwise permutes at ~2.3 ns/element on a
v5e), so the JAX package decomposes every static permutation, by the
Birkhoff/Clos routing theorem, into alternating layers of what it did fast:

    perm = lane_shuffle o transpose o lane_shuffle o ... (2*ceil(log128 N)-1
    shuffle layers)

where each lane_shuffle permutes within independent 128-lane rows and the
layer tables come from colouring a 128-regular bipartite multigraph
(native/route.cpp, Euler splitting) at plan time.

The port keeps the layer program exactly: `build_route` and its helpers
are the JAX package's numpy code, carried over so the tables are
byte-identical.  The device executor `apply_route` runs in torch: each
`gather` layer is kernel K1 (`lane_shuffle`, csrc/route_kernels.cu), each
`mix` a `torch.gather` along the block-row axis.  On CUDA a `gather`
directly followed by a `view_transpose` is one K1 launch that stores its
outputs at their transposed places (`lane_shuffle_transposed`); every
`build_route` transpose is such a pair, so no transpose is a copy there.
A transpose the kernel's tile cannot cover, or with no gather before it,
and every transpose on the CPU, stays a reshape/permute/contiguous copy
(`route_steps` pairs them, once per schedule).  Whether routing still
pays on a GPU, which has a fast arbitrary gather, is an open question
the H100 numbers in PERF.md answer first.

Tables are int32, or int16 for the main route under the bf16 transport
(lane indices are below 128 and mix ranks below the layer arity, exact in
int16): K1 reads int16 tables as they are, and the plain paths upcast
them to int32 at use, since `torch.gather` takes no int16 index.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from .. import _kernels
from ..utils import trace

LANES = 128

# Largest per-block row count a "mix" layer handles.  Part of the table
# format, so it must equal the JAX package's value: there it was tuned on
# a TPU v5e, where per-block (nb, A, 128) transposes were free for A >= 16
# but cost 0.17 ms at A=8 and ~3 ms at A=2 (JAX package's measurement).
_MIX_MAX_A = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Edge coloring (native fast path, pure-python fallback for small inputs)
# ---------------------------------------------------------------------------

def _edge_color_py(src, dst, n_left, n_right, d):
    """Euler-splitting edge coloring in python (small inputs only)."""
    ne = len(src)
    colors = np.zeros(ne, dtype=np.int32)
    bits = d.bit_length() - 1

    def halve(edge_ids):
        # incidence lists over combined node space
        inc = {}
        for k, e in enumerate(edge_ids):
            inc.setdefault(int(src[e]), []).append(k)
            inc.setdefault(n_left + int(dst[e]), []).append(k)
        ptr = {v: 0 for v in inc}
        used = np.zeros(len(edge_ids), bool)
        bit = np.zeros(len(edge_ids), np.int8)
        for k0 in range(len(edge_ids)):
            if used[k0]:
                continue
            v = int(src[edge_ids[k0]])
            parity, k = 0, k0
            while True:
                used[k] = True
                bit[k] = parity
                parity ^= 1
                e = edge_ids[k]
                v = (n_left + int(dst[e])) if v == int(src[e]) else int(src[e])
                lst = inc[v]
                p = ptr[v]
                while p < len(lst) and used[lst[p]]:
                    p += 1
                ptr[v] = p
                if p == len(lst):
                    break
                k = lst[p]
        return bit

    groups = [np.arange(ne, dtype=np.int64)]
    for depth in range(bits):
        nxt = []
        for g in groups:
            if len(g) <= 1:
                nxt.append(g)
                continue
            bit = halve(g)
            colors[g[bit == 1]] |= (1 << depth)
            nxt.append(g[bit == 0])
            nxt.append(g[bit == 1])
        groups = nxt
    return colors


def edge_color(src, dst, n_left, n_right, d, n_blocks: int = 1
               ) -> np.ndarray:
    """d-regular bipartite edge coloring; native when available.

    `n_blocks` > 1 declares the graph block-diagonal (contiguous edge
    slices, contiguous node ranges per block) — each block colors as an
    independent cache-resident subproblem (native/route.cpp).

    Gated on `native.available()` so the SBLAS_NO_NATIVE kill switch also
    disables route planning's native path (not just the .mtx parser)."""
    from ..io import native
    if native.available():
        try:
            return native.edge_color(src, dst, n_left, n_right, d,
                                     n_blocks=n_blocks)
        except RuntimeError:
            pass
    if n_blocks <= 1:
        return _edge_color_py(src, dst, n_left, n_right, d)
    npb_l, npb_r = n_left // n_blocks, n_right // n_blocks
    epb = len(src) // n_blocks
    out = np.empty(len(src), dtype=np.int32)
    for b in range(n_blocks):
        sl = slice(b * epb, (b + 1) * epb)
        out[sl] = _edge_color_py(src[sl] - b * npb_l, dst[sl] - b * npb_r,
                                 npb_l, npb_r, d)
    return out


# ---------------------------------------------------------------------------
# Route construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RouteProgram:
    """Layer program.  Ops:

    * ("gather", idx (R,128) i32) — lane shuffle of the (R,128) view;
    * ("view_transpose", shape, axes) — reshape+transpose+flatten;
    * ("mix", rho (R,128) i32, A) — per-lane row perm within blocks of A
      rows: out[b*A+j, c] = in[b*A + rho[b*A+j, c], c].  Used when A is
      small: a transpose there would create a minor dimension of A, which
      XLA relayouts at ~3 ms per pass (measured v5e, A=2) — the select
      chain is A cheap passes instead.

    `n` is the padded element count; inputs shorter than `n` are
    zero-padded and outputs sliced by the caller."""

    ops: Tuple
    n: int

    @property
    def n_gathers(self) -> int:
        return sum(1 for op in self.ops if op[0] == "gather")

    @property
    def schedule(self) -> Tuple:
        """Hashable op structure without the index arrays — suitable as a
        plan meta field.  Pairs with the device tensors from
        `route_tables`."""
        out = []
        for op in self.ops:
            if op[0] == "gather":
                out.append(("gather", op[1].shape[0]))
            elif op[0] == "mix":
                out.append(("mix", op[2]))
            else:
                out.append(op)
        return tuple(out)


def routable_size(n: int) -> int:
    """Smallest N >= n the layer machinery can execute.

    Valid sizes are N = 128^k * r with r in {1..8} u {16, 32, 64, 128}:
    each recursion level divides the block size by 128 and must land on a
    multiple of 128, until either the mix chain takes over (block size
    <= 8 rows) or the base lane shuffle needs the final block size to
    divide 128.  The non-power-of-two radii matter at scale: padding a
    5.5M-slot gather space to 8.39M (next power of two) moves 33% more
    route traffic than 6.29M (= 128^3 * 3)."""
    radii = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32, 64, 128)
    best = None
    base = LANES
    while base < 2**31:
        for r in radii:
            N = base * r
            if N >= n and (best is None or N < best):
                best = N
        if base >= n:  # no larger k can produce a smaller valid N
            break
        base *= LANES
    return best


def build_route(perm: np.ndarray) -> RouteProgram:
    """Layer program computing out[i] = in[perm[i]] for i < len(perm).

    `perm` must be a bijection on [0, len(perm)); it is extended to the
    padded routable size with identity on the pad slots.  Recorded as
    span `sblas.plan.route`, its edge colouring included."""
    with trace.span("sblas.plan.route", n=len(perm)):
        return _build_route(perm)


def _build_route(perm: np.ndarray) -> RouteProgram:
    from ..utils.errors import PlanError, require
    n = len(perm)
    N = routable_size(n)
    require(N < 2**31, PlanError,
            f"route builder is int32-indexed (padded size {N} >= 2^31)")
    # int32 throughout: the JAX package's host measured int32 scatters
    # 14x faster than 64-bit random access
    full = np.empty(N, dtype=np.int32)
    full[:n] = perm
    full[n:] = np.arange(n, N, dtype=np.int32)

    ops: List = []

    def emit_gather(idx2d):
        ops.append(("gather", np.ascontiguousarray(idx2d, dtype=np.int32)))

    def emit_vt(shape, axes):
        ops.append(("view_transpose", tuple(shape), tuple(axes)))

    def rec(p: np.ndarray, bs: int):
        """Emit layers realizing out[i] = cur[p[i]] where p permutes within
        independent blocks of size bs (N/bs blocks).

        Host-side cost note: the statements here run over N-sized int32
        arrays on a single core that pays ~14x for random access, so the
        layout below avoids random scatters wherever an equivalent
        streaming form exists (the `q` construction is a pure per-block
        transpose; the one irreducible permutation scatter, `idx1`, goes
        through the bucketed `native.scatter`).  Integer division is
        scalar (unvectorized) in numpy — every `// A` / `% A` on a full
        N array below is replaced by a shift (LANES is a power of two)
        or by the block-local identity blk(rho[rd, c]) == rd // A (the
        permutation never crosses bs-blocks), which needs only an
        (R, 1)-sized division."""
        if bs <= LANES:
            if bs == 1:
                return
            # base: bs divides 128 (routable_size guarantees a power of
            # two), so blocks never straddle a lane row and the whole
            # level is one row-local lane shuffle
            R = len(p) // LANES
            rows = np.arange(len(p), dtype=np.int32) >> 7
            assert np.array_equal(p >> 7, rows), "non-row-local base"
            emit_gather((p & (LANES - 1)).reshape(R, LANES))
            return

        from ..io import native
        A = bs // LANES           # grid rows per block
        R = len(p) // LANES       # total grid rows

        if native.available():
            # fused native level (native/route.cpp::sblas_route_level):
            # same coloring core, and each table lands in one streaming
            # pass — no arange/dst_row arrays, no scatter temporaries, no
            # numpy transpose copy (~2x on the non-coloring build time at
            # 14.7M, measured).  Tables are byte-identical to the numpy
            # formulation below (deterministic shared coloring), so
            # cached plans reproduce regardless of which path built them.
            try:
                color, idx1, qrho = native.route_level(p, bs, _MIX_MAX_A)
            except RuntimeError:
                color = None
            if color is not None:
                emit_gather(idx1.reshape(R, LANES))
                if A <= _MIX_MAX_A:
                    ops.append(("mix",
                                np.ascontiguousarray(
                                    qrho.reshape(R, LANES)), A))
                    emit_gather(color.reshape(R, LANES))
                    return
                n_blocks = len(p) // bs
                emit_vt((n_blocks, A, LANES), (0, 2, 1))
                rec(qrho, A)
                emit_vt((n_blocks, LANES, A), (0, 2, 1))
                emit_gather(color.reshape(R, LANES))
                return

        src = p
        # edges: one per destination element; rows in the (R, 128) grid
        src_row = src >> 7        # // LANES
        dst_row = np.arange(len(p), dtype=np.int32) >> 7
        # every level below the top permutes within independent bs-blocks:
        # block b owns edges [b*bs, (b+1)*bs) and rows [b*A, (b+1)*A) on
        # both sides, so its whole coloring problem is cache-resident
        color = edge_color(src_row, dst_row, R, R, LANES,
                           n_blocks=len(p) // bs)

        # stage 1: lane shuffle on source rows: out1[r, c] = in[r, ls(r, c)]
        idx1 = np.empty(len(p), dtype=np.int32)
        native.scatter(idx1, src_row * LANES + color, src & (LANES - 1))
        emit_gather(idx1.reshape(R, LANES))

        # middle: per-lane row perm rho: out2[rd, c] = out1[rho(rd, c), c]
        # (dst_row*LANES+color is row-local — within row i//128 at lane
        # color[i] — so this scatter streams; no bucketing needed)
        rho = np.empty(len(p), dtype=np.int32)
        rho[dst_row * LANES + color] = src_row
        rho = rho.reshape(R, LANES)
        n_blocks = len(p) // bs
        # block id of every row in rho's row rd is rd // A (block-local
        # permutation), so the per-element `// A` collapses to (R, 1)
        rd_blk = np.arange(R, dtype=np.int32)[:, None] // A

        if A <= _MIX_MAX_A:
            # small blocks: transpose would make an A-wide minor dim —
            # emit the A-way select chain instead and stop recursing
            rho_local = rho - rd_blk * A  # == rho % A without the division
            ops.append(("mix",
                        np.ascontiguousarray(rho_local, dtype=np.int32), A))
            idx3 = color.reshape(R, LANES)
            emit_gather(idx3)
            return

        # execute on the per-block transposed view: (N/bs, A, 128) ->
        # (N/bs, 128, A): lane c's rows become contiguous runs of length A
        emit_vt((n_blocks, A, LANES), (0, 2, 1))
        # transposed flat index of (block, row a, lane c):
        #   block*bs + c*A + a   (row a within block: global row = block*A+a)
        # destination (rd, c) pulls from (rho[rd, c], c): in transposed flat
        # coords: dst_t = (rd//A)*bs + c*A + (rd % A)
        #         src_t = (rho//A)*bs + c*A + (rho % A)
        # q[dst_t] = src_t is, viewed per block, exactly the (A, 128) ->
        # (128, A) transpose of src_t — no scatter needed; src_t is
        # assembled with in-place ops (each full-N temp here costs real
        # page-fault time at stress scale) and rho//A == rd//A spares the
        # element-wise division
        c = np.arange(LANES, dtype=np.int32)[None, :]
        src_t = np.subtract(rho, rd_blk * A)      # rho % A, streaming
        np.add(src_t, rd_blk * bs, out=src_t)     # + (rho // A) * bs
        np.add(src_t, c * A, out=src_t)
        q = np.ascontiguousarray(
            src_t.reshape(n_blocks, A, LANES).transpose(0, 2, 1)
        ).reshape(-1)
        # per-lane row perms stay within (block, lane) runs of length A ==
        # new block size
        rec(q, A)
        emit_vt((n_blocks, LANES, A), (0, 2, 1))

        # stage 3: lane shuffle on destination rows:
        # out3[rd, ld] = out2[rd, color(rd, ld)]
        idx3 = color.reshape(R, LANES)
        emit_gather(idx3)

    if N <= LANES:
        # single (1, 128)-row array after padding to 128 lanes
        Np = LANES
        p128 = np.arange(Np, dtype=np.int64)
        p128[:N] = full
        emit_gather(p128.reshape(1, LANES))
        return RouteProgram(tuple(ops), N)

    rec(full, N)
    return RouteProgram(tuple(ops), N)


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------

def apply_route_np(prog: RouteProgram, x: np.ndarray) -> np.ndarray:
    """Numpy mirror of the device executor (reference for tests)."""
    n_in = len(x)
    cur = np.zeros(max(prog.n, LANES), dtype=x.dtype)
    cur[:n_in] = x
    for op in prog.ops:
        if op[0] == "gather":
            idx = op[1]
            cur = np.take_along_axis(cur.reshape(idx.shape), idx,
                                     axis=1).ravel()
        elif op[0] == "mix":
            _, rho, A = op
            nb = len(cur) // (A * LANES)
            x3 = cur.reshape(nb, A, LANES)
            cur = np.take_along_axis(x3, rho.reshape(nb, A, LANES),
                                     axis=1).ravel()
        else:
            _, shape, axes = op
            cur = cur.reshape(shape).transpose(axes).ravel()
    return cur[:n_in]

# ---------------------------------------------------------------------------
# Device executor (torch) and kernel K1
# ---------------------------------------------------------------------------

def _index(t: torch.Tensor) -> torch.Tensor:
    """A table as `torch.gather` takes it: int16 upcast to int32."""
    return t.to(torch.int32) if t.dtype == torch.int16 else t


def lane_shuffle_plain(x2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: out[r, j] = x2d[r, idx[r, j]]."""
    return torch.gather(x2d, 1, _index(idx))


def lane_shuffle_transposed_plain(x2d: torch.Tensor, idx: torch.Tensor,
                                  shape: Tuple) -> torch.Tensor:
    """Plain PyTorch K1 with the transposed store: the shuffle viewed as
    `shape` (nb, P, Q), transposed to (nb, Q, P)."""
    return lane_shuffle_plain(x2d, idx).reshape(shape).permute(
        0, 2, 1).contiguous()


def _k1_operands(kernel: str, x2d: torch.Tensor, idx: torch.Tensor):
    """K1's launcher for `x2d` and `idx` and the two operands as it
    reads them, or raise: (R, 128) contiguous CUDA tensors, idx int32,
    or int16 with bf16 values.  K1 reads x2d and idx as 16-byte vectors
    (8 at 16-bit values): one not on 16 bytes (no port path gives one)
    is first copied to fresh storage."""
    from ..utils.errors import KernelError, require
    require(x2d.device.type == "cuda", KernelError,
            f"{kernel} launches K1 on cuda, not on {x2d.device}")
    require(idx.dtype in (torch.int32, torch.int16), KernelError,
            f"idx has dtype {idx.dtype}, expected int32 or int16")
    fn = _kernels.launcher(kernel, _kernels.value_suffix(x2d.dtype)
                           + ("_i16" if idx.dtype == torch.int16 else ""))
    require(x2d.dim() == 2 and x2d.shape[1] == LANES, KernelError,
            f"{kernel} takes an (R, {LANES}) view, got {tuple(x2d.shape)}")
    _kernels.check_operand(x2d, "x2d", x2d.dtype, x2d.shape, x2d.device)
    _kernels.check_operand(idx, "idx", idx.dtype, x2d.shape, x2d.device)
    if x2d.data_ptr() % 16:
        x2d = x2d.clone()
    if idx.data_ptr() % 16:
        idx = idx.clone()
    return fn, x2d, idx


def lane_shuffle(x2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, j] = x2d[r, idx[r, j]] over (R, 128) tensors, idx in
    [0, 128): int32, or int16 with bf16 values.  CPU tensors take the
    plain version; CUDA tensors launch kernel K1 (csrc/route_kernels.cu)
    or raise (`_k1_operands`)."""
    if x2d.device.type == "cpu":
        return lane_shuffle_plain(x2d, idx)
    fn, x2d, idx = _k1_operands("lane_shuffle", x2d, idx)
    out = torch.empty_like(x2d)
    _kernels.launch(fn, x2d.device, x2d, idx, out, x2d.numel())
    lane_shuffle.launches += 1
    return out


lane_shuffle.launches = 0   # K1 row-body launches since the last reset


def transposable(shape: Tuple, axes: Tuple) -> bool:
    """Whether K1's transposed store covers a `view_transpose` of
    `shape` and `axes`, for every value type: (nb, P, Q) -> (nb, Q, P),
    Q a multiple of 128 or one of 16, 32, 64, P a multiple of 16.  The
    one gate of the transposed store: `route_steps` pairs and
    `lane_shuffle_transposed` launches only what it admits, and the
    launcher (csrc/route_kernels.cu's `tile_shape`) derives its tile
    from such a shape, refusing others only as a guard.  Every transpose
    that `build_route` emits is one: its sides are 128 and a block's row
    count A > `_MIX_MAX_A`, which is 16, 32, 64 or a multiple of 128."""
    if len(shape) != 3 or tuple(axes) != (0, 2, 1):
        return False
    _, P, Q = shape
    return P > 0 and P % 16 == 0 and (Q % LANES == 0 or Q in (16, 32, 64))


def lane_shuffle_transposed(x2d: torch.Tensor, idx: torch.Tensor,
                            shape: Tuple) -> torch.Tensor:
    """`lane_shuffle(x2d, idx)` viewed as `shape` (nb, P, Q) and
    transposed to a contiguous (nb, Q, P), in one K1 launch on CUDA: the
    gather layer and the route's next op, a `view_transpose` that
    `transposable` admits, with no copy between.  CUDA tensors only
    (routes on the CPU keep the copy, `route_steps`); the operands are
    `lane_shuffle`'s, and `lane_shuffle_transposed_plain` is the plain
    version."""
    from ..utils.errors import ShapeError, require
    fn, x2d, idx = _k1_operands("lane_shuffle_transposed", x2d, idx)
    nb, P, Q = shape
    require(transposable(shape, (0, 2, 1)) and nb * P * Q == x2d.numel(),
            ShapeError, f"lane_shuffle_transposed cannot store {x2d.numel()} "
            f"elements as the transpose of {tuple(shape)}")
    out = torch.empty((nb, Q, P), dtype=x2d.dtype, device=x2d.device)
    _kernels.launch(fn, x2d.device, x2d, idx, out, x2d.numel(), P, Q)
    lane_shuffle_transposed.launches += 1
    return out


lane_shuffle_transposed.launches = 0   # transposed-store launches


# K1's variants: launcher suffix -> (value dtype, index dtype)
LANE_SHUFFLE_VARIANTS = {
    "f32": (torch.float32, torch.int32), "f64": (torch.float64, torch.int32),
    "bf16": (torch.bfloat16, torch.int32),
    "bf16_i16": (torch.bfloat16, torch.int16)}


def route_tables(prog: RouteProgram, device, index_dtype=np.int32
                 ) -> Tuple[torch.Tensor, ...]:
    """Index tables (`index_dtype`: int32, or int16 for a route that moves
    bf16) on `device`, in schedule order (pass to `apply_route` with
    `prog.schedule`)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(op[1], index_dtype)
                                  ).to(device)
                 for op in prog.ops if op[0] in ("gather", "mix"))


@functools.lru_cache(maxsize=256)
def route_steps(schedule: Tuple, fuse: bool) -> Tuple:
    """The steps `execute_steps` runs for `schedule`, each with the index
    of its table: ("gather", ti), ("mix", ti, A), the schedule's own
    ("view_transpose", shape, axes) (a copy), and, with `fuse`,
    ("gather_t", ti, shape) for a gather directly followed by a
    transpose that `transposable` admits (one K1 launch with the
    transposed store).  A property of the schedule alone, computed once
    a schedule."""
    steps = []
    ti = i = 0
    while i < len(schedule):
        op = schedule[i]
        nxt = schedule[i + 1] if i + 1 < len(schedule) else None
        if op[0] == "gather":
            if (fuse and nxt is not None and nxt[0] == "view_transpose"
                    and transposable(nxt[1], nxt[2])):
                steps.append(("gather_t", ti, nxt[1]))
                i += 1
            else:
                steps.append(("gather", ti))
            ti += 1
        elif op[0] == "mix":
            steps.append(("mix", ti, op[1]))
            ti += 1
        else:
            steps.append(op)
        i += 1
    return tuple(steps)


def execute_steps(steps: Tuple, x: torch.Tensor, tables) -> torch.Tensor:
    """Run `route_steps` on `x` (padded to the program's element count)
    with the program's tables; counts each transpose as
    `route_transposes_fused` (inside K1) or `route_transpose_copies`."""
    n = x.shape[0]
    cur = x
    for op in steps:
        kind = op[0]
        if kind == "gather":
            idx = tables[op[1]]
            cur = lane_shuffle(cur.reshape(idx.shape), idx).reshape(-1)
        elif kind == "gather_t":
            idx = tables[op[1]]
            cur = lane_shuffle_transposed(cur.reshape(idx.shape), idx,
                                          op[2]).reshape(-1)
            trace.count("route_transposes_fused")
        elif kind == "mix":
            # out[b*A+j, c] = in[b*A + rho[b*A+j, c], c]: a gather along the
            # block-row axis (the JAX package's A-way select chain computes
            # the same selection)
            _, ti, A = op
            nb = n // (A * LANES)
            cur = torch.gather(cur.reshape(nb, A, LANES), 1,
                               _index(tables[ti]).reshape(nb, A, LANES)
                               ).reshape(-1)
        else:
            _, shape, axes = op
            cur = cur.reshape(shape).permute(axes).contiguous().reshape(-1)
            trace.count("route_transpose_copies")
    return cur


def apply_route(prog_or_schedule, x: torch.Tensor, tables) -> torch.Tensor:
    """Execute the layer program.  `x` must already be padded to the
    program's element count; returns the permuted tensor.  On CUDA each
    gather + transpose pair is one K1 launch (`route_steps`); elsewhere
    every transpose is a copy."""
    sched = (prog_or_schedule.schedule
             if isinstance(prog_or_schedule, RouteProgram)
             else prog_or_schedule)
    return execute_steps(route_steps(sched, x.device.type == "cuda"), x,
                         tables)
