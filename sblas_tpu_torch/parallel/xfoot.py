"""Footprint-compressed x-exchange SpMV (the comm-avoiding distributed
mode).

Port of `sblas_tpu/parallel/xfoot.py`.  x and y are row-block sharded the
same way (the steady state of a solver loop), and each rank receives only
the x entries its shard's columns reference:

* **own block**: rows [s*r, (s+1)*r) read x[s*r:(s+1)*r) locally;
* **hot set**: the exact columns demanded by >= 2 remote shards, ordered
  by owner, so each owner contributes one contiguous segment, placed at a
  plan-time offset in a zeroed buffer and summed over the ranks by ONE
  small `all_reduce`;
* **cold packets**: columns demanded by exactly one remote shard, one
  column list per (owner -> demander) pair, padded to the largest pair
  and moved by one `all_to_all`.

Both the hot segment and the packets come out of one per-rank
**extraction** of `x_blk` into `[hot segment | packets]` order, by one of
two engines priced by `scaling.GATHER_NS` / `ROUTE_NS` (the port's H100
constants): a flat gather (`index_select` of `send_idx`) or a routed
permutation (`ops/route.apply_route`, whose `gather` layers are kernel K1;
q=1 packets plus owner-unique hot columns make the map a bijection).  The
local product then runs the shard's fast plan over the concatenated
`x_ext = [own | hot | packets]` window, whose column ids were remapped at
plan time; a routed shard runs kernel K2' (`planned._local_spmv`).  The
output stays row-sharded: no result collective.

As in `planned.py`, the plans are held per shard (`XFootShards.plans[s]`
equals row s of the JAX package's stacked tables), `rank=` places only
the rank's shard, every function runs on every rank with global operands,
and the result is the rank's rows.  `xfoot_stats` gives the exchange
geometry without building plans.  At bf16 values the hot all-reduce adds
zeros to each column's one owner, so it is exact in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..ops.plans import fold
from ..utils.errors import PartitionError, ShapeError, require
from .mesh import Mesh, all_reduce, all_to_all
from .modes import own_rows, row_block
from .planned import (_local, _local_spmv, _placed, build_stacked_plans,
                      pick_shard_kind)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class XFootStats(NamedTuple):
    """Exchange geometry of one xfoot partition (all plan-time).

    Per-rank byte counts follow the ring-collective convention of the JAX
    package's scaling model; extraction is priced by the chosen engine
    (`extract_ns` = modeled nanoseconds per call, from the port's
    constants)."""

    n_shards: int
    hot_total: int        # exact columns in the hot broadcast buffer
    hot_own_max: int      # max columns one owner contributes (padded)
    packet_pad: int       # P: per-(owner,demander) packet slots (padded)
    packet_max: int       # largest real (owner,demander) column list
    remote_unique: int    # max over shards of unique remote cols needed
    send_real: int        # max over owners of real entries it extracts
    extract_mode: str     # "none" | "flat" | "route"
    extract_ns: float     # modeled per-rank extraction time per call
    hot_qmin: int = 2     # demand threshold defining the hot set

    def comm_bytes(self, itemsize: int) -> float:
        n = self.n_shards
        if n <= 1:
            return 0.0
        hot = 2.0 * self.hot_total * (n - 1) / n * itemsize
        a2a = float((n - 1) * self.packet_pad * itemsize)
        return hot + a2a


def _groupby(values: np.ndarray, keys: np.ndarray):
    """(unique_keys, [values per key]); inputs need not be sorted."""
    if len(values) == 0:
        return [], []
    order = np.argsort(keys, kind="stable")
    v, k = values[order], keys[order]
    uk, first = np.unique(k, return_index=True)
    return uk, np.split(v, first[1:])


def _xfoot_analyze(A: CsrMatrix, n_shards: int, hot_qmin: int = 0):
    """Classify every (shard, referenced column) into own / hot / cold and
    lay out the owner-ordered hot buffer and the packets.

    `hot_qmin` <= 0 means the default threshold 2.  A forced threshold
    above 2 sends q-in-[2, qmin) columns to several demanders' packets:
    the extraction map stops being injective, and only the flat engine
    can express it."""
    from .. import scaling
    from ..ops.route import routable_size
    from ..utils.errors import PlanError
    m, n = A.shape
    require(max(m, n, A.nnz) < 2**31, PlanError,
            "xfoot plans are int32-indexed")
    band_rows = _round_up(-(-m // n_shards) or 1, 128)
    r_x = _round_up(-(-n // n_shards) or 1, 128)

    # per-shard unique referenced columns + remote demand count q(c)
    uniq_cols = []
    q = np.zeros(n, dtype=np.int32)
    for s in range(n_shards):
        r0, r1 = min(s * band_rows, m), min((s + 1) * band_rows, m)
        lo, hi = int(A.row_ptr[r0]), int(A.row_ptr[r1])
        cols_s = np.unique(A.col_idx[lo:hi].astype(np.int32))
        uniq_cols.append(cols_s)
        remote = cols_s[(cols_s // r_x) != s]
        q[remote] += 1

    if hot_qmin < 2:
        hot_qmin = 2
    # hot = exact q >= hot_qmin set, owner-grouped (sorted column order
    # groups owners, since ownership is by contiguous block)
    hot_cols = np.flatnonzero(q >= hot_qmin).astype(np.int32)
    H_tot = len(hot_cols)
    hot_own = np.zeros(n_shards, dtype=np.int64)   # cols owned per shard
    hot_off = np.zeros(n_shards, dtype=np.int64)   # owner segment start
    if H_tot:
        owners = hot_cols // r_x
        hot_own = np.bincount(owners, minlength=n_shards).astype(np.int64)
        hot_off = np.concatenate([[0], np.cumsum(hot_own)[:-1]])

    def hot_lookup(cols):
        """-1 for non-hot, else position in the hot buffer."""
        pos = np.full(len(cols), -1, dtype=np.int32)
        if H_tot:
            j = np.searchsorted(hot_cols, cols).astype(np.int32)
            jc = np.clip(j, 0, H_tot - 1)
            ok = hot_cols[jc] == cols
            pos[ok] = jc[ok]
        return pos

    # cold packets (q == 1): per (demander s, owner t) sorted column lists
    packets = {}
    pack_max = 0
    remote_unique = 0
    for s in range(n_shards):
        cols_s = uniq_cols[s]
        owner = cols_s // r_x
        remote = cols_s[owner != s]
        remote_unique = max(remote_unique, len(remote))
        cold = remote[hot_lookup(remote) < 0]
        for t, grp in zip(*_groupby(cold, cold // r_x)):
            packets[(s, int(t))] = grp
            pack_max = max(pack_max, len(grp))
    P_pad = _round_up(pack_max, 128) if pack_max else 0

    send_real = 0
    for t in range(n_shards):
        tot = int(hot_own[t]) + sum(
            len(packets[(s, t)]) for s in range(n_shards)
            if (s, t) in packets)
        send_real = max(send_real, tot)

    # extraction engine by modeled cost (the port's H100 constants)
    Hmax = _round_up(int(hot_own.max()), 128) if H_tot else 0
    out_slots = Hmax + n_shards * P_pad
    dup = hot_qmin > 2 and bool(((q >= 2) & (q < hot_qmin)).any())
    if out_slots == 0:
        mode, extract_ns, route_space = "none", 0.0, 0
    else:
        route_space = routable_size(max(r_x, out_slots))
        flat_ns = scaling.GATHER_NS * out_slots
        route_ns = scaling.ROUTE_NS * route_space
        mode, extract_ns = (("flat", flat_ns)
                            if dup or flat_ns <= route_ns
                            else ("route", route_ns))

    stats = XFootStats(
        n_shards=n_shards, hot_total=H_tot, hot_own_max=Hmax,
        packet_pad=P_pad, packet_max=pack_max,
        remote_unique=remote_unique, send_real=send_real,
        extract_mode=mode, extract_ns=extract_ns, hot_qmin=hot_qmin)
    return {
        "band_rows": band_rows, "r_x": r_x, "H_tot": H_tot,
        "hot_own": hot_own, "hot_off": hot_off, "hot_cols": hot_cols,
        "Hmax": Hmax, "packets": packets, "P": P_pad,
        "hot_lookup": hot_lookup, "route_space": route_space,
        "dup": dup, "stats": stats,
    }


def xfoot_stats(A: CsrMatrix, n_shards: int, itemsize: int = 4,
                config: SBlasConfig = DEFAULT) -> XFootStats:
    """Exchange geometry only (no plan build, no edge colouring).
    `itemsize` is accepted for API parity (geometry is dtype-free)."""
    del itemsize
    require(n_shards >= 1, PartitionError, f"bad n_shards {n_shards}")
    return _xfoot_analyze(A, n_shards, config.xfoot_hot_qmin)["stats"]


def _remap_local(A: CsrMatrix, s: int, lay: dict) -> CsrMatrix:
    """Shard s's rows as a (band_rows, w_ext) local CSR with columns
    remapped into x_ext = [own | hot | packets] coordinates."""
    m = A.shape[0]
    band_rows, r_x = lay["band_rows"], lay["r_x"]
    H_tot, Pp = lay["H_tot"], lay["P"]
    w_ext = r_x + H_tot + lay["stats"].n_shards * Pp
    r0, r1 = min(s * band_rows, m), min((s + 1) * band_rows, m)
    lo, hi = int(A.row_ptr[r0]), int(A.row_ptr[r1])
    rp = np.concatenate([A.row_ptr[r0:r1 + 1] - lo,
                         np.full(band_rows - (r1 - r0), hi - lo,
                                 dtype=A.row_ptr.dtype)])
    cols = A.col_idx[lo:hi].astype(np.int32)
    owner = cols // r_x
    newc = np.empty_like(cols)
    own = owner == s
    newc[own] = cols[own] - s * r_x
    rem = ~own
    if rem.any():
        rc = cols[rem]
        hpos = lay["hot_lookup"](rc)
        nc = np.empty_like(rc)
        hmask = hpos >= 0
        nc[hmask] = r_x + hpos[hmask]
        cold = ~hmask
        if cold.any():
            cc, co = rc[cold], owner[rem][cold]
            pos = np.empty_like(cc)
            for t in np.unique(co):
                sel = co == t
                pos[sel] = int(t) * Pp + np.searchsorted(
                    lay["packets"][(s, int(t))], cc[sel])
            nc[cold] = r_x + H_tot + pos
        newc[rem] = nc
    return CsrMatrix(rp, newc, A.values[lo:hi], (band_rows, w_ext))


def xfoot_worst_local(A: CsrMatrix, n_shards: int,
                      config: SBlasConfig = DEFAULT):
    """(the remapped local CSR of the heaviest shard (max nnz), the shared
    routed sizes over all shards): `RoutedPlan.from_csr(local,
    min_gtiles=, min_srows=, min_prows=, min_sranks=)` of these is exactly
    what the heaviest rank computes, so one plan measures the mode's
    per-rank compute."""
    from ..ops.rspmv import routed_shard_sizes
    from .planned import shared_routed_sizes
    lay = _xfoot_analyze(A, n_shards, config.xfoot_hot_qmin)
    locals_ = [_remap_local(A, s, lay) for s in range(n_shards)]
    sizes = [routed_shard_sizes(sub, config) for sub in locals_]
    worst = int(np.argmax([sub.nnz for sub in locals_]))
    return locals_[worst], shared_routed_sizes(sizes)


def send_tables(lay: dict, n_shards: int):
    """(src_of, used_of), each (n_shards, out_slots): the local x index
    that fills each extraction slot [hot segment | n packets] of owner t,
    and whether the slot carries a real entry (pad slots read index 0)."""
    Hmax, Pp = lay["Hmax"], lay["P"]
    out_slots = Hmax + n_shards * Pp
    r_x, hot_cols = lay["r_x"], lay["hot_cols"]
    src_of = np.zeros((n_shards, out_slots), dtype=np.int32)
    used_of = np.zeros((n_shards, out_slots), dtype=bool)
    for t in range(n_shards):
        h = int(lay["hot_own"][t])
        if h:
            off = int(lay["hot_off"][t])
            src_of[t, :h] = hot_cols[off:off + h] - t * r_x
            used_of[t, :h] = True
        for s in range(n_shards):
            grp = lay["packets"].get((s, t))
            if grp is None:
                continue
            base = Hmax + s * Pp
            src_of[t, base:base + len(grp)] = grp - t * r_x
            used_of[t, base:base + len(grp)] = True
    return src_of, used_of


@dataclasses.dataclass(frozen=True)
class XFootPlan:
    """One shard's part of an xfoot partition: its local plan over
    x_ext and its extraction tables.

    send_idx: (out_slots,) i32   flat engine: local x index per slot of
                                 [hot segment | packets]; empty otherwise
    xroute_tables                route engine: the layer tables computing
                                 the same layout; () otherwise"""

    plan: object
    send_idx: torch.Tensor
    xroute_tables: Tuple[torch.Tensor, ...]

    def to(self, device) -> "XFootPlan":
        return XFootPlan(self.plan.to(device), self.send_idx.to(device),
                         tuple(t.to(device) for t in self.xroute_tables))


@dataclasses.dataclass(frozen=True)
class XFootShards:
    """Per-shard xfoot plans (None where this rank does not hold one) and
    the exchange geometry shared by every shard.

    hot_put[s]   start of shard s's segment in the hot buffer
    hot_cnt[s]   how many hot columns shard s owns
    (the JAX package's (n, 1) `hot_put` / `hot_cnt` arrays)"""

    plans: Tuple
    hot_put: Tuple[int, ...]
    hot_cnt: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    band_rows: int
    r_x: int
    kind: str
    hot_total: int
    hot_own_max: int
    packet_pad: int
    extract_mode: str
    xroute_schedule: Tuple
    xroute_n: int
    stats: XFootStats

    def local(self, rank: int) -> XFootPlan:
        return _local(self.plans, rank)

    @property
    def out_slots(self) -> int:
        """Length of one rank's extraction: hot segment plus packets."""
        return self.hot_own_max + self.n_shards * self.packet_pad


def partition_xfoot(A: CsrMatrix, n_shards: int, dtype=torch.float32,
                    kind: str = None, extract: str = None,
                    config: SBlasConfig = DEFAULT, *, device,
                    rank: Optional[int] = None) -> XFootShards:
    """Equal row-block shards whose local plans read a remapped
    `x_ext = [own | hot | packets]` window (module docstring).

    `extract` forces the extraction engine ("flat" | "route"); None picks
    by modeled cost (`stats.extract_mode`).  `kind` as in
    `partition_row_plans`.  Every shard is built on the host; `rank`
    places only that shard on `device`, None places every shard there."""
    from ..ops.route import build_route, routable_size, route_tables
    require(n_shards >= 1, PartitionError, f"bad n_shards {n_shards}")
    lay = _xfoot_analyze(A, n_shards, config.xfoot_hot_qmin)
    band_rows, r_x = lay["band_rows"], lay["r_x"]
    H_tot, Hmax, Pp = lay["H_tot"], lay["Hmax"], lay["P"]
    w_ext = r_x + H_tot + n_shards * Pp
    out_slots = Hmax + n_shards * Pp
    mode = extract or lay["stats"].extract_mode
    require(not (mode == "route" and lay["dup"]), PartitionError,
            "route extraction cannot express the duplicated packets a "
            "forced xfoot_hot_qmin > 2 creates (routes are permutations, "
            "no multicast); use extract='flat'")
    if mode != lay["stats"].extract_mode:
        # keep the stats' modeled time consistent with the forced engine
        from .. import scaling
        forced_ns = (scaling.GATHER_NS * out_slots if mode == "flat"
                     else scaling.ROUTE_NS * lay["route_space"])
        lay["stats"] = lay["stats"]._replace(extract_mode=mode,
                                             extract_ns=forced_ns)

    # ---- extraction tables: local x -> [hot segment | packets] ----
    send_idx = [np.zeros(0, dtype=np.int32)] * n_shards
    xtables = [()] * n_shards
    xroute_schedule, xroute_n = (), 0
    if out_slots:
        src_of, used_of = send_tables(lay, n_shards)
        if mode == "flat":
            send_idx = list(src_of)
        else:
            N = routable_size(max(r_x, out_slots))
            progs = []
            for t in range(n_shards):
                perm = np.full(N, -1, dtype=np.int32)
                perm[:out_slots][used_of[t]] = src_of[t][used_of[t]]
                used = np.zeros(N, dtype=bool)
                used[perm[perm >= 0]] = True
                unassigned = perm < 0
                perm[unassigned] = np.flatnonzero(~used).astype(np.int32)
                progs.append(build_route(perm))
            require(len({p.schedule for p in progs}) == 1, PartitionError,
                    "xfoot extraction route schedules diverged despite a "
                    "shared padded size (planner bug)")
            xroute_schedule, xroute_n = progs[0].schedule, progs[0].n
            xtables = [route_tables(p, "cpu") for p in progs]

    # ---- remapped local matrices and their plans ----
    locals_ = [_remap_local(A, s, lay) for s in range(n_shards)]
    if kind is None:
        kind = pick_shard_kind(A, op="spmv", config=config)
    plans, kind = build_stacked_plans(locals_, kind, band_rows, w_ext,
                                      A.nnz, dtype, config)
    parts = [XFootPlan(p, torch.from_numpy(si), xt)
             for p, si, xt in zip(plans, send_idx, xtables)]
    return XFootShards(
        plans=_placed(parts, device, rank),
        hot_put=tuple(int(v) for v in lay["hot_off"]),
        hot_cnt=tuple(int(v) for v in lay["hot_own"]),
        shape=A.shape, nnz=A.nnz, n_shards=n_shards,
        band_rows=band_rows, r_x=r_x, kind=kind,
        hot_total=H_tot, hot_own_max=Hmax, packet_pad=Pp,
        extract_mode=mode, xroute_schedule=xroute_schedule,
        xroute_n=xroute_n, stats=lay["stats"])


def xfoot_extract(shards: XFootShards, part: XFootPlan,
            x_blk: torch.Tensor) -> torch.Tensor:
    """The rank's (out_slots,) extraction of its x block into
    [hot segment | packets] order, by the partition's engine."""
    if shards.extract_mode == "flat":
        return torch.index_select(x_blk, 0, part.send_idx)
    from ..ops.route import apply_route
    rin = F.pad(x_blk, (0, shards.xroute_n - x_blk.shape[0]))
    return apply_route(shards.xroute_schedule, rin,
                       part.xroute_tables)[: shards.out_slots]


def _xfoot_block(shards: XFootShards, x_blk, mesh: Mesh,
                 nocomm: bool) -> torch.Tensor:
    """The rank program (the body of the JAX package's `_xfoot_program`):
    extraction from the rank's (r_x,) block of x, the hot all-reduce, the
    packet all_to_all, then the local SpMV over x_ext.  Returns the rank's
    (band_rows,) product."""
    n, s = mesh.size, mesh.rank
    require(shards.n_shards == n, PartitionError,
            f"shards built for {shards.n_shards} shards, mesh has {n}")
    require(x_blk.shape[0] == shards.r_x, ShapeError,
            f"x block of {x_blk.shape[0]} rows, the shards take {shards.r_x}")
    part = shards.local(s)
    pieces = [x_blk]
    if shards.out_slots:
        packed = xfoot_extract(shards, part, x_blk)
    if shards.hot_total:
        # this rank's owned hot columns at its segment of a zeroed buffer;
        # the sum over the ranks fills every segment
        hot = x_blk.new_zeros(shards.hot_total)
        put, cnt = shards.hot_put[s], shards.hot_cnt[s]
        hot[put:put + cnt] = packed[:cnt]
        # the nocomm twin keeps extraction and local compute and drops
        # only the collectives (the CLIs' comm/compute split)
        pieces.append(hot if nocomm else all_reduce(hot, mesh))
    if shards.packet_pad:
        send = packed[shards.hot_own_max:].reshape(n, shards.packet_pad)
        recv = send if nocomm else all_to_all(send, mesh)
        pieces.append(recv.reshape(-1))
    x_ext = torch.cat(pieces) if len(pieces) > 1 else x_blk
    return _local_spmv(shards.kind, part.plan, x_ext)


def _xfoot_local(shards: XFootShards, x, mesh: Mesh,
                 nocomm: bool) -> torch.Tensor:
    """`_xfoot_block` on the rank's block of the global x."""
    return _xfoot_block(shards, row_block(x, mesh, shards.r_x * mesh.size),
                        mesh, nocomm)


def spmv_xfoot_block(shards: XFootShards, x_blk, mesh: Mesh
                     ) -> torch.Tensor:
    """A@x for the rank's rows, block in and block out: `x_blk` is the
    rank's (r_x,) block of x (zero past the matrix edge), the result its
    (band_rows,) block of rows (zero past the edge).  The steady state of
    a solver loop, which keeps only its blocks; `spmv_xfoot` is this on
    the rank's block of a global x, cut to its rows and with alpha/beta
    folded in."""
    return _xfoot_block(shards, x_blk, mesh, nocomm=False)


def spmv_xfoot(shards: XFootShards, x, alpha, beta, y, mesh: Mesh
               ) -> torch.Tensor:
    """y' = beta*y + alpha*A@x with A row-block partitioned, x and y
    blocked the same way, and only the column footprint exchanged (hot
    all-reduce + packet all_to_all): the rank's rows of y'.  No result
    collective (`sync_to_host(out, mesh, 0)` assembles the whole)."""
    require(x.shape[0] == shards.shape[1], ShapeError,
            f"A width {shards.shape[1]} != x length {x.shape[0]}")
    local = _xfoot_local(shards, x, mesh, nocomm=False)
    y_blk = row_block(y, mesh, shards.band_rows * mesh.size)
    return own_rows(fold(alpha, local, beta, y_blk, local.dtype), mesh,
                    shards.shape[0])


def spmv_xfoot_nocomm(shards: XFootShards, x, mesh: Mesh) -> torch.Tensor:
    """Diagnostic twin of `spmv_xfoot` with the collectives dropped
    (extraction and local compute kept): the exposed exchange cost is the
    full call minus this.  Its values are wrong wherever remote columns
    matter: timing only.  Needs no process group."""
    return own_rows(_xfoot_local(shards, x, mesh, nocomm=True), mesh,
                    shards.shape[0])
