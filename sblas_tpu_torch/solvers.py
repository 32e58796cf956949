"""Iterative solvers composed from the plan layer.

Port of `sblas_tpu/solvers.py`: `cg`, `bicgstab`, `pagerank`,
`jacobi_inv_diag` and `SolveResult`, with the same math, the same stopping
rules and the same `converged` semantics.  The reference ships kernels
only; production SpMV lives inside solver loops like these, a new operand
every iteration, which is what the build-once, run-many plans are for.

**The loop.**  The JAX package runs a whole solve as one `lax.while_loop`
dispatch.  Here the loop runs in chunks of `chunk` iterations (default
16).  Each iteration computes its `active` flag on the device (it <
maxiter and the residual above the tolerance; for BiCGSTAB also no
breakdown yet) and updates its state with `torch.where`, so iterations
after convergence change nothing; the host reads one flag per chunk.  The
result and the iteration count equal the while_loop's exactly, at the
cost of at most `chunk - 1` masked iterations after the last real one.

**The CUDA graph.**  For a single-device plan (or a callable) on CUDA the
chunk is captured once into a `torch.cuda.CUDAGraph` and replayed: one
host call per chunk instead of a few dozen launches per iteration.
Captures are cached like the JAX package's jitted programs: one per
(solver, plan, shapes, dtype, tol, maxiter, chunk, preconditioner), and a
later solve copies its operands into the capture's static buffers.  The
cache holds no plan: a capture lives as long as the plan (and the
preconditioner callable) it reads, at most `MAX_PROGRAMS` of them, least
recently used first out; a raw `CsrMatrix`, planned inside the call, is
captured for that solve only.  `graph=False` runs the same chunk
eagerly; the CPU always does.  A failed capture raises; there is no eager
fallback.

**Forms of A** (`_matvec_of`): a raw `CsrMatrix` (planned with
`make_plan(op="spmv")` on the operand's device), a single-device plan, a
callable v -> A@v, or distributed shards with `mesh=`:

* `RowPlanShards`: `spmv_dist_planned` (psum) returns the whole product on
  every rank, so vectors stay whole and dot products are local.
* `XFootShards`: each rank keeps only its block of rows of every vector
  (`spmv_xfoot_block`), and the scalars (dot products, the L1 delta, the
  dangling mass) are all-reduced over the mesh: the JAX package's
  `pagerank_dist` steady state.  `x` comes back as the rank's rows.

Shards run their chunks eagerly (no NCCL inside a captured graph);
`graph=True` with shards raises.  No reference analog (S-BLAS has no
solver layer); the API follows scipy.sparse.linalg loosely.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .utils import trace
from .utils.errors import KernelError, PartitionError, require

# Captured solver chunks, keyed by (solver, matvec form, shapes, dtype,
# device, tol, maxiter, chunk, ...), least recently used first.  An entry
# holds its graph and static buffers but not the objects its kernels read
# (the plan, a preconditioner callable): a finalizer on each of those
# drops the entries naming its id when it is collected, before the id can
# be reused.
MAX_PROGRAMS = 8
_PROGRAMS: "OrderedDict[tuple, _Program]" = OrderedDict()
_WATCHED: dict = {}          # id(owner) -> its weakref.finalize
_RECORD: Optional[list] = None   # see `recording`


class SolveResult(NamedTuple):
    """Outcome of an iterative solve (host scalars, device solution)."""

    x: torch.Tensor
    iterations: int
    residual: float      # cg, bicgstab: ||r||/||b||; pagerank: L1 delta
    converged: bool


@dataclasses.dataclass(frozen=True)
class _Form:
    """How a solver applies A and reduces over its vectors.

    mv: solver vector -> A @ it; vec: a global tensor -> a solver vector
    (identity, or the rank's rows); dot / total: a dot product / a
    scalar summed over the mesh; local: one device, so capturable.  A
    shard form is never captured, so it has no key."""

    mv: Callable
    key: Optional[tuple]     # None: not cached (planned inside the call)
    owner: object            # what a cached capture reads
    device: Optional[torch.device]
    local: bool
    vec: Callable = lambda v: v
    dot: Callable = torch.dot
    total: Callable = lambda s: s


def _matvec_of(A, mesh=None, dtype=None, device=None) -> _Form:
    """Normalise `A` (module docstring, "Forms of A") into a `_Form`."""
    if callable(A) and not hasattr(A, "plan") and not hasattr(A, "shape"):
        return _Form(mv=A, key=("user", id(A)), owner=A, device=None,
                     local=True)
    from .containers import CsrMatrix
    from .ops import make_plan, spmv
    from .parallel.planned import RowPlanShards, spmv_dist_planned
    from .parallel.xfoot import XFootShards
    planned_here = isinstance(A, CsrMatrix)
    if planned_here:
        require(device is not None, KernelError,
                "a raw CsrMatrix is planned on the operand's device: pass "
                "a tensor operand (or r0) on that device")
        A = make_plan(A, dtype=dtype or torch.float32, op="spmv",
                      device=device)
    if isinstance(A, (RowPlanShards, XFootShards)):
        require(mesh is not None, PartitionError,
                "distributed shards need mesh=")
    if isinstance(A, RowPlanShards):
        m = A.shape[0]

        def mv(v):
            return spmv_dist_planned(A, v, 1.0, 0.0, v.new_zeros(m), mesh)
        return _Form(mv=mv, key=None, owner=None, device=mesh.device,
                     local=False)
    if isinstance(A, XFootShards):
        return _xfoot_form(A, mesh)
    plan = A

    def mv(v):
        return spmv(plan, v, 1.0, 0.0, v.new_zeros(plan.shape[0]))
    return _Form(mv=mv, key=None if planned_here else ("plan", id(plan)),
                 owner=plan, device=plan.device, local=True)


def _xfoot_form(shards, mesh) -> _Form:
    """The rank's rows of every vector; scalars all-reduced (see the
    module docstring)."""
    from .parallel.mesh import all_reduce
    from .parallel.xfoot import spmv_xfoot_block
    m, n = shards.shape
    require(m == n, PartitionError,
            "xfoot solvers keep x and A@x in one row blocking: A must be "
            "square")
    lo = mesh.rank * shards.band_rows
    hi = min(lo + shards.band_rows, m)
    width = max(hi - lo, 0)

    def mv(v):
        x_blk = F.pad(v, (0, shards.r_x - width))
        return spmv_xfoot_block(shards, x_blk, mesh)[:width]

    def vec(v):
        return v[lo:hi] if width else v[:0]

    def total(s):
        return all_reduce(s, mesh)

    return _Form(mv=mv, key=None, owner=None, device=mesh.device,
                 local=False,
                 vec=vec, dot=lambda a, b: total(torch.dot(a, b)),
                 total=total)


def _masked(step, cond, st: dict, c: dict) -> dict:
    """One iteration, applied only where `cond` holds."""
    active = cond(st, c)
    new = step(st, c)
    return {k: torch.where(active, new[k], st[k]) for k in st}


def _run_chunk(step, cond, chunk: int, st: dict, c: dict) -> dict:
    for _ in range(chunk):
        st = _masked(step, cond, st, c)
    return st


class _Program:
    """A solver chunk captured into a CUDA graph, with the static state
    and constants it reads and writes and the flag `cond` leaves.
    `owners`: the ids of the objects its kernels read (see `_PROGRAMS`).
    It holds no step function, so no plan."""

    def __init__(self, owners=frozenset()):
        self.owners = owners
        self.graph = None
        self.state = self.consts = self.flag = None

    def _capture(self, step, cond, chunk: int, st: dict, c: dict) -> None:
        self.state = {k: v.clone() for k, v in st.items()}
        self.consts = {k: v.clone() for k, v in c.items()}
        dev = next(iter(st.values())).device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # one eager step first: lazy set-up (library handles, kernel
            # loads, allocator blocks) must not happen inside the capture
            _masked(step, cond, self.state, self.consts)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _run_chunk(step, cond, chunk, self.state, self.consts)
            for k, v in out.items():
                self.state[k].copy_(v)
            self.flag = cond(self.state, self.consts)
        self.graph = graph

    def run(self, step, cond, chunk: int, st: dict, c: dict) -> dict:
        """Replay the chunk (captured on first use) from `st` until its
        flag drops."""
        if self.graph is None:
            with trace.span("sblas.solve.capture"):
                self._capture(step, cond, chunk, st, c)
            trace.count("graph_captures")
        with trace.span("sblas.solve.copy_in"):
            for k, v in st.items():
                self.state[k].copy_(v)
            for k, v in c.items():
                self.consts[k].copy_(v)
        while True:
            with trace.span("sblas.solve.replay"):
                self.graph.replay()
            if not _flag(self.flag):
                with trace.span("sblas.solve.copy_out"):
                    return {k: v.clone() for k, v in self.state.items()}


def captures() -> int:
    """Captured solver chunks the cache holds."""
    return sum(p.graph is not None for p in _PROGRAMS.values())


def clear_programs() -> None:
    """Drop every cached capture (its graph and static buffers)."""
    for fin in _WATCHED.values():
        fin.detach()
    _WATCHED.clear()
    _PROGRAMS.clear()


def _forget(oid: int) -> None:
    """`oid`'s object was collected: drop the captures that read it."""
    _WATCHED.pop(oid, None)
    for key in [k for k, p in _PROGRAMS.items() if oid in p.owners]:
        del _PROGRAMS[key]


def _watch(obj) -> int:
    oid = id(obj)
    if oid not in _WATCHED:
        fin = weakref.finalize(obj, _forget, oid)  # TypeError: no weakref
        fin.atexit = False
        _WATCHED[oid] = fin
    return oid


def _graph_program(key, owners) -> _Program:
    """The cached capture for `key` (a new one when absent), or an
    uncached one when `key` is None or an owner takes no weak
    reference."""
    if key is None:
        return _Program()
    prog = _PROGRAMS.get(key)
    if prog is None:
        try:
            ids = frozenset(_watch(o) for o in owners)
        except TypeError:
            return _Program()
        prog = _PROGRAMS[key] = _Program(ids)
        while len(_PROGRAMS) > MAX_PROGRAMS:
            _PROGRAMS.popitem(last=False)
    _PROGRAMS.move_to_end(key)
    return prog


@contextlib.contextmanager
def recording():
    """Within the block, every solve that replays a graph appends
    (program, step, cond, chunk) to the list it yields, so a caller can
    time the captured chunk against the same chunk run eagerly on the
    same state.  The list holds those solves' plans until it is
    dropped."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _flag(flag, name: str = "sblas.solve.flag") -> bool:
    """A device flag read on the host: one blocking read (`host_syncs`)."""
    trace.count("host_syncs")
    with trace.span(name):
        return bool(flag)


def _solve(key, owners, step, cond, chunk: int, st: dict, c: dict,
           graph: bool) -> dict:
    """Run `step` under `cond` from `st` until `cond` drops, one chunk per
    host flag read: replayed from a captured graph, or eagerly."""
    trace.current().set(graph=graph)
    if not _flag(cond(st, c), "sblas.solve.check"):
        return st
    if not graph:
        while True:
            with trace.span("sblas.solve.chunk"):
                st = _run_chunk(step, cond, chunk, st, c)
            if not _flag(cond(st, c)):
                return st
    prog = _graph_program(key, owners)
    if _RECORD is not None:
        _RECORD.append((prog, step, cond, chunk))
    return prog.run(step, cond, chunk, st, c)


def _key(name: str, form: _Form, *rest) -> Optional[tuple]:
    return None if form.key is None else (name, form.key) + rest


def _use_graph(graph: Optional[bool], form: _Form, device) -> bool:
    """The `graph` argument resolved: None captures where it can (one
    device, CUDA); True there only, raising elsewhere; False never."""
    on_cuda = torch.device(device).type == "cuda"
    if graph is None:
        return form.local and on_cuda
    if graph:
        require(form.local, PartitionError,
                "graph=True with distributed shards: their chunks run "
                "eagerly (no NCCL inside a captured graph); pass "
                "graph=False")
        require(on_cuda, KernelError, "graph=True needs a CUDA device")
    return bool(graph)


def jacobi_inv_diag(A, dtype=None, *, device) -> torch.Tensor:
    """Inverse-diagonal (Jacobi) preconditioner vector for `cg(M=...)`, on
    `device`.  `A` is a `CsrMatrix`; zero or absent diagonal entries map
    to 1.0 (no preconditioning on that row) rather than inf."""
    m, n = A.shape
    md = min(m, n)
    nnz_m = int(A.row_ptr[m])
    rows = np.repeat(np.arange(m, dtype=np.int64), A.row_nnz)
    hit = A.col_idx[:nnz_m] == rows
    d = np.zeros(md, dtype=np.float64)
    d[rows[hit][rows[hit] < md]] = A.values[:nnz_m][hit][rows[hit] < md]
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
    return torch.as_tensor(inv, dtype=dtype or torch.float32, device=device)


def _rel(form: _Form, r, b2) -> torch.Tensor:
    tiny = torch.finfo(r.dtype).tiny
    return torch.sqrt(form.dot(r, r) / torch.clamp(b2, min=tiny))


def _result(residual, it) -> tuple:
    """The solve's residual and iteration count read on the host: two
    blocking reads (`host_syncs`)."""
    trace.count("host_syncs", 2)
    with trace.span("sblas.solve.result"):
        return float(residual), int(it)


def _precond(M) -> Optional[str]:
    """What `M` is, as the solve span names it."""
    if M is None:
        return None
    return "callable" if callable(M) else "jacobi"


def _traced(solver: str):
    """Run the solver inside span `sblas.solve` (attributes `solver`,
    `graph`, `iterations`; `precond`, the preconditioner's kind or None;
    `executed`, the iterations run on the device: whole chunks, the
    masked tail of the last included)."""
    def wrap(fn):
        chunk0 = inspect.signature(fn).parameters["chunk"].default

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with trace.span("sblas.solve", solver=solver) as sp:
                res = fn(*args, **kwargs)
                chunk = kwargs.get("chunk", chunk0)
                sp.set(iterations=res.iterations,
                       precond=_precond(kwargs.get("M")),
                       executed=-(-res.iterations // chunk) * chunk)
                return res
        return run
    return wrap


@_traced("cg")


def cg(A, b, *, x0=None, tol: float = 1e-6, maxiter: int = 500, M=None,
       mesh=None, chunk: int = 16, graph: Optional[bool] = None
       ) -> SolveResult:
    """Conjugate gradients for SPD A, on b's device.

    `A` as in `_matvec_of`; `M` is an optional preconditioner, either a
    callable v -> M^-1 v or a tensor holding the inverse diagonal
    (`jacobi_inv_diag`).  Terminates when ||r|| <= tol * ||b|| or at
    `maxiter`.  `chunk` and `graph` as in the module docstring."""
    form = _matvec_of(A, mesh, b.dtype, b.device)
    use_graph = _use_graph(graph, form, b.device)
    b_ = form.vec(b)
    x = torch.zeros_like(b_) if x0 is None else form.vec(x0).clone()
    consts = {}
    if M is not None and not callable(M):
        consts["m"] = form.vec(torch.as_tensor(M, dtype=b.dtype,
                                               device=b.device))

    def psolve(v, c):
        if "m" in c:
            return v * c["m"]
        return M(v) if M is not None else v

    mv, dot = form.mv, form.dot
    r = b_ - mv(x)
    z = psolve(r, consts)
    p = r if M is None else z
    b2 = dot(b_, b_)
    consts["tol2"] = (tol * tol) * b2

    def cond(st, c):
        return (st["it"] < maxiter) & (dot(st["r"], st["r"]) > c["tol2"])

    def step(st, c):
        x_c, r_c, p_c, rz_c = st["x"], st["r"], st["p"], st["rz"]
        Ap = mv(p_c)
        alpha = rz_c / dot(p_c, Ap)
        x_n = x_c + alpha * p_c
        r_n = r_c - alpha * Ap
        z_n = psolve(r_n, c)
        rz_n = dot(r_n, z_n)
        p_n = z_n + (rz_n / rz_c) * p_c
        return dict(x=x_n, r=r_n, p=p_n, rz=rz_n, it=st["it"] + 1)

    mkind = id(M) if callable(M) else ("m" in consts)
    key = _key("cg", form, tuple(b_.shape), b.dtype, str(b.device), tol,
               maxiter, chunk, mkind)
    owners = (form.owner, M) if callable(M) else (form.owner,)
    st = dict(x=x, r=r, p=p, rz=dot(r, z),
              it=torch.zeros((), dtype=torch.int64, device=b.device))
    st = _solve(key, owners, step, cond, chunk, st, consts, use_graph)
    rel, its = _result(_rel(form, st["r"], b2), st["it"])
    return SolveResult(x=st["x"], iterations=its, residual=rel,
                       converged=rel <= tol * 1.0000001)


@_traced("bicgstab")
def bicgstab(A, b, *, x0=None, tol: float = 1e-6, maxiter: int = 500,
             mesh=None, chunk: int = 16, graph: Optional[bool] = None
             ) -> SolveResult:
    """BiCGSTAB for general (nonsymmetric) A: the webbase-class matrices
    are directed graphs, where CG's SPD requirement fails.  Same forms of
    A, chunks and graphs as `cg`.

    A breakdown (rho or omega ~ 0) stops the loop at the current iterate;
    `converged` then reports from the residual."""
    form = _matvec_of(A, mesh, b.dtype, b.device)
    use_graph = _use_graph(graph, form, b.device)
    mv, dot = form.mv, form.dot
    b_ = form.vec(b)
    x = torch.zeros_like(b_) if x0 is None else form.vec(x0).clone()
    r = b_ - mv(x)
    b2 = dot(b_, b_)
    # finfo.tiny, not a 1e-300 literal: that underflows to 0.0 in float32
    # and an exact convergence mid-iteration (t == 0) would give 0/0
    eps = torch.finfo(b.dtype).tiny
    consts = dict(rhat=r.clone(), tol2=(tol * tol) * b2)

    def cond(st, c):
        return (st["alive"] & (st["it"] < maxiter)
                & (dot(st["r"], st["r"]) > c["tol2"]))

    def step(st, c):
        rhat = c["rhat"]
        rho_n = dot(rhat, st["r"])
        beta = (rho_n / st["rho"]) * (st["alpha"] / st["omega"])
        p_n = st["r"] + beta * (st["p"] - st["omega"] * st["v"])
        v_n = mv(p_n)
        alpha = rho_n / dot(rhat, v_n)
        s = st["r"] - alpha * v_n
        t = mv(s)
        tt = dot(t, t)
        omega_n = dot(t, s) / torch.clamp(tt, min=eps)
        x_n = st["x"] + alpha * p_n + omega_n * s
        r_n = s - omega_n * t
        alive = (torch.abs(rho_n) > eps) & (torch.abs(omega_n) > eps)
        return dict(x=x_n, r=r_n, p=p_n, v=v_n, rho=rho_n, alpha=alpha,
                    omega=omega_n, it=st["it"] + 1, alive=alive)

    key = _key("bicgstab", form, tuple(b_.shape), b.dtype, str(b.device),
               tol, maxiter, chunk)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros_like(b_)
    st = dict(x=x, r=r, p=zero, v=zero.clone(), rho=one, alpha=one.clone(),
              omega=one.clone(),
              it=torch.zeros((), dtype=torch.int64, device=b.device),
              alive=torch.ones((), dtype=torch.bool, device=b.device))
    st = _solve(key, (form.owner,), step, cond, chunk, st, consts,
                use_graph)
    rel, its = _result(_rel(form, st["r"], b2), st["it"])
    return SolveResult(x=st["x"], iterations=its, residual=rel,
                       converged=rel <= tol * 1.0000001)


@_traced("pagerank")
def pagerank(PT, n: int, *, dangling=None, damping: float = 0.85,
             tol: float = 1e-8, maxiter: int = 200, r0=None, mesh=None,
             chunk: int = 16, graph: Optional[bool] = None) -> SolveResult:
    """Power iteration on a column-stochastic transition matrix.

    `PT` is (a plan, shards or callable for) P^T, where edge i -> j
    contributes 1/outdeg(i) at (j, i); `dangling` is the {0,1} mask of
    pages with no out-link (their mass spreads uniformly).  Iterates
    r' = damping * (P^T r + dangling_mass / n) + (1 - damping)/n until
    the L1 change passes `tol`.  The vectors live on the plan's device
    (r0's for a callable or a raw CsrMatrix, which then needs r0)."""
    dtype = r0.dtype if r0 is not None else torch.float32
    form = _matvec_of(PT, mesh, dtype,
                      r0.device if r0 is not None else None)
    dev = r0.device if r0 is not None else form.device
    require(dev is not None, KernelError,
            "pagerank over a callable needs r0 (its device)")
    use_graph = _use_graph(graph, form, dev)
    mv, dot, total = form.mv, form.dot, form.total
    r = form.vec(torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
                 if r0 is None else r0).clone()
    dang = form.vec(torch.zeros(n, dtype=r.dtype, device=dev)
                    if dangling is None
                    else torch.as_tensor(dangling, dtype=r.dtype,
                                         device=dev))
    a = damping

    def cond(st, c):
        return (st["it"] < maxiter) & (st["delta"] > tol)

    def step(st, c):
        r_c = st["r"]
        spread = mv(r_c)
        mass = dot(c["dang"], r_c)
        r_n = a * (spread + mass / n) + (1.0 - a) / n
        return dict(r=r_n, delta=total(torch.abs(r_n - r_c).sum()),
                    it=st["it"] + 1)

    key = _key("pagerank", form, n, tuple(r.shape), dtype, str(dev),
               damping, tol, maxiter, chunk)
    st = dict(r=r, delta=torch.full((), float("inf"), dtype=dtype,
                                    device=dev),
              it=torch.zeros((), dtype=torch.int64, device=dev))
    st = _solve(key, (form.owner,), step, cond, chunk, st, dict(dang=dang),
                use_graph)
    delta, its = _result(st["delta"], st["it"])
    return SolveResult(x=st["r"], iterations=its, residual=delta,
                       converged=delta <= tol)
