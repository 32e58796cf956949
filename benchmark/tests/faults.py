"""Faults planted underneath the timed path, for the tests that see a
run's `correct` come out false.

Each fault replaces one function of the program (through `setattr`,
pytest's `monkeypatch.setattr` in a test process, plain `setattr` in a
spawned rank) with a broken one:

* `unchanged`: a step returns its state unchanged (SpMM: C' = C; a
  PageRank step keeps r);
* `half`: half of the batch left out (the last half of B's columns not
  multiplied: C' = C there);
* `altered`: an answer altered where it is produced (one element of
  each product; one rank of each SpMV);
* `no_exchange`: the exchange between cards left out (mode 2's
  all-reduce returns the rank's own partial).
"""

from __future__ import annotations


def plant(fault: str, setattr_=setattr) -> None:
    from sblas_tpu_torch import ops, solvers
    from sblas_tpu_torch.parallel import planned
    spmm, spmv, masked = ops.spmm, ops.spmv, solvers._masked
    local, finish = planned._local_spmm, planned._planned_finish

    def spmm_unchanged(plan, B, alpha=1.0, beta=1.0, C=None):
        return C.clone()

    def spmm_half(plan, B, alpha=1.0, beta=1.0, C=None):
        out = spmm(plan, B, alpha, beta, C)
        h = B.shape[1] // 2
        out[:, h:] = C[:, h:]
        return out

    def spmm_altered(plan, B, alpha=1.0, beta=1.0, C=None):
        out = spmm(plan, B, alpha, beta, C)
        out[out.shape[0] // 2, 0] += 1.0
        return out

    def spmv_altered(plan, x, alpha=1.0, beta=1.0, y=None):
        out = spmv(plan, x, alpha, beta, y)
        out[out.shape[0] // 2] += 1e-3
        return out

    def masked_unchanged(step, cond, st, c):
        new = masked(step, cond, st, c)
        return dict(new, r=st["r"]) if "r" in st else new

    def local_half(kind, plan, B):
        out = local(kind, plan, B)
        out[:, B.shape[1] // 2:] = 0
        return out

    def local_altered(kind, plan, B):
        out = local(kind, plan, B)
        out[out.shape[0] // 2, 0] += 1.0
        return out

    def finish_unchanged(shards, local_, alpha, beta, Y, mesh, reduce):
        finish(shards, local_, alpha, beta, Y, mesh, reduce)
        return Y.clone()

    patches = {
        "unchanged": [(ops, "spmm", spmm_unchanged),
                      (solvers, "_masked", masked_unchanged),
                      (planned, "_planned_finish", finish_unchanged)],
        "half": [(ops, "spmm", spmm_half),
                 (planned, "_local_spmm", local_half)],
        "altered": [(ops, "spmm", spmm_altered),
                    (ops, "spmv", spmv_altered),
                    (planned, "_local_spmm", local_altered)],
        "no_exchange": [(planned, "all_reduce", lambda t, mesh: t)],
    }[fault]
    for mod, name, fn in patches:
        setattr_(mod, name, fn)


def broken_program(fault: str):
    """The program with `fault` planted (a spawned rank's factory)."""
    plant(fault)
    from harness.program import Program
    return Program()
