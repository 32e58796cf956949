"""Blocking device-to-host reads a solve makes, over the traced solves:
the program's `host_syncs` counter (the entry check, one flag a chunk,
the residual and the iteration count)."""


def read(facts):
    p, solves = facts.get("program"), facts.get("traced_solves")
    syncs = p["counters"].get("host_syncs") if p else None
    return syncs / solves if syncs and solves else None
