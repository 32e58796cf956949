"""Milliseconds a solve leaves the device idle inside the solver: the
traced stretch's idle gaps that began inside a `sblas.solve` span or
one of its children (`sblas.solve.flag`, `.copy_in`, `.replay`, ...),
summed, over the traced solves."""

from harness.readers import traced


def read(facts):
    p, solves = facts.get("program"), facts.get("traced_solves")
    if p is None or not solves or traced(facts) is None:
        return None
    idle = sum(s for name, s in p["idle"].items()
               if name == "sblas.solve" or name.startswith("sblas.solve."))
    return 1e3 * idle / solves
