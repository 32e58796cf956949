"""Host milliseconds a call spends inside the program's `ops.spmm`: the
mean of its `sblas.spmm` spans over the traced calls (the plan's
dispatch, the checks and every launch the call issues; the device's
work runs behind it).  Against the device time a call takes, it says
how close the host is to setting the stream's pace."""


def read(facts):
    p = facts.get("program")
    s = p["spans"].get("sblas.spmm") if p else None
    return s["total_ms"] / s["count"] if s and s["count"] else None
