"""Host seconds of the set-up spent building route programs: the
program's `sblas.plan.route` spans (`build_route`, its edge colouring
included) recorded from the start of set-up to the window, summed."""


def read(facts):
    s = (facts.get("program_setup") or {}).get("sblas.plan.route")
    return s["total_ms"] / 1e3 if s and s["count"] else None
