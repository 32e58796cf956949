"""Iterations a solve executed on the card, averaged over the window's
solves: the iterations the solver reports, rounded up to its whole
chunks (the CUDA graph replays a whole chunk, the masked tail
included).  The real counts are on an earlier line of stderr."""


def read(facts):
    return facts.get("iters_per_solve")
