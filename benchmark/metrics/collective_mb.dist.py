"""Megabytes (1e6 bytes) rank 0 hands its collectives a distributed
call, over the traced calls: the program's `collective_bytes` counter
(each all-reduce or reduce-scatter counts the tensor it reduces)."""


def read(facts):
    p, calls = facts.get("program"), facts.get("traced_calls")
    n = p["counters"].get("collective_bytes") if p else None
    return n / calls / 1e6 if n and calls else None
