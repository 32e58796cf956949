"""Milliseconds of NCCL kernels a distributed call takes on rank 0's
device, over the traced calls.  An NCCL kernel starts when its rank
arrives, so this includes the wait for the other ranks."""

from harness.readers import traced


def read(facts):
    s = traced(facts)
    calls = facts.get("traced_calls")
    if s is None or not calls or s["nccl_s"] <= 0:
        return None
    return 1e3 * s["nccl_s"] / calls
