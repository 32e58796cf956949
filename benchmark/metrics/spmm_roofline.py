"""Per cent of the SpMM's bound that a call reaches on the device: the
bound of C' = beta*C + alpha*A@B (`work.spmm`: A, B, C and C' once, at
the card's HBM bandwidth, or its 2 nnz K operations at the float32
peak, whichever is longer) over the device time of a traced call (all
device operations of the traced calls, summed, over their number).  It
reads the same work whatever plan or kernel implements the call."""

from harness.readers import roofline


def read(facts):
    return roofline(facts, "work_per_call", "traced_calls")
