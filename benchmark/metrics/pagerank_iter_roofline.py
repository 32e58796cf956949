"""Per cent of one PageRank step's bound that an executed iteration
reaches on the device: the bound of a step (`work.pagerank_iteration`:
P^T, r and the dangling mask read once, r' written once) over the
device time of the traced solves, summed, over the iterations they
executed on the card (the masked tail of the last chunk included)."""

from harness.readers import roofline


def read(facts):
    return roofline(facts, "work_per_iteration", "traced_iterations")
