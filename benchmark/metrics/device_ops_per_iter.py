"""Device operations (kernels, copies, fills) of the traced solves over
the iterations they executed on the card: the launches an iteration
costs, a solve's own (its eager initial residual, the graph's copies)
spread over its iterations."""

from harness.readers import traced


def read(facts):
    s, units = traced(facts), facts.get("traced_iterations")
    return s["device_events"] / units if s and units else None
