"""Per cent of one CG + Jacobi iteration's bound that an executed
iteration reaches on the device: the bound of an iteration
(`pcg.pcg_iteration`: A once in CSR, p, x, r and the inverse diagonal
read once, x, r and p written once) over the device time of the traced
solves, summed, over the iterations they executed on the card (the
masked tail of the last chunk included; the solve's eager initial
residual counted in the device time)."""

from harness.readers import roofline


def read(facts):
    return roofline(facts, "work_per_iteration", "traced_iterations")
