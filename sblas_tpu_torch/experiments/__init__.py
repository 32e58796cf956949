"""The JAX package's experiment probes, ported: each runs its question on
the CUDA device (`--device cuda`, the default) or, for a check of its
control flow, on the CPU."""
