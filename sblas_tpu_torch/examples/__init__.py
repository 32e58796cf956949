"""The JAX package's example programs, ported: CG on the shell proxy,
PageRank on the webbase proxy, and PageRank over the footprint-compressed
x exchange.  Each runs on the CUDA device (`--device cuda`, the default)
or on the CPU, through the library solvers (`sblas_tpu_torch.solvers`),
and prints `Validation = True` when its answer holds against numpy."""
