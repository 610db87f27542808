"""Plain references of the benchmark's configurations: PyTorch and NumPy
only, written from the published descriptions.  They import neither JAX,
nor the JAX package, nor anything of the port, and take nothing the port
made: the harness hands them the inputs it drew and the outputs to
judge."""
