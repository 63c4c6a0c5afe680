"""Benchmarks of the port on the GPU: the kernel A/B suite (`kernels`)."""
