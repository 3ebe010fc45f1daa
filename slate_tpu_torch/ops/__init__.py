"""Array-level kernels: elementwise, BLAS-3, norms and the CUDA norm kernels."""
