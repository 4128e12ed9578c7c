"""Hand-written CUDA kernels of the serving path and their plain versions."""
