"""PyTorch/CUDA port of the Harmonia serving stack.

Mirrors the module layout of the JAX package ``repro`` and serves its
models on an NVIDIA Hopper GPU.  The Pallas kernels of the serving path
are CUDA C++ kernels written for ``sm_90a`` (``kernels/csrc``), each with
a plain PyTorch version beside it; a kernel wrapper launches the kernel
for CUDA tensors and runs the plain version for CPU tensors.

The port imports ``torch`` and never ``jax`` or ``repro``.
"""
