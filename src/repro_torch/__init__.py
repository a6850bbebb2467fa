"""PyTorch/CUDA port of the ``repro`` framework for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; this package keeps its own
copies of everything it needs and never imports ``jax`` or ``repro``.
Hot-path kernels are written by hand (``kernels/``): CUDA C++ for
``sm_90a`` built with nvcc at first use.  See README.md for the layout and
how to run it.
"""
