"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: it keeps the
reference's module and function names, imports ``torch`` and never
``jax`` nor anything of ``repro`` (it keeps its own copies of what it
needs), and runs every TPU kernel on its path as a hand-written Hopper
kernel (``repro_torch.kernels``).  Entry points run on the card unless
the caller asks for the CPU.
"""
