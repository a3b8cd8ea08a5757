"""PyTorch/CUDA port of the ServerlessLoRA serving system.

Mirrors ``src/repro/`` path for path.  The package imports ``torch`` and
``numpy`` only: it never imports JAX, nor anything of the JAX package
(host-side modules that the reference keeps jax-free are copied here, not
imported).  Every Pallas kernel of the reference is a CUDA C++ kernel
written for Hopper (``csrc/``), reached through the wrappers under
``kernels/``; a wrapper runs its plain PyTorch version only for tensors
that lie on the CPU, which is how the tier-1 tests run.
"""
