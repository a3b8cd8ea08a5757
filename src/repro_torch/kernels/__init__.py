"""Hand-written Hopper kernels of the port and their wrappers.

Each kernel ships ``ref.py`` (the plain PyTorch version), ``ops.py`` (the
wrapper: checks, output allocation, launch, ``launches`` counter) and a
CUDA source under ``repro_torch/csrc/``; ``cuda_lib`` builds and loads
them.  Names match the reference's ``KERNEL_REGISTRY``.
"""
from __future__ import annotations

import importlib

# name -> (ops module, public entry point)
KERNEL_REGISTRY = {
    "decode_attention": ("repro_torch.kernels.decode_attention.ops",
                         "decode_gqa"),
    "flash_attention": ("repro_torch.kernels.flash_attention.ops",
                        "flash_mha"),
    "paged_attention": ("repro_torch.kernels.paged_attention.ops",
                        "paged_decode_gqa"),
    "paged_prefill": ("repro_torch.kernels.paged_prefill.ops",
                      "paged_prefill_gqa"),
    "sgmv": ("repro_torch.kernels.sgmv.ops", "sgmv_apply"),
}


def get_kernel(name: str):
    """Resolve a registered kernel's wrapper (lazy import)."""
    if name not in KERNEL_REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{sorted(KERNEL_REGISTRY)}")
    mod, fn = KERNEL_REGISTRY[name]
    return getattr(importlib.import_module(mod), fn)


def reset_launches() -> None:
    """Set every registered wrapper's launch count to 0."""
    for name in KERNEL_REGISTRY:
        get_kernel(name).launches = 0


def launch_counts() -> dict:
    return {name: get_kernel(name).launches for name in KERNEL_REGISTRY}


def add_launches(counts: dict) -> None:
    """Add ``counts`` (name -> launches) to the wrappers' counts: a replayed
    CUDA graph launches what its capture recorded without running the
    wrappers' Python (``serving/graphs.py``)."""
    for name, n in counts.items():
        get_kernel(name).launches += n
