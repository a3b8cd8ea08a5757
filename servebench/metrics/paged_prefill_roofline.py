"""Kernels (``kernels/paged_prefill`` -> ``csrc/paged_prefill.cu``): summed
roofline bound of the paged prefill launches in the window's prefill calls
over their device time, in %."""
from servebench import readers as rd


def read(ctx):
    return rd.roofline(ctx, "paged_prefill", "prefill")
