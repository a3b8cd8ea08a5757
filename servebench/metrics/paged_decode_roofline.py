"""Kernels (``kernels/paged_attention`` -> ``csrc/paged_attn.cu``): summed
roofline bound of the paged decode launches in the window's decode calls
over their device time, in %."""
from servebench import readers as rd


def read(ctx):
    return rd.roofline(ctx, "paged_decode", "decode")
