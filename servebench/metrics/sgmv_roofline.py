"""Kernels (``kernels/sgmv`` -> ``csrc/sgmv.cu``): summed roofline bound of
the SGMV launches in the window's decode calls over their device time,
in %."""
from servebench import readers as rd


def read(ctx):
    return rd.roofline(ctx, "sgmv", "decode")
