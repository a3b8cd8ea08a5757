"""Model step: operations all of the window's calls that ended before the
profiler started needed over their wall time at the card's bf16 peak, in %."""
from servebench import readers as rd


def read(ctx):
    return rd.mfu(ctx, ("prefill", "decode"))
