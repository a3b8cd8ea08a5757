"""Model step: operations that the window's prefill calls needed (each
prompt past its cached blocks, one logit row) over their wall time at the
card's bf16 peak, in %; only the calls that ended before the profiler
started."""
from servebench import readers as rd


def read(ctx):
    return rd.mfu(ctx, ("prefill",))
