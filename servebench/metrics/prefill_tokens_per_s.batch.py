"""Model step: prompt tokens computed (past the cached blocks) over the
wall time of the window's ``try_admit`` calls that ended before the
profiler started."""
from servebench import readers as rd


def read(ctx):
    return rd.prefill_tokens_per_s(ctx)
