"""Model step: wall time of the window's ``decode()`` calls that ended
before the profiler started (each ends in a host read) over the decode
steps they ran."""
from servebench import readers as rd


def read(ctx):
    return rd.decode_step_ms(ctx)
