"""Device: share of the window's time with work pending (a slot bound or
a request queued) in which no kernel ran, from the profiler's timeline,
in %."""
from servebench import readers as rd


def read(ctx):
    return rd.idle_share(ctx)
