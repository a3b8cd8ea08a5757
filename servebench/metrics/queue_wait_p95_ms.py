"""Admission (``serving/slots.py`` + ``serving/runtime.py``): the 95th
percentile of due time to slot bound over the requests due in the window
before the profiler started, from the driver's records."""
from servebench import readers as rd


def read(ctx):
    return rd.pct(rd.queue_waits_ms(ctx), 95)
