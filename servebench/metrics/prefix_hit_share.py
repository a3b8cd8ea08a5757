"""Prefix cache (``serving/prefix.py`` + ``serving/kv_pool.py``): prompt
tokens the cache covered over prompt tokens admitted in the window, in %,
from the runtime's ``shared_tokens`` and ``prompt_tokens`` counters."""
from servebench import readers as rd


def read(ctx):
    admitted = rd.counter(ctx, "prompt_tokens")
    if admitted <= 0:
        return None
    return 100.0 * rd.counter(ctx, "shared_tokens") / admitted
