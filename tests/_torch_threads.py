"""Torch's intra-op threads in a test process, set when a port test file
is imported.

Under pytest-xdist each worker is a process of its own, and torch starts
one OpenMP thread a core in each: with 6 workers on 8 cores that is 48
threads, whose spinning waits starve the other workers (the port's six
heaviest files took 667 s together under ``-n 6 --dist loadfile``, 72 s
with one thread a worker, on an 8-core machine).  So a worker keeps its
share of the cores, at least one; a run without xdist keeps torch's
default.  The whole suite passes with either count.  Imported first by
every ``tests/test_torch_*.py``; since each xdist worker collects every
file, the cap holds in every worker, for the reference's files too
(which run on JAX and XLA's own threads)."""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
