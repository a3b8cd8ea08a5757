"""Model step: operations that the window's decode calls needed (top-k
experts, LoRA, causal attention over each row's context, one logit row a
token) over their wall time at the card's bf16 peak, in %; only the calls
that ended before the profiler started."""
from servebench import readers as rd


def read(ctx):
    return rd.mfu(ctx, ("decode",))
