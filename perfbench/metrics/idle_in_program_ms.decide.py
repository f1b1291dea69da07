"""Device idle ms a decision that the program's spans cover: the idle
gaps of the stretch profiled on the card alone with the recorder on,
put down to the innermost span, summed over spans, per decision.  The
rest of the idle time is the harness's synchronise, copy and loop."""
from perfbench.lib import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else sp.idle_in_program_ms
