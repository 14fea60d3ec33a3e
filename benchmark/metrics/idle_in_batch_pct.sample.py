"""The share of the card's idle time in the traced sampling window during
which the innermost open program span is `loader.gather` or `to_device`:
the idle time that the host's batch path causes.  None where the trace
carries no program spans or the card was never idle."""

from benchmark import spans


def read(ctx):
    tr = ctx["trace"]
    prog = spans.program_of(tr)
    if ctx["traffic"]["loop"] != "sample" or prog is None:
        return None
    idle = prog.idle_by_span(tr)
    total = sum(idle.values())
    if total <= 0:
        return None
    return 100.0 * (idle.get("loader.gather", 0.0)
                    + idle.get("to_device", 0.0)) / total
