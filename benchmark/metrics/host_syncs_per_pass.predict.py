"""Blocking device-to-host reads per predictive pass: the program's
counter `host_syncs` over every site, over the traced passes.  None where
the trace carries no program counters."""

from benchmark import spans


def read(ctx):
    prog, units = spans.program_of(ctx["trace"]), ctx["traced"]
    if ctx["traffic"]["loop"] != "predict" or prog is None \
            or not units.get("passes"):
        return None
    return prog.counter("host_syncs") / units["passes"]
