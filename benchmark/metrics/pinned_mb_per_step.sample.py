"""Megabytes (1e6 bytes) that `pin_memory()` allocates anew per sampling
step: the program's counter `pinned_bytes` over every site, over the traced
steps.  None where the trace carries no program counters."""

from benchmark import spans


def read(ctx):
    prog, units = spans.program_of(ctx["trace"]), ctx["traced"]
    if ctx["traffic"]["loop"] != "sample" or prog is None \
            or not units.get("steps"):
        return None
    return prog.counter("pinned_bytes") / 1e6 / units["steps"]
