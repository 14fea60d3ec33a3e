"""Gigabytes (1e9 bytes) handed to the card per predictive pass: the
program's counter `to_device_bytes` over every site (components and
batches), over the traced passes.  None where the trace carries no
program counters."""

from benchmark import spans


def read(ctx):
    prog, units = spans.program_of(ctx["trace"]), ctx["traced"]
    if ctx["traffic"]["loop"] != "predict" or prog is None \
            or not units.get("passes"):
        return None
    return prog.counter("to_device_bytes") / 1e9 / units["passes"]
