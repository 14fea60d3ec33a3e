"""Device milliseconds per predictive pass: the union of every kernel, copy
and memset interval in the traced window over its passes.  The card's own
time, free of the host's."""


def read(ctx):
    tr, units = ctx["trace"], ctx["traced"]
    busy = tr.busy_s()
    if ctx["traffic"]["loop"] != "predict" or not units.get("passes") \
            or busy <= 0:
        return None
    return 1e3 * busy / units["passes"]
