"""Device milliseconds per sampling step: the union of every kernel, copy
and memset interval in the traced window over its steps.  The card's own
time, free of the host's: it holds where the host-clock rate swings."""


def read(ctx):
    tr, units = ctx["trace"], ctx["traced"]
    busy = tr.busy_s()
    if ctx["traffic"]["loop"] != "sample" or not units.get("steps") \
            or busy <= 0:
        return None
    return 1e3 * busy / units["steps"]
