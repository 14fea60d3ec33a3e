"""The card's idle share over the traced predictive passes: 100 x (1 - the
union of every kernel, copy and memset interval / the window's span)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["traffic"]["loop"] != "predict" or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.span_s)
