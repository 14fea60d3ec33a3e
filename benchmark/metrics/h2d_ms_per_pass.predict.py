"""Device milliseconds per predictive pass in host-to-card copies (the
components' uploads and the batches')."""


def read(ctx):
    tr, units = ctx["trace"], ctx["traced"]
    if ctx["traffic"]["loop"] != "predict" or not units.get("passes"):
        return None
    sec = sum(tr.durations(lambda name, cat: cat == "gpu_memcpy"
                           and "HtoD" in name))
    return 1e3 * sec / units["passes"] if sec > 0 else None
