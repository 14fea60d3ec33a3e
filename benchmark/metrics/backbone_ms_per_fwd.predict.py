"""Device milliseconds per predictive forward pass (one draw of one
component on one batch) in the backbone's own kernels (the families conv
and gemm, attention, layer norm, batch norm)."""


def read(ctx):
    k, tr, units = ctx["constants"], ctx["trace"], ctx["traced"]
    if ctx["traffic"]["loop"] != "predict" or not units.get("forwards"):
        return None
    sec = sum(tr.time_by_name(lambda name, cat: cat == "kernel" and
                              k.family(name) in k.BACKBONE_FAMILIES).values())
    return 1e3 * sec / units["forwards"] if sec > 0 else None
