"""Device milliseconds per sampling step in the attention family's kernels
(constants.family: the cores' forward and backward, whichever backend runs
them).  None where no such kernel ran."""


def read(ctx):
    k, tr, units = ctx["constants"], ctx["trace"], ctx["traced"]
    if ctx["traffic"]["loop"] != "sample" or not units.get("steps"):
        return None
    sec = sum(tr.time_by_name(lambda name, cat: cat == "kernel" and
                              k.family(name) == "attention").values())
    return 1e3 * sec / units["steps"] if sec > 0 else None
