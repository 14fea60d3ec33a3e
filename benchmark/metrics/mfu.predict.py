"""The predictive's share of the card's dense peak while the card is busy:
the analytic forward FLOPs of every image of the traced passes under every
component's every draw over the traced window's device busy time (the
union of its kernels, copies and memsets), against the peak of the
configuration's compute dtype."""


def read(ctx):
    c, k, tr, units = ctx["config"], ctx["constants"], ctx["trace"], \
        ctx["traced"]
    fwd = k.FWD_FLOPS_PER_EXAMPLE.get(c["backbone"])
    busy = tr.busy_s()
    if ctx["traffic"]["loop"] != "predict" or fwd is None \
            or not units.get("images") or busy <= 0:
        return None
    t = ctx["traffic"]
    draws = t["components"] * max(1, t["nst"])
    peak = k.BF16_PEAK_FLOPS if c["compute_dtype"] == "bfloat16" \
        else k.FP32_PEAK_FLOPS
    return 100.0 * fwd * units["images"] * draws / busy / peak
