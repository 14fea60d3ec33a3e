"""The sampling step's share of the card's dense peak while the card is
busy: 3 x the analytic forward FLOPs of each training image of the traced
steps (nothing recomputed counted) over the traced window's device busy
time (the union of its kernels, copies and memsets), against the peak of
the configuration's compute dtype."""


def read(ctx):
    c, k, tr, units = ctx["config"], ctx["constants"], ctx["trace"], \
        ctx["traced"]
    fwd = k.FWD_FLOPS_PER_EXAMPLE.get(c["backbone"])
    busy = tr.busy_s()
    if ctx["traffic"]["loop"] != "sample" or fwd is None \
            or not units.get("images") or busy <= 0:
        return None
    peak = k.BF16_PEAK_FLOPS if c["compute_dtype"] == "bfloat16" \
        else k.FP32_PEAK_FLOPS
    return 100.0 * 3.0 * fwd * units["images"] / busy / peak
