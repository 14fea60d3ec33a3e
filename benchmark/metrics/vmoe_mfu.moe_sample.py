"""The V-MoE sampling step's share of the card's dense peak while the
card is busy: 3 x the analytic forward FLOPs of each training image of the
traced steps (vmoe_counts.forward_flops: the patch convolution, the
attention's products and cores, the dense MLPs, the router and the held
experts' products at the capacity's slots; nothing recomputed counted)
over the traced window's device busy time, against the peak of the
configuration's compute dtype."""

from benchmark import vmoe_counts


def read(ctx):
    c, k, tr, units = ctx["config"], ctx["constants"], ctx["trace"], \
        ctx["traced"]
    busy = tr.busy_s()
    if ctx["traffic"]["loop"] != "moe_sample" \
            or c.get("architecture") != "vmoe" \
            or not units.get("images") or busy <= 0:
        return None
    peak = k.BF16_PEAK_FLOPS if c["compute_dtype"] == "bfloat16" \
        else k.FP32_PEAK_FLOPS
    fwd = vmoe_counts.forward_flops(c)
    return 100.0 * 3.0 * fwd * units["images"] / busy / peak
