"""The SwinV2 attention cores' share of their roofline: the cores' own
work of the traced steps (swinv2_counts.attention_step: 12 N^2 d FLOPs and
24 N d bytes per window and head) at the larger of its bf16 compute time
and its HBM time, over the measured time of the attention family's kernels
(constants.family) in the same steps.  The same yardstick whatever
implements the cores; None where no attention kernel ran."""

from benchmark import swinv2_counts


def read(ctx):
    c, k, tr, units = ctx["config"], ctx["constants"], ctx["trace"], \
        ctx["traced"]
    if ctx["traffic"]["loop"] != "sample" \
            or c.get("architecture") != "swinv2" or not units.get("images"):
        return None
    sec = sum(tr.time_by_name(lambda name, cat: cat == "kernel" and
                              k.family(name) == "attention").values())
    if sec <= 0:
        return None
    bound = swinv2_counts.attention_bound_s(c, units["images"],
                                            k.BF16_PEAK_FLOPS,
                                            k.HBM_BYTES_PER_S)
    return 100.0 * bound / sec
