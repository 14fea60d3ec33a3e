"""The held experts' products' share of their roofline, forward: their
work at the capacity's slots in every step's forward
(vmoe_counts.experts_forward: 2 H cap 2 d m FLOPs a MoE layer, and the
bytes of their operands and results) at the larger of its bf16 compute
time and its HBM time, over the device time of the kernels launched
inside the program's `moe.experts` spans of each `step`.  The same
yardstick whatever implements the products; None where the trace
carries no program spans or no such kernel ran."""

from benchmark import spans, vmoe_counts


def read(ctx):
    c, k, units = ctx["config"], ctx["constants"], ctx["traced"]
    prog = spans.program_of(ctx["trace"])
    if ctx["traffic"]["loop"] != "moe_sample" or prog is None \
            or c.get("architecture") != "vmoe" or not units.get("steps"):
        return None
    sec = prog.kernel_s(("moe.experts",), under="step")
    if sec <= 0:
        return None
    bound = vmoe_counts.experts_bound_s(c, units["steps"], k.BF16_PEAK_FLOPS,
                                        k.HBM_BYTES_PER_S)
    return 100.0 * bound / sec
