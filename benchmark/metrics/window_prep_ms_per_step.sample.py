"""Device milliseconds per sampling step in the SwinV2 attention's
preparation, forward: the kernels launched inside the program's
`swin.window` (roll, window partition and reverse) and `swin.bias` (the
CPB MLP, its gather, 16 sigmoid and the mask add) spans of each `step`,
over the traced steps.  Their backward runs after the forward's spans have
closed and is not counted.  None where the trace carries no program
spans."""

from benchmark import spans

PREP = ("swin.window", "swin.bias")


def read(ctx):
    prog, units = spans.program_of(ctx["trace"]), ctx["traced"]
    if ctx["traffic"]["loop"] != "sample" or prog is None \
            or not units.get("steps"):
        return None
    return 1e3 * prog.kernel_s(PREP, under="step") / units["steps"]
