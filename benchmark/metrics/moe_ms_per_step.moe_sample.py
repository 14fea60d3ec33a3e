"""Device milliseconds per sampling step in the MoE layers: the kernels
launched inside the program's `moe.route`, `moe.dispatch`, `moe.experts`
and `moe.combine` spans of each `step` (models/vmoe.py's forward), and
inside its `moe.dispatch.bwd` and `moe.combine.bwd` spans (their
backward, opened on the autograd thread and so under no `step`), over the
traced steps.  The backward of the router and of the expert products is
plain autograd outside any of them and is not counted.  None where the
trace carries no program spans."""

from benchmark import spans

FORWARD = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
BACKWARD = ("moe.dispatch.bwd", "moe.combine.bwd")


def read(ctx):
    prog, units = spans.program_of(ctx["trace"]), ctx["traced"]
    if ctx["traffic"]["loop"] != "moe_sample" or prog is None \
            or not units.get("steps"):
        return None
    sec = prog.kernel_s(FORWARD, under="step") + prog.kernel_s(BACKWARD)
    return 1e3 * sec / units["steps"]
