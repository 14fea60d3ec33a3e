"""Device milliseconds per sampling step in the flat-vector passes: the
kernels launched inside the program's `lr_vec`, `update`, `moments` and
`forward.cast` spans of each `step` (the step-size vector, the sampler's
update, the Welford moments and the per-leaf cast of the forward), over
the traced steps.  None where the trace carries no program spans."""

from benchmark import spans

FLAT = ("lr_vec", "update", "moments", "forward.cast")


def read(ctx):
    prog, units = spans.program_of(ctx["trace"]), ctx["traced"]
    if ctx["traffic"]["loop"] != "sample" or prog is None \
            or not units.get("steps"):
        return None
    return 1e3 * prog.kernel_s(FLAT, under="step") / units["steps"]
