"""Device milliseconds per predictive pass of the kernels launched inside
the program's `predict.draw` spans: each component's standard deviation
and each draw's normals and `mean + std * eps`.  None where the trace
carries no program spans."""

from benchmark import spans


def read(ctx):
    prog, units = spans.program_of(ctx["trace"]), ctx["traced"]
    if ctx["traffic"]["loop"] != "predict" or prog is None \
            or not units.get("passes"):
        return None
    return 1e3 * prog.kernel_s(("predict.draw",)) / units["passes"]
