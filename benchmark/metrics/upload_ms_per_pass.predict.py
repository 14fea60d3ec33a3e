"""Host milliseconds per predictive pass in the program's `predict.upload`
span: pinning and copying every component's mean and variance to the
card.  None where the trace carries no program spans."""

from benchmark import spans


def read(ctx):
    prog, units = spans.program_of(ctx["trace"]), ctx["traced"]
    if ctx["traffic"]["loop"] != "predict" or prog is None \
            or not units.get("passes"):
        return None
    return 1e3 * prog.host_s(("predict.upload",)) / units["passes"]
