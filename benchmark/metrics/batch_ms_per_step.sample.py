"""Host milliseconds per sampling step on the batch path: the program's
`loader.gather` spans (the loader's gather, augment and pad of a batch)
and the `to_device` spans inside each `step` (pinning and the copy's
launch), over the traced steps.  None where the trace carries no program
spans."""

from benchmark import spans


def read(ctx):
    prog, units = spans.program_of(ctx["trace"]), ctx["traced"]
    if ctx["traffic"]["loop"] != "sample" or prog is None \
            or not units.get("steps"):
        return None
    sec = prog.host_s(("loader.gather",)) + prog.host_s(("to_device",),
                                                        under="step")
    return 1e3 * sec / units["steps"]
