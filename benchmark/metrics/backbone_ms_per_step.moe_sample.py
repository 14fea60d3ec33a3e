"""Device milliseconds per V-MoE sampling step in the backbone's own
kernels: the accepted `backbone_ms_per_step.sample` reader, loaded as it
is and called with the mix's loop read as `sample`, on the `moe_sample`
loop's traced epochs.  It takes kernels by family from their names, so
the held experts' products (cuBLAS GEMMs, forward and backward) count
here beside the attention's and the dense MLPs'; the MoE layers' own
time is `moe_ms_per_step.moe_sample`."""

from pathlib import Path

from benchmark import spec

_SAMPLE = spec.load_reader(Path(__file__).with_name("backbone_ms_per_step.sample.py"))


def read(ctx):
    if ctx["traffic"]["loop"] != "moe_sample":
        return None
    return _SAMPLE(dict(ctx, traffic=dict(ctx["traffic"], loop="sample")))
