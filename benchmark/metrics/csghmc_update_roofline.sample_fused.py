"""The cSGHMC update kernel's share of its bytes bound on the fused path
(the kernel replayed inside each step's CUDA graph): the accepted
`csghmc_update_roofline` reader, loaded as it is and called with the
mix's loop read as `sample`, on the `sample_fused` loop's traced
epochs."""

from pathlib import Path

from benchmark import spec

_SAMPLE = spec.load_reader(Path(__file__).with_name("csghmc_update_roofline.py"))


def read(ctx):
    if ctx["traffic"]["loop"] != "sample_fused":
        return None
    return _SAMPLE(dict(ctx, traffic=dict(ctx["traffic"], loop="sample")))
