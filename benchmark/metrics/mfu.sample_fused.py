"""The fused cSGHMC sampling step's share of the card's dense peak while
the card is busy: the accepted `mfu.sample` reader, loaded as it is and
called with the mix's loop read as `sample`, on the `sample_fused` loop's
traced epochs."""

from pathlib import Path

from benchmark import spec

_SAMPLE = spec.load_reader(Path(__file__).with_name("mfu.sample.py"))


def read(ctx):
    if ctx["traffic"]["loop"] != "sample_fused":
        return None
    return _SAMPLE(dict(ctx, traffic=dict(ctx["traffic"], loop="sample")))
