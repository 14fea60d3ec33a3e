"""The card's idle share over the traced V-MoE sampling epochs: the
accepted `device_idle_pct.sample` reader, loaded as it is and called
with the mix's loop read as `sample`, on the `moe_sample` loop's traced
epochs."""

from pathlib import Path

from benchmark import spec

_SAMPLE = spec.load_reader(Path(__file__).with_name("device_idle_pct.sample.py"))


def read(ctx):
    if ctx["traffic"]["loop"] != "moe_sample":
        return None
    return _SAMPLE(dict(ctx, traffic=dict(ctx["traffic"], loop="sample")))
