"""The cSGHMC update kernel's share of its bytes bound at V-MoE's flat
vector (D about 1.0B, the benchmark's largest): the accepted
`csghmc_update_roofline` reader, loaded as it is and called with the
mix's loop read as `sample`, on the `moe_sample` loop's traced epochs."""

from pathlib import Path

from benchmark import spec

_SAMPLE = spec.load_reader(Path(__file__).with_name("csghmc_update_roofline.py"))


def read(ctx):
    if ctx["traffic"]["loop"] != "moe_sample":
        return None
    return _SAMPLE(dict(ctx, traffic=dict(ctx["traffic"], loop="sample")))
