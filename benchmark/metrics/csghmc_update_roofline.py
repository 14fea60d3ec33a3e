"""The cSGHMC update kernel's share of its bytes bound: the update's own
20 bytes an element of the padded flat vector at the card's HBM rate, over
the kernel's mean device time per launch in the trace."""


def read(ctx):
    k, tr = ctx["constants"], ctx["trace"]
    times = tr.durations(lambda name, cat: cat == "kernel"
                         and "csghmc_update" in name)
    if ctx["traffic"]["loop"] != "sample" or not times:
        return None
    bound = k.CSGHMC_UPDATE_BYTES_PER_ELEMENT * ctx["dim"] / k.HBM_BYTES_PER_S
    return 100.0 * bound / (sum(times) / len(times))
