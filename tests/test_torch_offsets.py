"""The global element offset of the four kernels' plain versions (the CPU
path of ops/fused.py), which the shards of a sharded flat state take: the
shards' calls at their offsets concatenate to the whole-vector call, bit for
bit, and offset 0 is the call without one.  On the card chip_smoke.py's
phase 9a holds the kernels to the same."""

import numpy as np
import pytest
import torch

from bayesdll_tpu_torch.ops import fused, kernels

D = 4096 + 64  # whole element quads, not a power of 2
SHARDS = (2, 4)


def _vectors(seed=0):
    rng = np.random.RandomState(seed)
    t = lambda scale: torch.from_numpy(  # noqa: E731
        (scale * rng.randn(D)).astype(np.float32))
    lr = torch.from_numpy(rng.uniform(1e-3, 2e-2, D).astype(np.float32))
    mask = torch.from_numpy((rng.rand(D) > 0.1).astype(np.float32))
    return dict(g=t(0.1), theta=t(0.05), theta0=t(0.02), v=t(0.01), lr=lr,
                mask=mask)


def _call(name, vec, sl=slice(None), **kw):
    """The kernel's plain version on the [sl] parts of `vec` (copies);
    returns what it writes."""
    a = {k: v[sl].clone() for k, v in vec.items()}
    common = dict(prior_sig=0.7, n_eff=1000.0, nd=1.0, seed=5, step=3, **kw)
    if name == "csghmc_update":
        fused.csghmc_update_(a["g"], a["theta"], a["v"], alpha=0.05,
                             lr=a["lr"], should_sample=True, **common)
        return torch.cat([a["theta"], a["v"]])
    if name == "sgld_update":
        fused.sgld_update_(a["g"], a["theta"], a["theta0"], a["mask"],
                           a["lr"], **common)
        return a["g"]
    if name == "sghmc_update":
        fused.sghmc_update_(a["g"], a["theta"], a["theta0"], a["v"],
                            a["mask"], a["lr"], alpha=0.05, **common)
        return torch.cat([a["g"], a["v"]])
    kind = name.split(":")[1]
    return fused.draw_(a["g"], kind=kind, stream=kernels.STREAM_VI, seed=5,
                       step=3, **kw)


NAMES = ("csghmc_update", "sgld_update", "sghmc_update", "philox_draw:normal",
         "philox_draw:uniform")


def _split(name, out, n):
    """A result of `_call` on n elements as its written vectors."""
    return out.view(-1, n) if out.numel() > n else out.view(1, n)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("name", NAMES)
def test_shards_concatenate_to_the_whole_call(name, n_shards):
    vec = _vectors()
    whole = _split(name, _call(name, vec), D)
    size = D // n_shards
    parts = [_split(name, _call(name, vec, slice(r * size, (r + 1) * size),
                                elem0=r * size, total=D), size)
             for r in range(n_shards)]
    assert torch.equal(torch.cat(parts, 1), whole)


@pytest.mark.parametrize("name", NAMES)
def test_offset_zero_is_the_call_without_one(name):
    vec = _vectors(1)
    assert torch.equal(_call(name, vec, elem0=0, total=D), _call(name, vec))


def test_plain_draw_takes_the_kernel_offset():
    """philox_draw_plain at an offset is the slice of its whole draw, the
    counter layout the kernels' elem0 shifts."""
    whole = fused.philox_draw_plain(256, kind="normal", stream=3, seed=9,
                                    step=2)
    part = fused.philox_draw_plain(64, kind="normal", stream=3, seed=9,
                                   step=2, offset=128)
    assert torch.equal(part, whole[128:192])


@pytest.mark.parametrize("elem0,n,ok", [
    (0, 10, True), (8, 10, True), ((1 << 34) - 16, 16, True),
    (2, 10, False), (-4, 10, False), ((1 << 34) - 16, 20, False)])
def test_check_offset(elem0, n, ok):
    if ok:
        assert kernels.check_offset(elem0, n) == elem0
    else:
        with pytest.raises(ValueError):
            kernels.check_offset(elem0, n)


def test_shard_outside_its_vector_raises():
    vec = _vectors()
    with pytest.raises(ValueError, match="not inside"):
        _call("sgld_update", vec, slice(0, 1024), elem0=D - 512, total=D)
