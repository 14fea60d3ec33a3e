"""The whole-vector draw of VI, MC-dropout and the Adam momentum noise
(ops/fused.py::draw_, csrc/philox_draw.cu) on the CPU:
  * the plain version of the kernel (`philox_draw_plain`): Philox4x32-10
    against Random123's known-answer vectors, its counter layout (offset
    slices, streams, the pair of a normal and a uniform draw from one
    Philox call), its moments;
  * the dispatcher's CPU path: the host generator keyed by (seed, the
    stream's host stream, step), the same from the device row as from the
    host values, and the same distribution as the JAX package's
    jax.random draws;
  * the kernel wrappers refuse CPU tensors, and the stream ids match the
    CUDA header's.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against `philox_draw_plain` there."""

import re

import jax
import numpy as np
import pytest
import torch

from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.ops import fused, kernels

# Random123's known-answer vectors for philox4x32_10 (kat_vectors):
# (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
SEED = 2**63 + 12345  # past 2^63: every bit of the seed is used
STEP = 2**33 + 5      # past 2^32: the counter's high step word is used


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_matches_random123(ctr, key, want):
    got = fused.philox4x32_10(*(torch.tensor([c]) for c in ctr), *key)
    assert [int(g) for g in got] == list(want)


def test_stream_ids_match_the_header():
    text = (kernels.CSRC / "normal_from_bits.cuh").read_text()
    ids = {m[0]: int(m[1]) for m in
           re.findall(r"constexpr uint32_t (kStream\w+) = (\d+);", text)}
    assert ids == {"kStreamCsghmc": 0, "kStreamSgld": 1, "kStreamSghmc": 2,
                   "kStreamVi": kernels.STREAM_VI,
                   "kStreamAdam": kernels.STREAM_ADAM,
                   "kStreamMcDropout": kernels.STREAM_MC_DROPOUT}
    assert "philox_draw" in kernels.KERNELS
    assert (kernels.CSRC / "philox_draw.cu").exists()


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_plain_draw_counter_layout(kind):
    """An offset slice is the same slice of the whole draw (the counter is
    the absolute quad index); another stream, step or seed gives other
    bits; a ragged length is the head of the longer draw."""
    n = 4099
    kw = dict(kind=kind, stream=kernels.STREAM_VI, seed=SEED, step=STEP)
    whole = fused.philox_draw_plain(n, **kw)
    assert whole.dtype == torch.float32 and whole.shape == (n,)
    assert torch.equal(fused.philox_draw_plain(n - 1000, offset=1000, **kw),
                       whole[1000:])
    assert torch.equal(fused.philox_draw_plain(n - 3, **kw), whole[:n - 3])
    for change in (dict(stream=kernels.STREAM_ADAM), dict(step=STEP + 1),
                   dict(seed=SEED - 2**63)):
        other = fused.philox_draw_plain(n, **{**kw, **change})
        assert not torch.equal(other, whole), change
    with pytest.raises(ValueError, match="multiple of 4"):
        fused.philox_draw_plain(8, offset=2, **kw)


def test_plain_normal_is_box_muller_of_the_uniforms():
    """One Philox call per quad gives both draws: element pair (2k, 2k+1)
    of the normal draw is Box-Muller of the uniform draw's pair, its u1
    clamped at 1e-7 as the kernel clamps it."""
    kw = dict(stream=kernels.STREAM_MC_DROPOUT, seed=7, step=11)
    u = fused.philox_draw_plain(4096, kind="uniform", **kw).double()
    z = fused.philox_draw_plain(4096, kind="normal", **kw).double()
    u1 = torch.clamp(u[0::2].float(), min=np.float32(1e-7)).double()
    r = torch.sqrt(-2.0 * torch.log(u1))
    np.testing.assert_allclose(z[0::2], r * torch.cos(2 * np.pi * u[1::2]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(z[1::2], r * torch.sin(2 * np.pi * u[1::2]),
                               rtol=1e-6, atol=1e-6)


def test_plain_draw_moments():
    """The gates chip_smoke.py holds the kernel to: normals with mean
    within 0.01 and std within 2% of 1; uniforms in [0, 1), multiples of
    2^-24, mean within 0.01 of 0.5; the VI and Adam streams at one (seed,
    step) uncorrelated (|r| < 0.01)."""
    n = 1 << 18
    kw = dict(seed=SEED, step=STEP)
    z = fused.philox_draw_plain(n, kind="normal", stream=kernels.STREAM_VI,
                                **kw).double()
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.02
    u = fused.philox_draw_plain(n, kind="uniform",
                                stream=kernels.STREAM_MC_DROPOUT, **kw)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u * 2**24, torch.floor(u * 2**24))
    assert abs(float(u.double().mean()) - 0.5) < 0.01
    a = fused.philox_draw_plain(n, kind="normal", stream=kernels.STREAM_ADAM,
                                **kw).double()
    r = float(torch.corrcoef(torch.stack([z, a]))[0, 1])
    assert abs(r) < 0.01, r


HOST = [(kernels.STREAM_VI, rng.VI, "normal"),
        (kernels.STREAM_ADAM, rng.ADAM, "normal"),
        (kernels.STREAM_MC_DROPOUT, rng.MC_DROPOUT, "uniform")]


@pytest.mark.parametrize("stream,host,kind", HOST)
def test_cpu_draw_is_the_host_generator_from_dev_or_values(stream, host,
                                                           kind):
    """On the CPU draw_ is torch.randn or torch.rand from the generator
    keyed by (seed, host stream, step), the bits the methods drew before
    the kernel came; the device row (seed, step, gate) gives the same
    bits as the host values, all 64 bits of the seed included."""
    like = torch.zeros(1027)
    want = (torch.randn if kind == "normal" else torch.rand)(
        1027, generator=rng.generator("cpu", SEED, host, STEP))
    got = fused.draw_(like, kind=kind, stream=stream, seed=SEED, step=STEP)
    assert torch.equal(got, want)
    dev = kernels.dev_scalars(SEED, STEP, False, device="cpu")
    assert torch.equal(fused.draw_(like, kind=kind, stream=stream, dev=dev),
                       want)
    other = kernels.dev_scalars(SEED, STEP + 1, False, device="cpu")
    assert not torch.equal(
        fused.draw_(like, kind=kind, stream=stream, dev=other), want)


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_cpu_draw_matches_jax_random_in_distribution(kind):
    """draw_ and the JAX package's jax.random draw at the same length: the
    same distribution (their deciles within 0.02; other bits)."""
    n = 1 << 16
    got = fused.draw_(torch.zeros(n), kind=kind, stream=kernels.STREAM_VI,
                      seed=3, step=5).numpy()
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.normal(key, (n,)) if kind == "normal"
                      else jax.random.uniform(key, (n,)))
    qs = np.linspace(0.1, 0.9, 9)
    np.testing.assert_allclose(np.quantile(got, qs), np.quantile(want, qs),
                               atol=0.02)


def test_draw_wrappers_refuse_cpu_tensors_and_bad_arguments():
    """The kernel wrappers take a CUDA `like` only and count nothing when
    they refuse; draw_ refuses an unknown kind or stream."""
    like = torch.zeros(1024)
    dev = kernels.dev_scalars(7, 11, device="cpu")
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.philox_draw(like, kind="normal", stream=kernels.STREAM_VI,
                            seed=7, step=11)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.philox_draw_dev(like, dev, kind="uniform",
                                stream=kernels.STREAM_MC_DROPOUT)
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="kind"):
        fused.draw_(like, kind="gumbel", stream=kernels.STREAM_VI)
    with pytest.raises(ValueError, match="stream"):
        fused.draw_(like, kind="normal", stream=0)
    with pytest.raises(ValueError, match="kind"):
        fused.philox_draw_plain(8, kind="gumbel", stream=3, seed=0, step=0)
