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
    CUDA header's;
  * the kernel's fp32 Box-Muller (csrc/normal_from_bits.cuh::box_muller),
    emulated step for step by `fused.box_muller_fp32`, against float64
    Box-Muller exhaustively: r over all 2^24 values of u1's k, (cos, sin)
    over all 2^24 values of the angle's m, within bounds that imply
    |z - z64| <= 1e-6; named edge cases; the emulation's fused multiply-add
    rounded once; its constants equal to the header's.

The CUDA kernel itself runs only on the card: chip_smoke.py's phase 6e
holds it against `philox_draw_plain` (float64, within 1e-5) and against
`philox_draw_plain(fp32=True)` (bitwise, or within an ulp where MUFU.RSQ
rounds r otherwise) there."""

import math
import re
from fractions import Fraction

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
    """The kernel's wrapper takes a CUDA `like` only and counts nothing
    when it refuses; draw_ refuses an unknown kind or stream."""
    like = torch.zeros(1024)
    dev = kernels.dev_scalars(7, 11, device="cpu")
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.philox_draw(like, dev, kind="uniform",
                            stream=kernels.STREAM_MC_DROPOUT)
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="kind"):
        fused.draw_(like, kind="gumbel", stream=kernels.STREAM_VI)
    with pytest.raises(ValueError, match="stream"):
        fused.draw_(like, kind="normal", stream=0)
    with pytest.raises(ValueError, match="kind"):
        fused.philox_draw_plain(8, kind="gumbel", stream=3, seed=0, step=0)


# ---- the kernel's fp32 Box-Muller ---------------------------------------------

# bounds over every input of the kernel's fp32 Box-Muller against float64:
# |r - r64| (r <= R_MAX) and |cos - cos64|, |sin - sin64|.  With the
# rounding of z = r cos (half an ulp, at most 2^-22 for |z| < 8) they give
# |z - z64| <= R_TOL + R_MAX * TRIG_TOL + 2^-22 = 9.3e-7 <= Z_TOL.
R_TOL = 3.6e-7
TRIG_TOL = 6.0e-8
Z_TOL = 1e-6
R_MAX = math.sqrt(-2.0 * math.log(float(np.float32(1e-7))))  # 5.678
CHUNK = 1 << 20  # 2^20 inputs at a time: well under 200 MB of temporaries
QUARTERS = range(4)  # each case covers a quarter of the 2^24 inputs


def _chunks(quarter):
    lo = quarter << 22
    for start in range(lo, lo + (1 << 22), CHUNK):
        yield torch.arange(start, start + CHUNK, dtype=torch.int64)


def _r64(k):
    u1 = torch.clamp(k.double() / 2**24, min=float(np.float32(1e-7)))
    return torch.sqrt(-2.0 * torch.log(u1))


def _r32(k):
    return fused.sqrt_newton_fp32(fused.neg2_log_u1_fp32(k << 8))


def test_bounds_imply_the_normal_tolerance():
    assert R_TOL + R_MAX * TRIG_TOL + 2.0**-22 <= Z_TOL
    assert Z_TOL < 1e-5  # DRAW_TOL, the gate on the card


@pytest.mark.parametrize("quarter", QUARTERS)
def test_box_muller_radius_exhaustive(quarter):
    """r = sqrt(-2 ln u1) for every k in this quarter of [0, 2^24), the
    clamp at 1e-7 included, within R_TOL of float64; positive and finite."""
    worst = 0.0
    for k in _chunks(quarter):
        r = _r32(k)
        assert bool(torch.all(torch.isfinite(r) & (r > 0)))
        worst = max(worst, float((r.double() - _r64(k)).abs().max()))
    assert worst <= R_TOL, worst


@pytest.mark.parametrize("quarter", QUARTERS)
def test_box_muller_angle_exhaustive(quarter):
    """(cos, sin) of 2 pi m 2^-24 for every m in this quarter of [0, 2^24)
    within TRIG_TOL of float64."""
    worst = 0.0
    for m in _chunks(quarter):
        c, s = fused.cos_sin_2pi_fp32(m << 8)
        angle = 2.0 * np.pi * m.double() / 2**24
        worst = max(worst, float((c.double() - torch.cos(angle)).abs().max()),
                    float((s.double() - torch.sin(angle)).abs().max()))
    assert worst <= TRIG_TOL, worst


@pytest.mark.parametrize("k", [0, 1, 2, 2**24 - 1])
def test_box_muller_named_radii(k):
    """k = 0 and 1 take the clamp u1 = 1e-7 (the largest r, 5.678); k = 2
    is the first above it; at k = 2^24 - 1, u1 = 1 - 2^-24, r = 3.45e-4 is
    kept relative to its size (an absolute log error of 2^-22 would move it
    by about 5e-4)."""
    kt = torch.tensor([k])
    r, r64 = float(_r32(kt)), float(_r64(kt))
    assert abs(r - r64) <= R_TOL
    assert abs(r - r64) <= 2.0**-23 * r64
    if k < 2:
        assert r == float(_r32(torch.tensor([2 - k - 1 if k else 1])))
        assert abs(r64 - R_MAX) < 1e-12
    if k == 2**24 - 1:
        assert 3.4e-4 < r < 3.5e-4


def test_box_muller_octant_edges():
    """The angle at each octant edge m = o 2^21 (the reduction's quadrant
    edges, t = -1, and centres, t = 0) and at its neighbours, and the
    largest m: (cos, sin) within TRIG_TOL of float64, and z = r cos, r sin
    within Z_TOL of float64 at the largest r."""
    m = torch.tensor(sorted({min(max(o * 2**21 + d, 0), 2**24 - 1)
                             for o in range(9) for d in (-1, 0, 1)}))
    c, s = fused.cos_sin_2pi_fp32(m << 8)
    angle = 2.0 * np.pi * m.double() / 2**24
    assert float((c.double() - torch.cos(angle)).abs().max()) <= TRIG_TOL
    assert float((s.double() - torch.sin(angle)).abs().max()) <= TRIG_TOL
    b1 = torch.zeros_like(m)  # k = 0: u1 clamped, r = 5.678
    z0, z1 = fused.box_muller_fp32(b1, m << 8)
    r64 = _r64(b1)
    assert float((z0.double() - r64 * torch.cos(angle)).abs().max()) <= Z_TOL
    assert float((z1.double() - r64 * torch.sin(angle)).abs().max()) <= Z_TOL


def test_fma32_rounds_once():
    """_fma32 against the exact a * b + c rounded to fp32 (Fraction), on
    inputs whose product and sum straddle fp32 ties."""
    g = np.random.default_rng(0)
    a = g.standard_normal(4000).astype(np.float32)
    b = g.standard_normal(4000).astype(np.float32)
    # c near -a*b, so the sum cancels and rounding ties matter
    c = (-(a.astype(np.float64) * b) * (1 + g.standard_normal(4000) * 1e-6)
         ).astype(np.float32)
    got = fused._fma32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()

    def rn32(x: Fraction) -> np.float32:
        lo = np.float32(float(x))  # within an ulp; step to the nearest
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(v)) - x) for v in cands]
        best = min(errs)
        ties = [v for v, e in zip(cands, errs) if e == best]
        return min(ties, key=lambda v: int(np.float32(v).view(np.int32)) & 1)

    want = np.array([rn32(Fraction(float(x)) * Fraction(float(y))
                          + Fraction(float(z))) for x, y, z in zip(a, b, c)],
                    dtype=np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_box_muller_constants_match_the_header():
    """The emulation's coefficients are the header's, in its order."""
    text = (kernels.CSRC / "normal_from_bits.cuh").read_text()
    body = text[text.index("float neg2_log_u1("):text.index("void box_muller(")]
    consts = [float.fromhex(h) for h in
              re.findall(r"(-?0x[0-9a-f.]+p[-+]?\d+)f", body)]
    want = [fused.V_MIN, *fused.NEG2_LOG1P_P, fused.NEG2_LN2, *fused.COS_Q,
            *fused.SIN_S, fused.PI_4]
    # the header also writes 1.5 2^23 (the float conversion) and 2^-21
    others = [c for c in consts if abs(c) not in (float.fromhex("0x1.8p+23"),
                                                  2.0**-21)]
    assert others == want


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_plain_fp32_draw_matches_float64(kind):
    """The draw with the kernel's fp32 arithmetic: uniforms the same bits,
    normals within Z_TOL of the float64 version (which rounds once more)."""
    kw = dict(kind=kind, stream=kernels.STREAM_ADAM, seed=SEED, step=STEP,
              offset=4096)
    a = fused.philox_draw_plain(1 << 16, fp32=True, **kw)
    b = fused.philox_draw_plain(1 << 16, **kw)
    assert a.dtype == torch.float32 and a.shape == b.shape
    if kind == "uniform":
        assert torch.equal(a, b)
    else:
        err = float((a - b).abs().max())
        assert 0 < err <= Z_TOL + 2.0**-22, err
