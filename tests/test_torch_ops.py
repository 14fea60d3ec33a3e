"""The port's plain cSGHMC update against the JAX package's XLA and Pallas
versions (Pallas in interpret mode, as tests/test_pallas_kernels.py runs
it), its noise against the closed form, and the dispatcher's CPU path.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against the plain version there.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesdll_tpu.ops import fused as jfused
from bayesdll_tpu_torch.ops import fused, kernels, window_attention

TOL = dict(rtol=1e-6, atol=1e-6)  # the tolerance of tests/test_pallas_kernels.py


def _vecs(dim, seed=0, head=None):
    rng = np.random.RandomState(seed)
    g, theta, v = (rng.randn(dim).astype(np.float32) for _ in range(3))
    lr = np.full(dim, 0.01, np.float32)
    if head is not None:
        lr[:head] = 0.05  # head-scaled lr, as cyclical_lr_vec builds it
    return g, theta, v, lr


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


KW = dict(prior_sig=0.5, n_eff=1000.0, alpha=0.05)


@pytest.mark.parametrize("dim,head", [(3000, None), (3001, 10), (4097, 100)])
@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_deterministic_matches_jax(dim, head, path):
    g, theta, v, lr = _vecs(dim, seed=dim, head=head)
    if path == "xla":
        jth, jv = jfused.csghmc_update(
            jnp.asarray(g), jnp.asarray(theta), jnp.asarray(v),
            jax.random.PRNGKey(0), nd=0.0, lr=jnp.asarray(lr),
            should_sample=True, **KW)
    else:
        from jax.experimental.pallas import tpu as pltpu
        from bayesdll_tpu.ops import pallas_kernels
        with pltpu.force_tpu_interpret_mode():
            jth, jv = pallas_kernels.csghmc_update(
                jnp.asarray(g), jnp.asarray(theta), jnp.asarray(v),
                jax.random.PRNGKey(0), nd=0.0, lr=jnp.asarray(lr),
                should_sample=True, **KW)
    tg, tth, tv, tlr = _torch(g, theta, v, lr)
    th_new, v_new = fused.csghmc_update(tg, tth, tv, nd=0.0, lr=tlr,
                                        should_sample=True, **KW)
    np.testing.assert_allclose(th_new.numpy(), np.asarray(jth), **TOL)
    np.testing.assert_allclose(v_new.numpy(), np.asarray(jv), **TOL)


def test_gate_off_injects_no_noise():
    g, theta, v, lr = _torch(*_vecs(5000, head=50))
    quiet = fused.csghmc_update(g, theta, v, nd=0.0, lr=lr,
                                should_sample=True, **KW)
    gated = fused.csghmc_update(g, theta, v, nd=1.0, lr=lr,
                                should_sample=False, **KW)
    for a, b in zip(quiet, gated):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lr_value", [0.01, 0.002])
def test_noise_statistics_match_closed_form(lr_value):
    dim = 200_000
    z = torch.zeros(dim)
    lr = torch.full((dim,), lr_value)
    gen = torch.Generator().manual_seed(3)
    nd, alpha, n_eff = 1.0, 0.05, 1000.0
    _, v_new = fused.csghmc_update(z, z, z, prior_sig=1.0, n_eff=n_eff,
                                   nd=nd, alpha=alpha, lr=lr,
                                   should_sample=True, generator=gen)
    out = v_new.numpy().astype(np.float64)
    expect_std = nd * np.sqrt(2.0 * alpha * lr_value) / n_eff
    assert abs(out.mean()) < 4 * expect_std / np.sqrt(dim)
    assert abs(out.std() - expect_std) / expect_std < 0.02


def test_given_noise_is_used():
    g, theta, v, lr = _torch(*_vecs(1000))
    noise = torch.from_numpy(np.random.RandomState(1).randn(1000).astype(np.float32))
    # nd large enough that the injected term is far above the fp32 rounding
    # of v (|v| ~ 1, ulp ~ 1e-7), which the difference below cancels
    th_new, v_new = fused.csghmc_update(g, theta, v, nd=1e3, lr=lr,
                                        should_sample=True, noise=noise, **KW)
    base = fused.csghmc_update(g, theta, v, nd=0.0, lr=lr,
                               should_sample=True, **KW)[1]
    want = 1e3 * torch.sqrt(2.0 * KW["alpha"] * lr) / KW["n_eff"] * noise
    np.testing.assert_allclose((v_new - base).numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-6)


def test_dispatcher_on_cpu_runs_the_plain_version_in_place():
    g, theta, v, lr = _torch(*_vecs(2048, head=10))
    before = kernels.csghmc_update.launches
    want_th, want_v = fused.csghmc_update(g, theta, v, nd=0.0, lr=lr,
                                          should_sample=True, **KW)
    th_ptr, v_ptr = theta.data_ptr(), v.data_ptr()
    out_th, out_v = fused.csghmc_update_(g, theta, v, nd=0.0, lr=lr,
                                         should_sample=True, seed=0, step=0,
                                         **KW)
    assert out_th.data_ptr() == th_ptr and out_v.data_ptr() == v_ptr
    assert torch.equal(theta, want_th) and torch.equal(v, want_v)
    assert kernels.csghmc_update.launches == before == 0


def test_dispatcher_noise_is_a_function_of_seed_and_step():
    def run(seed, step):
        g, theta, v, lr = _torch(*_vecs(4096))
        fused.csghmc_update_(g, theta, v, nd=1.0, lr=lr, should_sample=True,
                             seed=seed, step=step, **KW)
        return theta

    assert torch.equal(run(0, 5), run(0, 5))
    assert not torch.equal(run(0, 5), run(0, 6))
    assert not torch.equal(run(1, 5), run(0, 5))


def test_kernel_library_name_tracks_its_sources():
    path = kernels.library_path("csghmc_update")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libcsghmc_update-") and path.suffix == ".so"
    assert kernels.library_path("csghmc_update") == path
    # every source is a library the port builds: the update kernels' and
    # the window-attention kernels' (ops/window_attention.py)
    assert {p.name for p in kernels.CSRC.glob("*.cu")} == \
        {f"{k}.cu" for k in (*kernels.KERNELS, window_attention.LIBRARY)}


def test_noise_prefactor():
    assert kernels.noise_prefactor(1.0, 0.05, 1000.0) == \
        pytest.approx(np.sqrt(0.1) / 1000.0)


# ---- SGLD and SGHMC ---------------------------------------------------------

SG_KW = dict(prior_sig=1.5, n_eff=1000.0)


def _sg_vecs(dim, seed, head, uninformative):
    """g, theta, theta0, v, mask, lr as numpy fp32, lr head-scaled as
    FlatTarget.lr_vec builds it; the mask drops a random set of "bias"
    elements when uninformative."""
    rng = np.random.RandomState(seed)
    g, theta, theta0, v = (rng.randn(dim).astype(np.float32) for _ in range(4))
    mask = np.ones(dim, np.float32)
    if uninformative:
        mask[rng.rand(dim) < 0.3] = 0.0
    lr = np.full(dim, 0.01, np.float32)
    lr[:head] = 0.05
    return g, theta, theta0, v, mask, lr


def _jax_sg(name, path, arrays, **kw):
    """The JAX package's XLA or Pallas (interpret mode) version."""
    args = [jnp.asarray(a) for a in arrays]
    if path == "xla":
        return getattr(jfused, name)(*args, jax.random.PRNGKey(0), **kw)
    from jax.experimental.pallas import tpu as pltpu
    from bayesdll_tpu.ops import pallas_kernels
    with pltpu.force_tpu_interpret_mode():
        return getattr(pallas_kernels, name)(*args, jax.random.PRNGKey(0), **kw)


def _sg_port(name, arrays, **kw):
    out = getattr(fused, name)(*_torch(*arrays), **kw)
    return [t.numpy() for t in (out if isinstance(out, tuple) else (out,))]


def _sg_args(name, vecs):
    g, theta, theta0, v, mask, lr = vecs
    if name == "sgld_update":
        return (g, theta, theta0, mask, lr), {}
    return (g, theta, theta0, v, mask, lr), dict(alpha=0.05)


@pytest.mark.parametrize("uninformative", [False, True],
                         ids=["informative", "uninformative"])
@pytest.mark.parametrize("dim,head", [(3000, 10), (3001, 100), (4097, 1)])
@pytest.mark.parametrize("path", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["sgld_update", "sghmc_update"])
def test_sg_deterministic_matches_jax(name, path, dim, head, uninformative):
    arrays, kw = _sg_args(name, _sg_vecs(dim, dim, head, uninformative))
    want = _jax_sg(name, path, arrays, nd=0.0, **SG_KW, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = _sg_port(name, arrays, nd=0.0, **SG_KW, **kw)
    for a, b in zip(got, want):
        if path == "xla":  # the same operations in the same order
            np.testing.assert_array_equal(a, np.asarray(b))
        else:  # Pallas multiplies by a precomputed 1/sigma^2/N
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("name", ["sgld_update", "sghmc_update"])
def test_sg_zero_lr_stays_finite_like_pallas(name):
    vecs = list(_sg_vecs(4097, 5, 10, False))
    vecs[5][[0, 7, 4096]] = 0.0  # lr = 0 on a few elements
    arrays, kw = _sg_args(name, vecs)
    pallas = _jax_sg(name, "pallas", arrays, nd=0.0, **SG_KW, **kw)
    pallas = pallas if isinstance(pallas, tuple) else (pallas,)
    for a, b in zip(_sg_port(name, arrays, nd=0.0, **SG_KW, **kw), pallas):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    noisy = _sg_port(name, arrays, nd=1.0, **SG_KW, **kw,
                     generator=torch.Generator().manual_seed(0))
    assert all(np.all(np.isfinite(a)) for a in noisy)
    # the JAX package's default XLA path has no lr clamp: NaN there
    xla = _jax_sg(name, "xla", arrays, nd=0.0, **SG_KW, **kw)
    xla = np.asarray(xla if name == "sgld_update" else xla[1])
    assert np.isnan(xla[[0, 7, 4096]]).all() and np.isfinite(xla[1:7]).all()


@pytest.mark.parametrize("lr_value", [0.01, 0.002])
@pytest.mark.parametrize("name", ["sgld_update", "sghmc_update"])
def test_sg_noise_statistics_match_closed_form(name, lr_value):
    # mirrors tests/test_sgld.py and tests/test_sghmc.py
    dim, nd, alpha, sig, n_eff = 200_000, 1.5, 0.1, 2.0, 1000.0
    theta = torch.full((dim,), 2.0)
    z = torch.zeros(dim)
    lr = torch.full((dim,), lr_value)
    gen = torch.Generator().manual_seed(4)
    if name == "sgld_update":
        out = fused.sgld_update(z, theta, z, torch.ones(dim), lr,
                                prior_sig=sig, n_eff=n_eff, nd=nd,
                                generator=gen)
        mean = 2.0 / sig ** 2 / n_eff
        std = nd * np.sqrt(2.0 / (n_eff * lr_value))
    else:
        _, out = fused.sghmc_update(z, theta, z, z, torch.ones(dim), lr,
                                    prior_sig=sig, n_eff=n_eff, nd=nd,
                                    alpha=alpha, generator=gen)
        mean = lr_value * 2.0 / sig ** 2 / n_eff
        std = nd * np.sqrt(2.0 * alpha / (n_eff * lr_value))
    x = out.numpy().astype(np.float64)
    assert abs(x.mean() - mean) < 4 * std / np.sqrt(dim)
    assert abs(x.std() - std) / std < 0.02


@pytest.mark.parametrize("name", ["sgld_update", "sghmc_update"])
def test_sg_given_noise_is_used(name):
    vecs = _sg_vecs(1000, 1, 10, True)
    arrays, kw = _sg_args(name, vecs)
    noise = np.random.RandomState(2).randn(1000).astype(np.float32)
    nd, lr = 0.7, vecs[5].astype(np.float64)
    got = _sg_port(name, arrays, nd=nd, noise=torch.from_numpy(noise),
                   **SG_KW, **kw)[-1]
    base = _sg_port(name, arrays, nd=0.0, **SG_KW, **kw)[-1]
    a = 2.0 * kw.get("alpha", 1.0)
    want = nd * np.sqrt(a / (SG_KW["n_eff"] * lr)) * noise
    np.testing.assert_allclose(got - base, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["sgld_update", "sghmc_update"])
def test_sg_dispatcher_on_cpu_runs_the_plain_version_in_place(name):
    arrays, kw = _sg_args(name, _sg_vecs(2048, 3, 10, True))
    ts = _torch(*arrays)
    want = getattr(fused, name)(*ts, nd=0.0, **SG_KW, **kw)
    want = want if isinstance(want, tuple) else (want,)
    written = [ts[0]] if name == "sgld_update" else [ts[0], ts[3]]
    ptrs = [t.data_ptr() for t in written]
    out = getattr(fused, name + "_")(*ts, nd=0.0, seed=0, step=0, **SG_KW, **kw)
    out = out if isinstance(out, tuple) else (out,)
    assert [t.data_ptr() for t in out] == ptrs
    for t, w in zip(written, want):
        assert torch.equal(t, w)
    assert getattr(kernels, name).launches == 0


@pytest.mark.parametrize("name", ["sgld_update", "sghmc_update"])
def test_sg_dispatcher_noise_is_a_function_of_seed_and_step(name):
    def run(seed, step):
        arrays, kw = _sg_args(name, _sg_vecs(4096, 0, 10, False))
        ts = _torch(*arrays)
        getattr(fused, name + "_")(*ts, nd=1.0, seed=seed, step=step,
                                   **SG_KW, **kw)
        return ts[0]

    assert torch.equal(run(0, 5), run(0, 5))
    assert not torch.equal(run(0, 5), run(0, 6))
    assert not torch.equal(run(1, 5), run(0, 5))


def _kernel_call(name, dev, d=64):
    """`name`'s wrapper on CPU operands of length d and the row `dev`."""
    if name == "philox_draw":
        return lambda: kernels.philox_draw(torch.zeros(d), dev, kind="normal",
                                           stream=kernels.STREAM_VI)
    if name == "csghmc_update":
        g, theta, v, lr = _torch(*_vecs(d))
        return lambda: kernels.csghmc_update(g, theta, v, lr, dev,
                                             prior_sig=1.0, alpha=0.05,
                                             noise_pref=0.0)
    if name == "adam_sghmc_update":
        g, theta, theta0, v, mask, lr = _torch(*_sg_vecs(d, 0, 1, False))
        return lambda: kernels.adam_sghmc_update(
            g, theta, theta0, v, v.clone(), v.abs(), mask, lr,
            kernels.bias_row(0.1, 0.001, device="cpu"), dev, prior_sig=1.0,
            n_eff=1000.0, nd=0.0, alpha=0.05, beta1=0.9, beta2=0.999,
            eps_adam=1e-8, add_g=True, sgd_step=True)
    arrays, kw = _sg_args(name, _sg_vecs(d, 0, 1, False))
    return lambda: getattr(kernels, name)(*_torch(*arrays), dev, nd=0.0,
                                          **SG_KW, **kw)


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_kernel_wrapper_refuses_cpu_tensors(name):
    """Each kernel's one wrapper takes CUDA vectors and an int64 (seed,
    step, gate) row on their device: CPU tensors and a CPU row raise before
    any launch, and nothing is counted."""
    dev = kernels.dev_scalars(7, 11, True, device="cpu")
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        _kernel_call(name, dev)()
    with pytest.raises(ValueError, match="scalars on"):
        kernels._check_dev(dev, torch.zeros(64))
    assert kernels.launch_counts() == before


_C_KINDS = {"void*": "pointer", "int64_t": "int64", "float": "float",
            "int": "int", "uint32_t": "uint32", "uint64_t": "uint64"}
_CTYPES_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int64: "int64",
                 ctypes.c_float: "float", ctypes.c_int: "int",
                 ctypes.c_uint32: "uint32", ctypes.c_uint64: "uint64"}


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_kernel_argtypes_match_the_c_prototype(name):
    """ctypes passes arguments by the argtypes it is given and checks them
    against nothing: each `csrc/<name>.cu` exports one function, `<name>`,
    whose parameter kinds are those of `_ARGTYPES[name]`, in order."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    protos = re.findall(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)', src)
    assert len(re.findall(r'extern "C"', src)) == 1
    assert [p[0] for p in protos] == [name]
    kinds = []
    for param in protos[0][1].split(","):
        ctype = " ".join(param.split()[:-1]).replace("const ", "")
        kinds.append(_C_KINDS[ctype.replace(" *", "*")])
    assert kinds == [_CTYPES_KINDS[t] for t in kernels._ARGTYPES[name]]


def test_kernel_wrappers_refuse_overlapping_operands():
    buf = torch.zeros(4096)
    a, b, c = buf[:1024], buf[1024:2048], buf[512:1536]
    kernels._check_no_overlap(dict(g=a), dict(theta=b, lr=b))  # reads may share
    with pytest.raises(ValueError, match="g must not alias theta"):
        kernels._check_no_overlap(dict(g=a), dict(theta=c))
    with pytest.raises(ValueError, match="g must not alias v"):
        kernels._check_no_overlap(dict(g=b, v=c), dict(theta=buf[2048:3072]))
