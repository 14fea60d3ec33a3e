"""The port's plain cSGHMC update against the JAX package's XLA and Pallas
versions (Pallas in interpret mode, as tests/test_pallas_kernels.py runs
it), its noise against the closed form, and the dispatcher's CPU path.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesdll_tpu.ops import fused as jfused
from bayesdll_tpu_torch.ops import fused, kernels

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


def test_kernel_wrapper_refuses_cpu_tensors():
    g, theta, v, lr = _torch(*_vecs(64))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.csghmc_update(g, theta, v, lr, prior_sig=1.0, alpha=0.05,
                              noise_pref=0.0, gate=False, seed=0, step=0)
    assert kernels.csghmc_update.launches == 0


def test_kernel_library_name_tracks_its_sources():
    path = kernels.library_path("csghmc_update")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libcsghmc_update-") and path.suffix == ".so"
    assert kernels.library_path("csghmc_update") == path
    assert {p.name for p in kernels.CSRC.glob("*.cu")} == \
        {f"{k}.cu" for k in kernels.KERNELS}


def test_noise_prefactor():
    assert kernels.noise_prefactor(1.0, 0.05, 1000.0) == \
        pytest.approx(np.sqrt(0.1) / 1000.0)
