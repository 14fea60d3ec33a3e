"""The port's Adam-SGHMC and Adam-cSGHMC against the JAX package's: the Adam
update on the same eps as JAX draws, five steps at nd = 0 (no noise, so
the two agree up to fp32 rounding: rtol 1e-4, atol 1e-5), and Adam-cSGHMC's
per-cycle resets and cold restarts over three cycles."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesdll_tpu.ops import fused as jfused
from bayesdll_tpu_torch.ops import fused
from tests.test_torch_sgld import HP, _close, _lockstep, _pair

ADAM_HP = dict(HP, beta1="0.9", beta2="0.999", epsilon="1e-8")
ADAM_KW = dict(prior_sig=0.5, n_eff=1000.0, alpha=0.05, beta1=0.9,
               beta2=0.999, eps_adam=1e-8)


def _adam_inputs(n=4099, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda scale: (scale * rng.randn(n)).astype(np.float32)  # noqa: E731
    mask = (rng.rand(n) > 0.2).astype(np.float32)
    lr = np.where(rng.rand(n) > 0.9, 2e-3, 1e-3).astype(np.float32)
    return dict(g=f(0.1), theta=f(0.05), theta0=f(0.05), v_mom=f(1e-3),
                m=f(1e-2), v2=np.abs(f(1e-3)), mask=mask, lr=lr)


@pytest.mark.parametrize("t", [1, 7, 1000])
@pytest.mark.parametrize("nd", [0.0, 1.0])
def test_adam_update_matches_jax_on_the_same_noise(nd, t):
    a = _adam_inputs()
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, a["g"].shape, jnp.float32))
    j = jfused.adam_sghmc_update(
        *(jnp.asarray(a[k]) for k in ("g", "theta", "theta0", "v_mom", "m",
                                       "v2")),
        jnp.asarray(t, jnp.int32), jnp.asarray(a["mask"]),
        jnp.asarray(a["lr"]), key, nd=nd, **ADAM_KW)
    # the port writes v_mom, m and v2 in place: copies, so that the arrays
    # JAX reads (asynchronously) stay as they were
    tt = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    p = fused.adam_sghmc_update(
        tt["g"], tt["theta"], tt["theta0"], tt["v_mom"], tt["m"], tt["v2"], t,
        tt["mask"], tt["lr"], nd=nd, noise=torch.from_numpy(eps), **ADAM_KW)
    for got, want in zip(p, j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_adam_momentum_temperature_divides_the_data_gradient():
    """Adam-cSGHMC's grad_U = g/T + prior: JAX's update on g/T."""
    a = _adam_inputs(seed=1)
    key = jax.random.PRNGKey(0)
    temp = 3.0
    j = jfused.adam_sghmc_update(
        jnp.asarray(a["g"]) / temp,
        *(jnp.asarray(a[k]) for k in ("theta", "theta0", "v_mom", "m", "v2")),
        jnp.asarray(4, jnp.int32), jnp.asarray(a["mask"]),
        jnp.asarray(a["lr"]), key, nd=0.0, **ADAM_KW)
    # the port writes v_mom, m and v2 in place: copies, so that the arrays
    # JAX reads (asynchronously) stay as they were
    tt = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    p = fused.adam_sghmc_momentum(
        tt["g"], tt["theta"], tt["theta0"], tt["v_mom"], tt["m"], tt["v2"], 4,
        tt["mask"], tt["lr"], nd=0.0, temperature=temp, **ADAM_KW)
    for got, want in zip(p, j[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("momentum", [0.0, 0.5], ids=["mu0", "mu0.5"])
@pytest.mark.parametrize("method", ["adam_sghmc", "adam_csghmc"])
def test_five_adam_steps_match_jax(method, momentum):
    jr, tr, jl, tl = _pair(method, dict(ADAM_HP, temperature="2.0"),
                           momentum=momentum, lr=1e-3)
    ep = 1
    if method == "adam_csghmc":
        jr._ensure_sched(len(jl[0]))
        tr._ensure_sched(len(tl[0]))
    else:  # past burn-in: the moments collect
        jr.epoch_begin(ep)
        tr.epoch_begin(ep)
    _lockstep(jr, tr, jl, tl, ep, 5)
    assert tr.state.t == int(jr.state.t) == 5
    for name in ("theta", "v_mom", "m", "v2", "buf"):
        _close(getattr(tr.state, name), getattr(jr.state, name))
    assert tr.state.moments.cnt == int(jr.state.moments.cnt) > 0
    _close(tr.state.moments.mom1, jr.state.moments.mom1)


def test_adam_sghmc_train_and_checkpoint_match_jax(tmp_path):
    jr, tr, jl, tl = _pair("adam_sghmc", ADAM_HP, lr=1e-3)
    tr.workdir = str(tmp_path)
    jres = jr.train(*jl)
    tres = tr.train(*tl)
    _close(tr.state.theta, jr.state.theta)
    for key in ("nll", "test_loss"):
        assert abs(tres[key] - jres[key]) < 1e-3, key
    with open(tmp_path / "ckpt.pkl", "rb") as f:
        ck = pickle.load(f)
    assert (ck["beta1"], ck["beta2"], ck["epsilon"]) == (0.9, 0.999, 1e-8)
    assert set(ck["state"]) >= {"theta", "v_mom", "m", "v2", "t", "moments"}


def test_adam_csghmc_resets_and_three_cold_restarts_match_jax():
    """Three cycles of 2 epochs: at each of the three boundaries (the last
    included) the optimizer state is zeroed and θ re-drawn; mirrors
    tests/test_cyclical_methods.py::test_adam_csghmc_cold_restarts."""
    hp = dict(ADAM_HP, perform_cold_restarts="1", nst="0")
    jr, tr, jl, tl = _pair("adam_csghmc", hp, epochs=6, num_cycles=3,
                           lr=1e-3, momentum=0.5)
    marker = 0.0123
    restarts = {"jax": [], "port": []}
    jr.set_reinit_fn(lambda key: restarts["jax"].append(1)
                     or jnp.full_like(jr.state.theta, marker))
    tr.set_reinit_fn(lambda cycle: restarts["port"].append(cycle)
                     or torch.full_like(tr.state.theta, marker))
    jr.train(*jl)
    tr.train(*tl)
    assert restarts["port"] == [2, 3, 4] and len(restarts["jax"]) == 3
    assert tr.state.t == int(jr.state.t) == 0
    assert torch.equal(tr.state.theta, torch.full_like(tr.state.theta, marker))
    for name in ("buf", "v_mom", "m", "v2"):
        assert float(getattr(tr.state, name).abs().max()) == 0.0, name
    assert sorted(tr.cycle_stats) == sorted(jr.cycle_stats) == [1, 2, 3]
    for c in tr.cycle_stats:
        assert tr.cycle_stats[c]["n"] == int(jr.cycle_stats[c]["n"]) > 0
        np.testing.assert_allclose(tr.cycle_stats[c]["mean"],
                                   jr.cycle_stats[c]["mean"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(tr.cycle_stats[c]["likelihoods"],
                                   jr.cycle_stats[c]["likelihoods"], rtol=1e-4)
