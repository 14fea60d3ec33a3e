"""The port's SGLD, SGHMC and cSGLD runners against the JAX package's on the
same data and the same initial θ (nd = 0 and nst = 0, so no noise is drawn
and the two agree up to fp32 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesdll_tpu.methods import get_runner_cls as j_get_runner_cls
from bayesdll_tpu_torch import interop
from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core.moments import RunningMoments
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.models import create_backbone
from tests.helpers import tiny_setup

HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.0", "burnin": "1",
      "thin": "2", "bias": "informative", "nst": "0", "momentum_decay": "0.05"}
N_TEST = 256
TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(method, hparams=HP, *, momentum=0.0, epochs=2, lr=2e-2, width=32,
          depth=2, n_train=512, batch_size=64, seed=0, num_cycles=2):
    """JAX and port runners on the same data, both starting from JAX's θ."""
    jcfg, jtarget, jtheta, jns, *jloaders = tiny_setup(
        method, dict(hparams), epochs=epochs, lr=lr, width=width, depth=depth,
        n_train=n_train, batch_size=batch_size, seed=seed,
        num_cycles=num_cycles, momentum=momentum)
    cfg = Config(method=method, hparams=dict(hparams), dataset="synthetic",
                 backbone="mlp_mnist", epochs=epochs, batch_size=batch_size,
                 lr=lr, momentum=momentum, seed=seed, val_heldout=0.15,
                 num_cycles=num_cycles, device="cpu")
    cfg.synthetic_n_train = n_train
    cfg.synthetic_n_test = N_TEST
    *loaders, nd = prepare(cfg)
    model, _, _ = create_backbone("mlp_mnist", width=width, depth=depth)
    target, theta, ns = interop.target_from_arrays(
        np.asarray(jtheta), np.asarray(jtarget.theta0),
        np.asarray(jtarget.is_head), np.asarray(jtarget.is_bias),
        model=model, nd_size=nd, num_classes=cfg.num_classes, device="cpu")
    assert nd == jtarget.nd_size
    jrunner = j_get_runner_cls(method)(jtarget, jtheta, jns, jcfg)
    trunner = get_runner_cls(method)(target, theta, ns, cfg)
    return jrunner, trunner, jloaders, loaders


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _lockstep(jr, tr, jl, tl, ep, n, hand_draws=None):
    """n steps of both runners from epoch `ep` on the same batches, the
    losses within rtol 1e-5.  hand_draws(key, tr), when given, hands the
    port the draws the JAX step takes from `key`."""
    for step, ((jx, jy, _), (tx, ty, _)) in enumerate(zip(jl[0], tl[0])):
        if step == n:
            break
        np.testing.assert_array_equal(jx, tx)
        sc = jr.step_scalars(ep)
        assert tr.step_scalars(ep) == sc
        key = jax.random.fold_in(jr.train_key, jr.bi)
        if hand_draws is not None:
            hand_draws(key, tr)
        jr.state, jr.net_state, (jloss, _) = jr._jit_step(
            jr.target, jr.state, jr.net_state, jnp.asarray(jx),
            jnp.asarray(jy), key, sc)
        jr.bi += 1
        tloss, _ = tr._one_step(ep, tx, ty)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.5], ids=["mu0", "mu0.5"])
@pytest.mark.parametrize("method", ["sgld", "sghmc", "csgld"])
def test_five_steps_match_jax(method, momentum):
    jr, tr, jl, tl = _pair(method, momentum=momentum)
    if method == "csgld":
        jr._ensure_sched(len(jl[0]))
        tr._ensure_sched(len(tl[0]))
    ep = 1  # past burn-in: the moments collect on SGLD's and SGHMC's side
    jr.epoch_begin(ep)
    tr.epoch_begin(ep)
    _lockstep(jr, tr, jl, tl, ep, 5)
    assert tr.state.step == int(jr.state.step) == 5
    _close(tr.state.theta, jr.state.theta)
    if momentum:
        _close(tr.state.buf, jr.state.buf)
    if method == "sghmc":
        _close(tr.state.v, jr.state.v)
    assert tr.state.moments.cnt == int(jr.state.moments.cnt) > 0
    _close(tr.state.moments.mom1, jr.state.moments.mom1)
    _close(tr.state.moments.mom2, jr.state.moments.mom2)


@pytest.mark.parametrize("method", ["sgld", "sghmc"])
def test_train_across_burnin_matches_jax(method):
    jr, tr, jl, tl = _pair(method, momentum=0.5)
    jres = jr.train(*jl)
    tres = tr.train(*tl)
    for key in ("nll", "ece", "test_loss"):
        assert abs(tres[key] - jres[key]) < 1e-3, key
    assert abs(tres["test_err"] - jres["test_err"]) <= 2 / N_TEST
    assert tres["best_epoch"] == jres["best_epoch"] == 1  # evaluated after burn-in only
    assert tr.state.moments.cnt == int(jr.state.moments.cnt) > 1
    _close(tr.state.theta, jr.state.theta)
    assert np.all(np.isfinite(tres["train_losses"]))


def test_csgld_two_cycle_ends_match_jax():
    # each cycle end reads the RunningMoments count and resets the moments
    jr, tr, jl, tl = _pair("csgld", momentum=0.5)
    jres = jr.train(*jl)
    tres = tr.train(*tl)
    assert sorted(tr.cycle_stats) == sorted(jr.cycle_stats) == [1, 2]
    for c in tr.cycle_stats:
        assert tr.cycle_stats[c]["n"] == int(jr.cycle_stats[c]["n"]) > 0
        np.testing.assert_allclose(tr.cycle_stats[c]["mean"],
                                   jr.cycle_stats[c]["mean"], **TOL)
        np.testing.assert_allclose(tr.cycle_stats[c]["likelihoods"],
                                   jr.cycle_stats[c]["likelihoods"], rtol=1e-4)
    assert type(tr.state.moments) is RunningMoments
    assert tr.state.moments.cnt == 0  # reset at the last cycle end
    for key in ("nll", "ece", "test_loss"):
        assert abs(tres[key] - jres[key]) < 1e-3, key


def test_csgld_clip_grad_matches_jax():
    hp = dict(HP, nd="0.0", clip_grad="0.05")
    jr, tr, jl, tl = _pair("csgld", hp)
    jr._ensure_sched(len(jl[0]))
    tr._ensure_sched(len(tl[0]))
    for step, ((jx, jy, _), (tx, ty, _)) in enumerate(zip(jl[0], tl[0])):
        if step == 3:
            break
        sc = jr.step_scalars(0)
        key = jax.random.fold_in(jr.train_key, jr.bi)
        jr.state, jr.net_state, _ = jr._jit_step(
            jr.target, jr.state, jr.net_state, jnp.asarray(jx),
            jnp.asarray(jy), key, sc)
        jr.bi += 1
        tr._one_step(0, tx, ty)
    _close(tr.state.theta, jr.state.theta)


def test_cli_sghmc_with_momentum_on_cpu(tmp_path):
    from bayesdll_tpu_torch.cli import demo
    results = demo.main([
        "--method", "sghmc", "--dataset", "synthetic", "--epochs", "1",
        "--batch_size", "256", "--momentum", "0.5", "--device", "cpu",
        "--log_dir", str(tmp_path),
        "--hparams", "prior_sig=1.0,nd=1.0,burnin=0,thin=2,nst=2"])
    assert np.isfinite(results["nll"]) and "ece" in results
    run_dirs = list(tmp_path.glob("*/*/*/*_mo0.5/*"))
    assert len(run_dirs) == 1 and (run_dirs[0] / "ckpt.pkl").exists()
