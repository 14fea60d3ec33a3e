"""The port's cSGHMC runner against the JAX package's on the same data and
the same initial θ (nd = 0, so no noise is drawn and the two agree up to
fp32 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesdll_tpu.methods import get_runner_cls as j_get_runner_cls
from bayesdll_tpu_torch import interop
from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.models import create_backbone
from tests.helpers import tiny_setup

HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.0", "thin": "2",
      "bias": "informative", "nst": "0", "momentum_decay": "0.05"}
N_TEST = 256


def _pair(hparams=HP, *, epochs=2, num_cycles=2, lr=2e-2, width=32, depth=2,
          n_train=512, batch_size=64, seed=0):
    """JAX and port runners on the same data, both starting from JAX's θ."""
    jcfg, jtarget, jtheta, jns, *jloaders = tiny_setup(
        "csghmc", dict(hparams), epochs=epochs, lr=lr, width=width,
        depth=depth, n_train=n_train, batch_size=batch_size, seed=seed,
        num_cycles=num_cycles)
    cfg = Config(method="csghmc", hparams=dict(hparams), dataset="synthetic",
                 backbone="mlp_mnist", epochs=epochs, batch_size=batch_size,
                 lr=lr, seed=seed, val_heldout=0.15, num_cycles=num_cycles,
                 device="cpu")
    cfg.synthetic_n_train = n_train
    cfg.synthetic_n_test = N_TEST
    *loaders, nd = prepare(cfg)
    model, _, _ = create_backbone("mlp_mnist", width=width, depth=depth)
    target, theta, ns = interop.target_from_arrays(
        np.asarray(jtheta), np.asarray(jtarget.theta0),
        np.asarray(jtarget.is_head), np.asarray(jtarget.is_bias),
        model=model, nd_size=nd, num_classes=cfg.num_classes,
        device="cpu")
    assert nd == jtarget.nd_size
    jrunner = j_get_runner_cls("csghmc")(jtarget, jtheta, jns, jcfg)
    trunner = get_runner_cls("csghmc")(target, theta, ns, cfg)
    return jrunner, trunner, jloaders, loaders


def test_five_steps_match_jax():
    jr, tr, jl, tl = _pair()
    jr._ensure_sched(len(jl[0]))
    tr._ensure_sched(len(tl[0]))
    collected = 0
    for step, ((jx, jy, _), (tx, ty, _)) in enumerate(zip(jl[0], tl[0])):
        if step == 5:
            break
        np.testing.assert_array_equal(jx, tx)
        sc = jr.step_scalars(0)
        assert tr.step_scalars(0) == sc
        collected += sc["collect"]
        key = jax.random.fold_in(jr.train_key, jr.bi)
        jr.state, jr.net_state, (jloss, _) = jr._jit_step(
            jr.target, jr.state, jr.net_state, jnp.asarray(jx),
            jnp.asarray(jy), key, sc)
        jr.bi += 1
        tloss, _ = tr._one_step(0, tx, ty)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert collected > 0  # the moments were updated on both sides
    np.testing.assert_allclose(tr.state.theta.numpy(),
                               np.asarray(jr.state.theta), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr.state.v.numpy(), np.asarray(jr.state.v),
                               rtol=1e-4, atol=1e-5)
    assert tr.state.moments.n == int(jr.state.moments.n)
    np.testing.assert_allclose(tr.state.moments.mean.numpy(),
                               np.asarray(jr.state.moments.mean),
                               rtol=1e-4, atol=1e-5)


def test_train_end_to_end_matches_jax():
    jr, tr, jl, tl = _pair()
    jres = jr.train(*jl)
    tres = tr.train(*tl)
    for key in ("nll", "ece", "test_loss"):
        assert abs(tres[key] - jres[key]) < 1e-3, key
    assert abs(tres["test_err"] - jres["test_err"]) <= 2 / N_TEST
    assert tres["best_epoch"] == jres["best_epoch"]
    assert sorted(tr.cycle_stats) == sorted(jr.cycle_stats) == [1, 2]
    for c in tr.cycle_stats:
        assert tr.cycle_stats[c]["n"] == jr.cycle_stats[c]["n"]
        np.testing.assert_allclose(tr.cycle_stats[c]["likelihoods"],
                                   jr.cycle_stats[c]["likelihoods"],
                                   rtol=1e-4)
    assert np.all(np.isfinite(tres["train_losses"]))


def test_equal_likelihoods_give_equal_gmm_weights():
    jr, tr, _, _ = _pair()
    rng = np.random.RandomState(0)
    stats = {c: {"likelihoods": rng.uniform(0.05, 0.5, size=3)}
             for c in (1, 2, 3)}
    jr.cycle_stats, tr.cycle_stats = stats, stats
    jw, tw = jr.gmm_weights(), tr.gmm_weights()
    assert jw.keys() == tw.keys()
    for c in jw:
        assert tw[c] == pytest.approx(jw[c], rel=1e-12)
    assert sum(tw.values()) == pytest.approx(1.0)
