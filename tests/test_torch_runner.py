"""Invariants of the port's cSGHMC runner on its own: the run_steps loop
equals the per-batch loop bit for bit, evaluation paths agree, checkpoints
round-trip, the moments switch, and the CLI runs on the CPU."""

import numpy as np
import pytest
import torch

from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core import moments as tmom
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.methods.base import BaseRunner
from bayesdll_tpu_torch.models import create_backbone

HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.0", "thin": "2",
      "bias": "informative", "nst": "0", "momentum_decay": "0.05"}
N_TEST = 256


def _runner(hparams=HP, seed=0):
    """A small port runner on the CPU and its (train, val, test) loaders."""
    cfg = Config(method="csghmc", hparams=dict(hparams), dataset="synthetic",
                 backbone="mlp_mnist", epochs=2, batch_size=64, lr=2e-2,
                 seed=seed, val_heldout=0.15, num_cycles=2, device="cpu")
    cfg.synthetic_n_train = 512
    cfg.synthetic_n_test = N_TEST
    *loaders, nd = prepare(cfg)
    model, _, _ = create_backbone("mlp_mnist", width=32, depth=2)
    target, theta, ns = make_flat_target(
        model, nd_size=nd, num_classes=cfg.num_classes,
        rng=torch.Generator().manual_seed(seed), device="cpu")
    return get_runner_cls("csghmc")(target, theta, ns, cfg), loaders


def _batches(loader, k):
    xs, ys = [], []
    for x, y, _ in loader:
        xs.append(x)
        ys.append(y)
    return np.stack(xs[:k]), np.stack(ys[:k])


def test_run_steps_equals_per_batch_loop():
    hp = dict(HP, nd="0.01", nst="2")
    ra, la = _runner(hp)
    rb, lb = _runner(hp)
    ra._ensure_sched(len(la[0]))
    rb._ensure_sched(len(lb[0]))
    k = 5  # inside the first cycle: no host hook would run in between
    xs, ys = _batches(la[0], k)
    losses = [ra._one_step(0, xs[i], ys[i])[0] for i in range(k)]
    loss_k, err_k = rb.run_steps(0, xs, ys, 0)
    assert rb.bi == ra.bi == k
    assert torch.equal(torch.stack(losses), loss_k)
    assert err_k.shape == (k,)
    for name in ("theta", "v"):
        assert torch.equal(getattr(ra.state, name), getattr(rb.state, name))
    assert torch.equal(ra.state.moments.m2, rb.state.moments.m2)


def test_generic_evaluate_agrees_with_point_evaluate():
    tr, tl = _runner()
    point = tr._point_evaluate(tl[2])
    mc = BaseRunner.evaluate(tr, tl[2])
    assert mc[0] == pytest.approx(point[0], rel=1e-6)
    assert mc[1] == point[1]
    np.testing.assert_array_equal(mc[2], point[2])
    assert mc[4].shape == point[4].shape == (N_TEST, 1, 10)


def test_checkpoint_roundtrip(tmp_path):
    tr, tl = _runner(dict(HP, nd="0.01"))
    tr.workdir = str(tmp_path)
    tr._ensure_sched(len(tl[0]))
    xs, ys = _batches(tl[0], 5)
    tr.run_steps(0, xs, ys, 0)
    path = tr.save_ckpt(0)
    fresh, _ = _runner(dict(HP, nd="0.01"))
    assert fresh.load_ckpt(path) == 0
    assert fresh.bi == tr.bi == 5
    assert fresh.state.step == tr.state.step
    for name in ("theta", "v"):
        assert torch.equal(getattr(fresh.state, name), getattr(tr.state, name))
    assert fresh.state.moments.n == tr.state.moments.n
    assert torch.equal(fresh.state.moments.mean, tr.state.moments.mean)


@pytest.mark.parametrize("quirks,cls", [
    ("", tmom.WelfordMoments),
    ("welford_count", tmom.RefWelfordMoments),
])
def test_moments_switch(monkeypatch, quirks, cls):
    monkeypatch.setenv("BAYESDLL_TPU_REF_QUIRKS", quirks)
    tr, _ = _runner()
    assert type(tr.state.moments) is cls


@pytest.mark.parametrize("has_matplotlib", [True, False])
def test_artifacts_with_and_without_matplotlib(monkeypatch, tmp_path,
                                               has_matplotlib):
    from bayesdll_tpu_torch.utils import calibration
    monkeypatch.setattr(calibration, "can_plot", lambda: has_matplotlib)
    tr, tl = _runner()
    tr.workdir = str(tmp_path)
    res = tr.train(*tl)
    assert np.isfinite(res["nll"])
    files = {p.name for p in tmp_path.iterdir()}
    assert {"ckpt.pkl", "logits_test.pkl", "logits_val.pkl"} <= files
    assert ("reliability_T1.png" in files) == has_matplotlib


def test_unported_names_raise():
    """A method and a backbone that neither package has raise: the method
    says it is not one of the JAX package's, the backbone points at the
    roadmap.  Every method of the JAX package has a runner."""
    from bayesdll_tpu_torch import methods
    with pytest.raises(NotImplementedError,
                       match="not a method of bayesdll_tpu"):
        get_runner_cls("hmc_nuts")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_backbone("vit_h_14")
    assert len(methods._METHODS) == 11
    for name in methods._METHODS:
        assert get_runner_cls(name).method_name == name


def test_cli_runs_on_cpu(tmp_path):
    from bayesdll_tpu_torch.cli import demo
    results = demo.main([
        "--method", "csghmc", "--dataset", "synthetic", "--epochs", "1",
        "--num_cycles", "1", "--batch_size", "256", "--device", "cpu",
        "--log_dir", str(tmp_path),
        "--hparams", "prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,nst=0"])
    assert np.isfinite(results["nll"]) and "ece" in results
