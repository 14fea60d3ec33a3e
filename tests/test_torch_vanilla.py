"""The port's vanilla (MAP) runner against the JAX package's in both bias
modes (five steps, θ within rtol 1e-4, atol 1e-5, losses within rtol
1e-5), and the CLI on the CPU for each method this slice ports."""

import numpy as np
import pytest

from tests.test_torch_sgld import _close, _lockstep, _pair


@pytest.mark.parametrize("momentum", [0.0, 0.5], ids=["mu0", "mu0.5"])
@pytest.mark.parametrize("bias", ["penalty", "ignore"])
def test_five_vanilla_steps_match_jax(bias, momentum):
    jr, tr, jl, tl = _pair("vanilla", {"wd": "0.05", "bias": bias},
                           momentum=momentum)
    _lockstep(jr, tr, jl, tl, 0, 5)
    assert tr.state.step == int(jr.state.step) == 5
    _close(tr.state.theta, jr.state.theta)
    _close(tr.state.buf, jr.state.buf)
    moved = (tr.state.theta - tr.target.theta0).abs()
    assert float(moved.max()) > 0


def test_vanilla_train_matches_jax():
    jr, tr, jl, tl = _pair("vanilla", {"wd": "1e-3", "bias": "penalty"},
                           momentum=0.5)
    jres = jr.train(*jl)
    tres = tr.train(*tl)
    _close(tr.state.theta, jr.state.theta)
    for key in ("nll", "ece", "test_loss"):
        assert abs(tres[key] - jres[key]) < 1e-3, key
    assert tres["best_epoch"] == jres["best_epoch"]


CLI_HPARAMS = {
    "vanilla": "wd=1e-4,bias=penalty",
    "vi": "prior_sig=1.0,kld=1e-5,bias=informative,nst=2",
    "mc_dropout": "prior_sig=1.0,p_drop=0.1,kld=1e-5,bias=gaussian,nst=2",
    "adam_sghmc": "prior_sig=1.0,nd=0.01,burnin=0,thin=2,nst=2",
    "adam_csghmc": "prior_sig=1.0,nd=0.01,thin=2,nst=2,perform_cold_restarts=1",
    "csghmc_fs": "prior_sig=0.05,nd=0.01,thin=2,nst=2",
    "la": "prior_sig=0.1,nst=2,fisher_microbatch=64",
}


@pytest.mark.parametrize("method", sorted(CLI_HPARAMS))
def test_cli_runs_each_new_method_on_cpu(tmp_path, monkeypatch, method):
    """The CLI end to end, with mlp_mnist cut to width 32 and depth 2 so
    that LA's Fisher over the 3,687 training examples stays short."""
    from bayesdll_tpu_torch import models
    from bayesdll_tpu_torch.cli import demo
    full = models.create_backbone
    monkeypatch.setattr(models, "create_backbone",
                        lambda name, **kw: full(name, width=32, depth=2, **kw))
    # cSGHMC-FS needs 4 epochs a cycle for a non-empty snapshot window
    epochs = "4" if method == "csghmc_fs" else "1"
    results = demo.main([
        "--method", method, "--dataset", "synthetic", "--epochs", epochs,
        "--num_cycles", "1", "--batch_size", "64", "--lr", "1e-3",
        "--device", "cpu", "--log_dir", str(tmp_path),
        "--hparams", CLI_HPARAMS[method]])
    assert np.isfinite(results["nll"]) and "ece" in results
    run_dir, = tmp_path.glob("*/*/*/*/*")
    files = {p.name for p in run_dir.iterdir()}
    assert "ckpt.pkl" in files
    if method == "csghmc_fs":
        assert "bma_evaluation_results.pkl" in files and "bma" in results
    if method == "la":
        assert results["fisher_time"] > 0
