"""The port's multi-chain workflow on the CPU, mirroring
tests/test_multichain_all_methods.py and the one-device tests of
tests/test_multichain_runner.py: all eleven methods on 1 and 2 chains with
their artifacts, per-chain GMM registries, Laplace's per-chain stage 2,
cSGHMC-FS's snapshots of every chain, chains that diverge, resume, the
eval draws' independence across chains, the cycle-start resets and the
CLI's --num_chains."""

import os
import pickle

import numpy as np
import pytest
import torch

from bayesdll_tpu_torch.cli.demo import make_reinit_fn
from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.data.loader import ArrayLoader
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.models import create_backbone
from bayesdll_tpu_torch.parallel import MultiChainRunner, MultiChainTrainer

# tests/test_multichain_all_methods.py's hparams
HPARAMS = {
    "vanilla": {"wd": "1e-4", "bias": "penalty"},
    "vi": {"prior_sig": "1.0", "kld": "1e-5", "bias": "informative",
           "nst": "2"},
    "mc_dropout": {"prior_sig": "1.0", "p_drop": "0.1", "kld": "1e-5",
                   "bias": "gaussian", "nst": "2"},
    "sgld": {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.05",
             "burnin": "1", "thin": "2", "bias": "informative", "nst": "2"},
    "sghmc": {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.05",
              "burnin": "1", "thin": "2", "bias": "informative", "nst": "2",
              "momentum_decay": "0.05"},
    "adam_sghmc": {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.05",
                   "burnin": "1", "thin": "2", "bias": "informative",
                   "nst": "2", "momentum_decay": "0.05", "beta1": "0.9",
                   "beta2": "0.999", "epsilon": "1e-8"},
    "csgld": {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.01",
              "thin": "2", "bias": "informative", "nst": "2"},
    "csghmc": {"prior_sig": "0.05", "Ninflate": "1.0", "nd": "0.001",
               "thin": "2", "bias": "informative", "nst": "2",
               "momentum_decay": "0.05"},
    "adam_csghmc": {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.01",
                    "thin": "2", "bias": "informative", "nst": "2",
                    "momentum_decay": "0.05", "beta1": "0.9",
                    "beta2": "0.999", "epsilon": "1e-8",
                    "temperature": "1.0", "perform_cold_restarts": "false"},
    "csghmc_fs": {"prior_sig": "0.05", "Ninflate": "1.0", "nd": "0.001",
                  "thin": "2", "bias": "informative", "nst": "2",
                  "momentum_decay": "0.05"},
    "la": {"prior_sig": "0.1", "Ninflate": "1.0", "bias": "informative",
           "nst": "2", "fisher_microbatch": "8"},
}
CYCLICAL = {"csgld", "csghmc", "adam_csghmc", "csghmc_fs"}
SGLD_HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.1", "burnin": "0",
           "thin": "2", "bias": "informative", "nst": "2"}
CSGHMC_HP = {"prior_sig": "0.05", "Ninflate": "1.0", "nd": "0.001",
             "thin": "2", "bias": "informative", "nst": "2",
             "momentum_decay": "0.05"}


@pytest.fixture(autouse=True)
def one_thread():
    """These runs are many small ops: one intra-op thread each keeps the
    test workers from crowding the cores (2-4x faster under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(method, hparams, *, epochs=2, lr=2e-2, num_cycles=2, width=16,
          n_train=192, batch_size=16, momentum=0.0, seed=0, workdir=None):
    """A port runner on the CPU at a small width, with the CLI's re-init
    function, and its loaders."""
    cfg = Config(method=method, hparams=dict(hparams), dataset="synthetic",
                 backbone="mlp_mnist", epochs=epochs, batch_size=batch_size,
                 lr=lr, momentum=momentum, num_cycles=num_cycles, seed=seed,
                 val_heldout=0.15, device="cpu")
    cfg.synthetic_n_train = n_train
    cfg.synthetic_n_test = 64
    *loaders, nd = prepare(cfg)
    model, _, _ = create_backbone("mlp_mnist", width=width, depth=2)
    target, theta, ns = make_flat_target(
        model, nd_size=nd, num_classes=cfg.num_classes,
        rng=torch.Generator().manual_seed(seed), device="cpu")
    runner = get_runner_cls(method)(target, theta, ns, cfg, workdir=workdir)
    if hasattr(runner, "set_reinit_fn"):
        runner.set_reinit_fn(make_reinit_fn(model, target, seed))
    return runner, loaders


def _run(method, n_chain, workdir):
    # cSGHMC-FS needs cycles of 2 epochs or more for its snapshot window
    epochs = 4 if method == "csghmc_fs" else 2
    runner, loaders = build(method, HPARAMS[method], epochs=epochs,
                            workdir=workdir)
    mc = MultiChainRunner(runner, n_chain, workdir=workdir)
    return mc, mc.train(*loaders)


@pytest.mark.parametrize("n_chain", [1, 2])
@pytest.mark.parametrize("method", sorted(HPARAMS))
def test_multichain_matrix(method, n_chain, tmp_path):
    mc, results = _run(method, n_chain, str(tmp_path))
    assert "nll" in results and "test_err" in results, results
    assert np.isfinite(results["nll"])
    assert os.path.exists(tmp_path / "logits_test.pkl")
    assert os.path.exists(tmp_path / "chains_ckpt.pkl")
    with open(tmp_path / "logits_test.pkl", "rb") as f:
        pack = pickle.load(f)
    assert pack["logits_all"].ndim == 3
    # the combined predictive carries chains x samples components
    assert pack["logits_all"].shape[1] % n_chain == 0
    thetas = mc.trainer.iterates()
    assert thetas.shape[0] == n_chain and bool(torch.isfinite(thetas).all())

    if method in CYCLICAL:
        assert len(mc.chain_cycle_stats) == n_chain
        for stats in mc.chain_cycle_stats:
            assert stats, "chain completed no cycle"
            for st in stats.values():
                assert st["n"] > 0
        for w in mc.gmm_weights_per_chain():
            assert sum(w.values()) == pytest.approx(1.0)
    if method == "la":
        means, vars_ = mc._la_stage2
        assert means.shape[0] == n_chain
        assert bool((vars_ > 0).all()) and float(vars_.max()) <= 0.1 ** 2
    if method == "csghmc_fs":
        chains_seen = {k[0] for k in mc.runner.full_samples}
        assert chains_seen == set(range(n_chain))
        for c in range(n_chain):
            assert os.path.exists(tmp_path / f"full_samples_net_chain{c}_ep0.pkl")
        assert "bma" in results
        assert np.isfinite(results["bma"]["test_ensemble_loss"])
    if n_chain > 1:  # the chains diverged
        assert float((thetas[0] - thetas[1]).abs().max()) > 1e-6


def test_multichain_sgld_full_workflow():
    """tests/test_multichain_runner.py:11: four SGLD chains collect moments
    after burn-in, learn the task and diverge."""
    runner, loaders = build("sgld", dict(SGLD_HP, burnin="1"), epochs=3)
    mc = MultiChainRunner(runner, 4)
    results = mc.train(*loaders)
    assert results["test_err"] < 0.6
    assert all(s.moments.cnt >= 1 for s in mc.trainer.states)
    means, vars_ = mc.trainer.chain_mean_vars()
    assert means.shape == vars_.shape == (4, runner.target.dim)
    for c, s in enumerate(mc.trainer.states):
        assert torch.equal(means[c], s.moments.mean_var()[0])
    thetas = mc.trainer.iterates()
    assert float((thetas[0] - thetas[1]).abs().max()) > 1e-5


def test_demo_cli_multichain(tmp_path):
    """tests/test_multichain_runner.py:32, on the CPU: the full-width MLP,
    two chains; --data_parallel without a process group to split the batch
    over raises."""
    from bayesdll_tpu_torch.cli import demo
    args = ["--method", "sgld", "--dataset", "synthetic", "--epochs", "1",
            "--batch_size", "256", "--lr", "2e-2", "--device", "cpu",
            "--log_dir", str(tmp_path), "--num_chains", "2", "--hparams",
            "prior_sig=1.0,Ninflate=1.0,nd=0.1,burnin=0,thin=2,"
            "bias=informative,nst=2"]
    results = demo.main(args)
    assert np.isfinite(results["nll"])
    ckpts = [p for p in tmp_path.rglob("chains_ckpt.pkl")]
    assert len(ckpts) == 1
    with pytest.raises(ValueError, match="launch with --multihost"):
        demo.main(args + ["--data_parallel", "2"])


# the JAX smoke matrix's hparams as CLI strings
CLI_HPARAMS = {m: ",".join(f"{k}={v}" for k, v in hp.items())
               for m, hp in HPARAMS.items()}


@pytest.mark.parametrize("method", sorted(HPARAMS))
def test_cli_every_method_two_chains(method, tmp_path, monkeypatch):
    """`python -m bayesdll_tpu_torch.cli.demo --num_chains 2 --device cpu`
    runs each method to its results and artifacts (the full-width MLP on
    a synthetic set cut to 300 training and 64 test examples)."""
    import bayesdll_tpu_torch.data as data
    from bayesdll_tpu_torch.cli import demo
    prepare_full = data.prepare

    def small(cfg):
        cfg.synthetic_n_train, cfg.synthetic_n_test = 300, 64
        return prepare_full(cfg)
    monkeypatch.setattr(data, "prepare", small)
    epochs = "4" if method == "csghmc_fs" else "2"
    results = demo.main([
        "--method", method, "--dataset", "synthetic", "--epochs", epochs,
        "--num_cycles", "2", "--batch_size", "64", "--lr", "2e-2",
        "--num_chains", "2", "--device", "cpu", "--log_dir", str(tmp_path),
        "--hparams", CLI_HPARAMS[method]])
    assert np.isfinite(results["nll"]) and "test_err" in results
    files = {p.name for p in tmp_path.rglob("*") if p.is_file()}
    assert {"chains_ckpt.pkl", "logits_test.pkl", "logits_val.pkl",
            "logs.txt"} <= files
    if method == "csghmc_fs":
        assert {"full_samples_net_chain0_ep0.pkl",
                "full_samples_net_chain1_ep0.pkl"} <= files
        assert np.isfinite(results["bma"]["test_ensemble_loss"])


def test_multichain_csghmc_gmm_workflow():
    """tests/test_multichain_runner.py:46: every chain completes both
    cycles, with likelihoods; per-chain GMM weights sum to 1."""
    runner, loaders = build("csghmc", CSGHMC_HP, epochs=4, lr=5e-2)
    mc = MultiChainRunner(runner, 4)
    results = mc.train(*loaders)
    assert len(mc.chain_cycle_stats) == 4
    for stats in mc.chain_cycle_stats:
        assert set(stats) == {1, 2}
        for st in stats.values():
            assert st["likelihoods"].shape == (2,)
            assert st["n"] > 0
    for wc in mc.gmm_weights_per_chain():
        assert abs(sum(wc.values()) - 1.0) < 1e-9
    assert results["test_err"] < 0.6


def test_multichain_artifact_protocol(tmp_path):
    """tests/test_multichain_runner.py:73: the single-chain artifact set,
    logits_all [N, chains x samples, K], temperature scaling."""
    runner, loaders = build("sgld", SGLD_HP)
    mc = MultiChainRunner(runner, 2, workdir=str(tmp_path))
    results = mc.train(*loaders)
    for fname in ("logits_val.pkl", "logits_test.pkl", "chains_ckpt.pkl"):
        assert os.path.exists(tmp_path / fname), fname
    with open(tmp_path / "logits_test.pkl", "rb") as f:
        pack = pickle.load(f)
    assert set(pack) == {"targets", "logits", "logits_all"}
    assert pack["logits_all"].shape[1] == 2 * 2  # 2 chains x nst=2
    assert {"ece", "nll", "topt", "best_epoch"} <= set(results)


@pytest.mark.parametrize("fused", [False, True], ids=["per_step", "fused"])
@pytest.mark.parametrize("backend,ckpt_name", [
    ("pickle", "chains_ckpt.pkl"), ("orbax", "chains_ckpt_orbax")])
@pytest.mark.parametrize("method,hp", [("sgld", SGLD_HP),
                                       ("csghmc", CSGHMC_HP)])
def test_multichain_resume_bit_identical(method, hp, backend, ckpt_name,
                                         fused, tmp_path):
    """tests/test_multichain_runner.py:106: a run resumed from
    chains_ckpt.pkl, or from the chains_ckpt_orbax directory
    (`ckpt_backend="orbax"`), per step or fused, continues exactly as the
    uninterrupted run; the chains' data orders depend on (chain, epoch)
    only.  cSGHMC's registry of its first cycle survives the checkpoint."""
    def fresh(epochs, name):
        runner, loaders = build(method, hp, epochs=epochs, num_cycles=epochs)
        runner.cfg.ckpt_backend = backend
        runner.cfg.fused_steps = fused
        return MultiChainRunner(runner, 2, workdir=str(tmp_path / name)), \
            loaders

    mc_full, loaders = fresh(2, "full")
    mc_full.train(*loaders)
    mc_a, loaders = fresh(1, "int")
    mc_a.train(*loaders)
    mc_b, loaders = fresh(2, "res")
    mc_b.runner.cfg.num_cycles = 2
    ep = mc_b.load_ckpt(str(tmp_path / "int" / ckpt_name))
    assert torch.equal(mc_b.trainer.iterates(), mc_a.trainer.iterates())
    mc_b.train(*loaders, start_epoch=ep + 1)
    assert torch.equal(mc_b.trainer.iterates(), mc_full.trainer.iterates())
    assert mc_b.trainer.bi == mc_full.trainer.bi
    for b, full in zip(mc_b.trainer.states, mc_full.trainer.states):
        if method == "csghmc":
            assert torch.equal(b.v, full.v)
        assert b.step == full.step
    if method == "csghmc":
        for a, b in zip(mc_b.chain_cycle_stats, mc_full.chain_cycle_stats):
            assert set(a) == set(b) == {1, 2}
            for cyc in a:
                for key in ("mean", "var", "likelihoods"):
                    np.testing.assert_array_equal(a[cyc][key], b[cyc][key])
                assert a[cyc]["n"] == b[cyc]["n"]


def test_multichain_many_chains_distinct():
    """tests/test_multichain_runner.py:229, on one card: four chains stay
    four distinct chains, each with its own seed."""
    runner, loaders = build("sgld", dict(SGLD_HP, burnin="1"))
    mc = MultiChainRunner(runner, 4)
    results = mc.train(*loaders)
    th = mc.trainer.iterates()
    assert th.shape[0] == 4 and len(set(mc.trainer.seeds)) == 4
    for a in range(4):
        for b in range(a + 1, 4):
            assert float((th[a] - th[b]).abs().max()) > 1e-6
    assert np.isfinite(results["nll"])


def test_gmm_eval_draws_independent_across_chains():
    """tests/test_multichain_runner.py:261: chain 1's draws at batch 0 are
    not chain 0's at batch 1 (nor at batch 0), and an eval repeats."""
    runner, _ = build("csghmc", dict(CSGHMC_HP, nst="4"))
    mc = MultiChainRunner(runner, 2)
    dim = runner.target.dim
    stats = {"mean": np.zeros(dim, np.float32),
             "var": np.full(dim, 0.25, np.float32),  # MC noise dominates
             "n": 2, "likelihoods": np.ones(4)}
    mc.chain_cycle_stats = [{1: dict(stats)}, {1: dict(stats)}]
    x = np.random.RandomState(0).randn(16, 784).astype(np.float32)
    loader = ArrayLoader(np.concatenate([x, x]), np.zeros(32, np.int32), 16)
    la = mc.evaluate(loader)[4]  # [32, 2 chains x 4 samples, K]
    chain0, chain1 = la[:, :4], la[:, 4:]
    assert np.abs(chain1[:16] - chain0[16:]).max() > 1e-6
    assert np.abs(chain1[:16] - chain0[:16]).max() > 1e-6
    np.testing.assert_array_equal(la, mc.evaluate(loader)[4])


@pytest.mark.parametrize("method,fields", [
    ("adam_csghmc", ("buf", "v_mom", "m", "v2")), ("csghmc_fs", ("v",))])
def test_multi_chain_cycle_start_resets(method, fields):
    """tests/test_multichain_runner.py:298: the per-cycle state is zeroed on
    every chain, and each chain's cold restart is drawn with its own seed."""
    hp = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.01", "thin": "2",
          "bias": "informative", "nst": "1", "momentum_decay": "0.05",
          "perform_cold_restarts": "1"}
    runner, _ = build(method, hp, epochs=6, num_cycles=3)
    trainer = MultiChainTrainer(runner, 2)
    for st in trainer.states:
        for f in fields:
            getattr(st, f).fill_(1.0)
    seen = []

    def reinit(cycle, seed=None):
        seen.append((cycle, seed))
        return torch.full((runner.target.dim,), 55.0)
    runner.set_reinit_fn(reinit)
    runner.multi_chain_cycle_start(trainer, 2)
    assert seen == [(2, s) for s in trainer.seeds]
    for st in trainer.states:
        for f in fields:
            assert float(getattr(st, f).abs().max()) == 0.0, (method, f)
        assert bool((st.theta == 55.0).all())
        assert getattr(st, "t", 0) == 0


def test_cold_restarts_differ_across_chains():
    """With the CLI's re-init function, the chains' fresh θ are the draws of
    single-chain runs with the chains' seeds: distinct."""
    hp = dict(HPARAMS["adam_csghmc"], perform_cold_restarts="1")
    runner, _ = build("adam_csghmc", hp)
    trainer = MultiChainTrainer(runner, 2)
    runner.multi_chain_cycle_start(trainer, 2)
    a, b = (s.theta for s in trainer.states)
    assert not torch.equal(a, b)
    assert torch.equal(a, runner._reinit_fn(2, seed=trainer.seeds[0]))


def test_multichain_la_stage2_uses_best_val_iterates():
    """tests/test_multichain_runner.py:337."""
    runner, loaders = build("la", {"prior_sig": "1.0", "Ninflate": "1.0",
                                   "bias": "informative", "nst": "2"},
                            epochs=3)
    mc = MultiChainRunner(runner, 2)
    mc.train(*loaders)
    losses, best_thetas, _ = mc._la_best
    assert losses.shape == (2,)
    means, vars_ = mc._la_stage2
    for c in range(2):
        assert torch.equal(means[c], best_thetas[c])
    assert len(mc.results["fisher_time_per_chain"]) == 2


def test_multichain_la_trains_without_loaders():
    """tests/test_multichain_runner.py:356: stage 2 falls back to the final
    iterates when no val or test loader tracked the best."""
    runner, loaders = build("la", {"prior_sig": "1.0", "Ninflate": "1.0",
                                   "bias": "informative", "nst": "2"})
    mc = MultiChainRunner(runner, 2)
    mc.train(loaders[0], None, None)
    assert mc._la_best is None
    means, _ = mc._la_stage2
    assert torch.equal(means, mc.trainer.iterates())


def test_zero_sample_cycle_likelihood_centers_on_iterate():
    """tests/test_multichain_runner.py:373, per chain: a cycle that
    collected nothing centres each chain's likelihood on its live iterate
    (nst = 1 and n = 0: no noise, exp(-mean CE) at the iterate)."""
    hp = dict(CSGHMC_HP, thin="100000", nst="1")
    runner, loaders = build("csghmc", hp, epochs=2, num_cycles=1)
    train = loaders[0]
    train.shuffle = False  # the same examples in both passes below
    mc = MultiChainRunner(runner, 2)
    mc._train_loader = train
    liks = mc._chain_likelihoods()
    for c, state in enumerate(mc.trainer.states):
        assert state.moments.n == 0
        tot, cnt = 0.0, 0.0
        for x, y, v in train:
            logits, _ = runner.target.forward(state.theta, {},
                                              torch.from_numpy(x))
            logp = torch.log_softmax(logits, -1)
            picked = logp.gather(1, torch.from_numpy(y).long()[:, None])[:, 0]
            tot += float(torch.sum(-picked * torch.from_numpy(v)))
            cnt += float(v.sum())
        np.testing.assert_allclose(liks[c], np.exp(-tot / cnt), rtol=1e-5)
    assert not np.allclose(liks[0], liks[1])


def test_chain_seeds_and_jitter():
    """Chain c's seed is a function of (seed, c) alone; its initial iterate
    is the runner's plus 0.01 of a normal draw from that seed."""
    runner, _ = build("vi", HPARAMS["vi"])
    trainer = MultiChainTrainer(runner, 3)
    assert trainer.seeds == [rng.chain_seed(0, c) for c in range(3)]
    for c, st in enumerate(trainer.states):
        z = torch.randn(runner.target.dim,
                        generator=rng.generator("cpu", trainer.seeds[c],
                                                rng.JITTER))
        assert torch.equal(st.m, runner.state.m + 0.01 * z)
        assert torch.equal(st.s_, runner.state.s_)
        assert st.m.data_ptr() != runner.state.m.data_ptr()
