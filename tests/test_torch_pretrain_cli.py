"""The slice as a whole: cSGHMC on a mini ResNet over a CIFAR-10 fixture,
each package through its own `prepare` (with the crop-and-flip
augmentation) and its own runner, from the same θ; the port's pretraining
CLI on CIFAR-10; and the argv rewriting of its demo_vision and demo_mnist
aliases (as tests/test_cli.py holds the JAX package's)."""

import jax
import numpy as np
import pytest
import torch

from bayesdll_tpu.config import Config as JConfig
from bayesdll_tpu.core.prior import make_flat_target as j_make_flat_target
from bayesdll_tpu.data import prepare as jprepare
from bayesdll_tpu.methods import get_runner_cls as j_get_runner_cls
from bayesdll_tpu.models.resnet import ResNet as JResNet
from bayesdll_tpu_torch import interop
from bayesdll_tpu_torch.cli import demo, demo_mnist, demo_vision, pretrain
from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.models.resnet import ResNet
from tests.test_torch_resnet import _assert_same_walk
from tests.torch_data_fixtures import write_cifar

STAGES = (1, 1, 1, 1)
HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.0", "thin": "2",
      "bias": "informative", "nst": "0", "momentum_decay": "0.05"}


@pytest.fixture
def one_thread():
    """The port's eager steps on one intra-op thread: xdist workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mini_resnet_csghmc_on_cifar10_matches_jax(tmp_path, one_thread):
    """2 epochs of cSGHMC at nd = 0 on 231 augmented training images (3
    steps of 64 an epoch), each package through its own prepare and
    runner.  Their batches are equal bit for bit
    (tests/test_torch_vision_data.py); the runs agree as the ResNet runner
    steps of tests/test_torch_resnet.py do: θ and v within 2% of the
    distance walked in norm, 99% of elements within rtol 1e-4, atol 1e-5
    (train-mode BatchNorm turns the convolutions' fp32 summation order into
    a few flipped ReLUs, so not every element agrees); the test NLL, which
    reads the running averages, within rtol 1e-4."""
    write_cifar(tmp_path, "cifar10", n_train=256, n_test=32, seed=0)
    kw = dict(method="csghmc", hparams=dict(HP), dataset="cifar10",
              backbone="resnet50", epochs=2, batch_size=64, lr=1e-3,
              momentum=0.9, num_cycles=1, seed=0, val_heldout=0.1,
              data_root=str(tmp_path))
    jcfg, cfg = JConfig(**kw), Config(device="cpu", **kw)
    jtrain, jval, jtest, jnd = jprepare(jcfg)
    train, val, test, nd = prepare(cfg)
    assert nd == jnd == 231 and cfg.num_classes == jcfg.num_classes == 10
    jt, jth, jns = j_make_flat_target(
        JResNet(stage_sizes=STAGES, num_classes=10), (32, 32, 3),
        nd_size=jnd, num_classes=10, rng=jax.random.PRNGKey(0),
        has_batch_stats=True)
    stats = jax.tree.map(np.asarray, jns["batch_stats"])
    tt, tth, tns = interop.target_from_arrays(
        np.asarray(jth), np.asarray(jt.theta0), np.asarray(jt.is_head),
        np.asarray(jt.is_bias), model=ResNet(STAGES, 10), nd_size=nd,
        num_classes=10, batch_stats=stats, device="cpu")
    jr = j_get_runner_cls("csghmc")(jt, jth, jns, jcfg)
    tr = get_runner_cls("csghmc")(tt, tth, tns, cfg)
    jres = jr.train(jtrain, jval, jtest)
    tres = tr.train(train, val, test)
    assert tr.bi == jr.bi == 6
    _assert_same_walk(tr.state.theta, jr.state.theta, jth, "theta")
    _assert_same_walk(tr.state.v, jr.state.v, 0 * jth, "v")
    assert np.isfinite(tres["train_losses"]).all()
    np.testing.assert_allclose(tres["nll"], jres["nll"], rtol=1e-4)


def test_pretrain_cli_cifar10_one_epoch(tmp_path):
    """The pretraining driver's defaults (cSGHMC, lr 0.1, momentum 0.9, the
    reference's hparams) for one epoch of full-width ResNet-50 on a CIFAR-10
    fixture, on the CPU."""
    write_cifar(tmp_path / "data", "cifar10", n_train=20, n_test=8, seed=1)
    results = pretrain.main([
        "--dataset", "cifar10", "--backbone", "resnet50", "--batch_size", "8",
        "--epochs", "1", "--num_cycles", "1", "--val_heldout", "0.2",
        "--data_root", str(tmp_path / "data"),
        "--log_dir", str(tmp_path / "runs"), "--device", "cpu"])
    assert len(results["train_losses"]) == 1
    assert np.isfinite(results["train_losses"]).all()
    logs = list((tmp_path / "runs").rglob("logs.txt"))
    assert len(logs) == 1
    text = logs[0].read_text()
    assert "'method': 'csghmc'" in text and "Ninflate=1e3" in text
    assert "dataset cifar10 prepared: ND=16, num_classes=10" in text


def test_pretrain_passes_its_flags_to_demo(monkeypatch):
    seen = []
    monkeypatch.setattr(demo, "main", lambda argv: seen.append(argv))
    pretrain.main(["--method", "sgld", "--lr_head", "0.5", "--fused_steps"])
    argv = seen[0]
    flags = dict(zip(argv[::2], argv[1::2]))
    assert flags["--hparams"] == pretrain.DEFAULT_HPARAMS["sgld"]
    assert (flags["--dataset"], flags["--backbone"]) == ("cifar100",
                                                         "resnet101")
    assert (flags["--lr"], flags["--lr_head"], flags["--momentum"]) == \
        ("0.1", "0.5", "0.9")
    assert flags["--device"] == "cuda" and argv[-1] == "--fused_steps"
    pretrain.main(["--device", "cpu", "--hparams", "wd=1e-4"])
    flags = dict(zip(seen[1][::2], seen[1][1::2]))
    assert flags["--device"] == "cpu" and flags["--hparams"] == "wd=1e-4"
    assert "--fused_steps" not in seen[1] and "--lr_head" not in seen[1]


def test_default_hparams_match_jax():
    from bayesdll_tpu.cli import pretrain as jpretrain
    assert pretrain.DEFAULT_HPARAMS == jpretrain.DEFAULT_HPARAMS


@pytest.mark.parametrize("alias,defaults", [
    (demo_vision, ("pets", "resnet101")), (demo_mnist, ("mnist", "mlp_mnist"))])
def test_alias_fills_in_only_missing_flags(monkeypatch, alias, defaults):
    seen = []
    monkeypatch.setattr(demo, "main", lambda argv: seen.append(argv))
    assert alias._has_flag(["--dataset=cifar10"], "--dataset")
    assert alias._has_flag(["--dataset", "cifar10"], "--dataset")
    assert not alias._has_flag(["--dataset_x", "y"], "--dataset")
    alias.main(["--method", "sgld"])
    assert seen[0] == ["--method", "sgld", "--dataset", defaults[0],
                       "--backbone", defaults[1]]
    alias.main(["--dataset=synthetic", "--backbone", "cnn_mnist"])
    assert seen[1] == ["--dataset=synthetic", "--backbone", "cnn_mnist"]


def test_demo_mnist_alias_respects_eq_form(tmp_path):
    """`--dataset=value` counts as given: the alias must not append its
    mnist default after it (argparse takes the last), so synthetic runs."""
    results = demo_mnist.main([
        "--dataset=synthetic", "--method", "sgld", "--epochs", "1",
        "--batch_size", "64", "--lr", "1e-2", "--log_dir", str(tmp_path),
        "--device", "cpu", "--hparams",
        "prior_sig=1.0,Ninflate=1.0,nd=0.1,burnin=0,thin=2,"
        "bias=informative,nst=2",
    ])
    assert "nll" in results
