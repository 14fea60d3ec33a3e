"""The ResNet half of the port's models/convert.py against the JAX
package's (the ViT half is in tests/test_torch_vit.py), on a state_dict
with torchvision's ResNet key names built here and saved with
`torch.save`; `--pretrained` through the CLI; and the
synthetic data at ResNet-101's input shape against the JAX package's.

Every comparison is exact: the conversion only transposes and copies, and
both packages draw the synthetic data from the same numpy generator.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesdll_tpu.models.convert as jconvert
from bayesdll_tpu.config import Config as JConfig
from bayesdll_tpu.core import flat as jflat
from bayesdll_tpu.core.prior import make_flat_target as j_make_flat_target
from bayesdll_tpu.data import prepare as j_prepare
from bayesdll_tpu.models.resnet import ResNet as JResNet
from bayesdll_tpu_torch import models
from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core import flat as tflat
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.models import convert
from bayesdll_tpu_torch.models.resnet import ResNet

MINI = (1, 1, 1, 1)


def _torchvision_state_dict(stages=MINI, num_classes=1000, seed=0):
    """Random weights under torchvision's ResNet key names and layouts."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = rng.randn(o, i, k, k).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.randn(c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.randn(c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(7, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (n, w) in enumerate(zip(stages, (64, 128, 256, 512))):
        for bi in range(n):
            p = f"layer{li + 1}.{bi}"
            conv(f"{p}.conv1", w, cin, 1)
            bn(f"{p}.bn1", w)
            conv(f"{p}.conv2", w, w, 3)
            bn(f"{p}.bn2", w)
            conv(f"{p}.conv3", 4 * w, w, 1)
            bn(f"{p}.bn3", 4 * w)
            if bi == 0:
                conv(f"{p}.downsample.0", 4 * w, cin, 1)
                bn(f"{p}.downsample.1", 4 * w)
            cin = 4 * w
    sd["fc.weight"] = rng.randn(num_classes, 2048).astype(np.float32)
    sd["fc.bias"] = rng.randn(num_classes).astype(np.float32)
    return sd


def _assert_trees_equal(t, j):
    assert t.keys() == j.keys()
    for k in t:
        if isinstance(t[k], dict):
            _assert_trees_equal(t[k], j[k])
        else:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]),
                                          err_msg=k)


@pytest.fixture()
def mini_file(tmp_path, monkeypatch):
    """A saved mini state_dict that both packages' conversions know."""
    path = tmp_path / "mini.pth"
    torch.save({k: torch.from_numpy(v) for k, v in
                _torchvision_state_dict().items()}, path)
    arch = dict(kind="resnet", stage_sizes=MINI)
    monkeypatch.setitem(convert._ARCH, "resnet_mini", arch)
    monkeypatch.setattr(jconvert, "_ARCH", dict(jconvert._ARCH,
                                                resnet_mini=arch))
    return str(path)


@pytest.mark.parametrize("zero_head,num_classes", [
    (True, 7), (False, 1000), (False, 7)])
def test_params_and_stats_match_jax(zero_head, num_classes):
    sd = _torchvision_state_dict()
    tp, ts = convert.resnet_params_from_torch(sd, MINI, num_classes, zero_head)
    jp, js = jconvert.resnet_params_from_torch(sd, MINI, num_classes, zero_head)
    _assert_trees_equal(tp, jax.tree.map(np.asarray, jp))
    _assert_trees_equal(ts, jax.tree.map(np.asarray, js))
    np.testing.assert_array_equal(tflat.flatten_params(tp)[0].numpy(),
                                  np.asarray(jflat.flatten_params(jp)[0]))
    head_zero = not np.any(tp["head"]["kernel"])
    assert head_zero == (zero_head or num_classes != 1000)


def test_pretrained_prior_workhorse_and_stats_match_jax(mini_file):
    """θ0 (zeroed head), the workhorse θ (pretrained body, the given random
    head) and batch_stats from one saved file, in both packages."""
    jm = JResNet(stage_sizes=MINI, num_classes=7)
    jt, jth, _ = j_make_flat_target(jm, (32, 32, 3), nd_size=64,
                                    num_classes=7, rng=jax.random.PRNGKey(0),
                                    has_batch_stats=True, pad_to=1)
    jprior = jconvert.load_pretrained_params(mini_file, "resnet_mini", 7)
    tprior = convert.load_pretrained_params(mini_file, "resnet_mini", 7)
    theta0 = tflat.flatten_params(tprior)[0]
    np.testing.assert_array_equal(theta0.numpy(),
                                  np.asarray(jflat.flatten_params(jprior)[0]))

    # the port's target is padded to 1024; JAX's workhorse needs an
    # unpadded one (its flat prior has n_params elements)
    target, _, _ = make_flat_target(
        ResNet(MINI, 7), nd_size=64, num_classes=7,
        rng=torch.Generator().manual_seed(0), theta0_params=tprior,
        has_batch_stats=True, device="cpu")
    n = target.n_params
    assert n == jt.dim and target.dim % 1024 == 0 and target.dim > n
    np.testing.assert_array_equal(target.theta0[:n].numpy(), theta0.numpy())
    theta_init = torch.cat([torch.from_numpy(np.array(jth)),
                            torch.zeros(target.dim - n)])
    tw = convert.pretrained_workhorse_theta(mini_file, "resnet_mini", target,
                                            theta_init, num_classes=7)
    jw = jconvert.pretrained_workhorse_theta(mini_file, "resnet_mini", jt,
                                             jth, num_classes=7)
    np.testing.assert_array_equal(tw[:n].numpy(), np.asarray(jw))
    assert float(tw[n:].abs().sum()) == 0.0
    head = target.is_head.numpy()
    np.testing.assert_array_equal(tw.numpy()[head], theta_init.numpy()[head])
    assert np.any(tw.numpy()[head])  # the random head, not the zeroed one

    _assert_trees_equal(
        convert.load_pretrained_batch_stats(mini_file, "resnet_mini"),
        jax.tree.map(np.asarray, jconvert.load_pretrained_batch_stats(
            mini_file, "resnet_mini")))


def test_unported_and_missing_raise(tmp_path):
    """A backbone neither package converts raises; a missing file raises
    before anything is read."""
    with pytest.raises(NotImplementedError, match="vit_h_14"):
        convert.load_pretrained_params(str(tmp_path / "x.pth"), "vit_h_14", 10)
    with pytest.raises(NotImplementedError):
        jconvert.load_pretrained_params(str(tmp_path / "x.pth"), "vit_h_14",
                                        10)
    for name in ("resnet101", "vit_l_32"):
        with pytest.raises(FileNotFoundError):
            convert.load_pretrained_params(str(tmp_path / "x.pth"), name, 10)


def test_cli_pretrained_mini_resnet_on_cpu(mini_file, tmp_path, monkeypatch):
    """--pretrained through the CLI: the prior mean is the file's body with a
    zeroed head; the run starts from its body and a random head; the
    running statistics start fresh, as in the JAX package's CLI."""
    def resnet_mini(num_classes=10, **kw):
        return (ResNet(MINI, num_classes, dtype=kw.get("dtype", "float32")),
                (8, 8, 3), {"has_batch_stats": True, "has_dropout": False})
    monkeypatch.setitem(models._REGISTRY, "resnet_mini", resnet_mini)
    from bayesdll_tpu_torch.cli import demo
    built = {}
    build_all = demo.build_all

    def spy(cfg, logger, workdir=None):
        runner, loaders = build_all(cfg, logger, workdir=workdir)
        built["theta"] = runner.state.theta.clone()
        built["var"] = runner.net_state["batch_stats"]["layer2_0"]["bn1"][
            "var"].clone()
        built["runner"] = runner
        return runner, loaders
    monkeypatch.setattr(demo, "build_all", spy)
    results = demo.main([
        "--method", "csghmc", "--backbone", "resnet_mini",
        "--pretrained", mini_file, "--dataset", "synthetic", "--epochs", "1",
        "--num_cycles", "1", "--batch_size", "256", "--lr", "1e-4",
        "--device", "cpu", "--log_dir", str(tmp_path),
        "--hparams", "prior_sig=1.0,nd=1.0,thin=2,nst=0"])
    assert np.isfinite(results["nll"])
    target = built["runner"].target
    n = target.n_params
    prior = tflat.flatten_params(
        convert.load_pretrained_params(mini_file, "resnet_mini", 10))[0]
    np.testing.assert_array_equal(target.theta0[:n].numpy(), prior.numpy())
    body = ~target.is_head[:n]
    np.testing.assert_array_equal(built["theta"][:n][body].numpy(),
                                  prior[body].numpy())
    assert float(built["theta"][target.is_head].abs().sum()) > 0
    assert torch.equal(built["var"], torch.ones(128))  # not the file's
    assert list(tmp_path.glob("*/resnet_mini/*_pretr1/*/*"))


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def test_synthetic_resnet101_data_matches_jax():
    """The big-image rule: at batch 256 with 10% held out, 569 examples, of
    which 513 train (2 batches per epoch), and 256 test, array for array as the
    JAX package's prepare.  Compared by digest, one package at a time, to
    hold one copy of the 0.5 GB of images."""
    kw = dict(method="csghmc", dataset="synthetic", backbone="resnet101",
              batch_size=256, seed=0, num_classes=37)
    digests = []
    for cfg, prep in ((JConfig(**kw), j_prepare),
                      (Config(device="cpu", **kw), prepare)):
        train, val, test, nd = prep(cfg)
        assert nd == 513 and len(train) == 2 and cfg.num_classes == 37
        assert train.x.shape[1:] == (224, 224, 3)
        digests.append(_digest(train.x, train.y, val.x, val.y, test.x, test.y))
        del train, val, test
    assert digests[0] == digests[1]
