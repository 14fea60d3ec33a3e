"""A chain of a multi-chain run is a single-chain run: chain c equals, bit
for bit, the single-chain run that starts from chain c's initial state,
takes chain c's batches and has chain c's seed, with noise on.  And a
single-chain run draws what it drew before multi-chain runs came: every
generator it keys is the same, in the same order."""

import dataclasses
import hashlib
import json

import pytest
import torch

from bayesdll_tpu_torch.cli.demo import make_reinit_fn
from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.models import create_backbone
from bayesdll_tpu_torch.parallel import MultiChainRunner
from tests.test_torch_multichain_runner import build, one_thread  # noqa: F401


class ChainBatches:
    """Chain c's batches for a single-chain runner: in the epoch of the
    runner's step counter, `chain_view(c, epoch)` of the train loader."""

    def __init__(self, loader, c, runner):
        self.loader, self.c, self.runner = loader, c, runner
        self.batch_size = loader.batch_size

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        ep = self.runner.bi // len(self.loader)
        return iter(self.loader.chain_view(self.c, ep))


CASES = {
    "csghmc": ({"prior_sig": "0.05", "Ninflate": "1.0", "nd": "1.0",
                "thin": "2", "bias": "informative", "nst": "2",
                "momentum_decay": "0.05"}, 0.0, ("theta", "v")),
    "sghmc": ({"prior_sig": "1.0", "Ninflate": "1.0", "nd": "1.0",
               "burnin": "1", "thin": "2", "bias": "informative", "nst": "2",
               "momentum_decay": "0.05"}, 0.5, ("theta", "buf", "v")),
    "adam_csghmc": ({"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.01",
                     "thin": "2", "bias": "informative", "nst": "2",
                     "perform_cold_restarts": "1"}, 0.0,
                    ("theta", "buf", "v_mom", "m", "v2")),
}


@pytest.mark.parametrize("method", sorted(CASES))
def test_chain_equals_single_chain_run(method):
    hp, momentum, fields = CASES[method]
    kw = dict(epochs=4, num_cycles=2, momentum=momentum)
    runner, loaders = build(method, hp, lr=1e-2, **kw)
    mc = MultiChainRunner(runner, 2)
    start = [runner.iterate(s).clone() for s in mc.trainer.states]
    mc.train(*loaders)
    for c in range(2):
        single, sl = build(method, hp, lr=1e-2, **kw)
        single.cfg = dataclasses.replace(single.cfg, seed=mc.trainer.seeds[c])
        single.seed = seed = single.cfg.seed
        if hasattr(single, "set_reinit_fn"):  # the CLI's, at the seed
            reinit = single._reinit_fn
            single.set_reinit_fn(lambda cycle: reinit(cycle, seed=seed))
        single.state = single.init_state(start[c].clone())
        single.train(ChainBatches(sl[0], c, single), *sl[1:])
        assert single.bi == mc.trainer.bi
        for f in fields:
            assert torch.equal(getattr(single.state, f),
                               getattr(mc.trainer.states[c], f)), (c, f)
    a, b = (s.theta for s in mc.trainer.states)
    assert not torch.equal(a, b)


# a single-chain run of each method (seed 3, width 16, 82 training
# examples, batch 16, noise on, nst 2, cold restarts where offered): the
# sha256 of the list of (device, *key) of every generator it keyed, and
# their count, as the runners drew before multi-chain runs came
STREAMS = {
    "vanilla": ("wd=1e-4,bias=penalty", "9054ce9bd7fe1f38", 6),
    "vi": ("prior_sig=1.0,kld=1e-5,bias=informative,nst=2",
           "ef8fcc494f712e1b", 16),
    "mc_dropout": ("prior_sig=1.0,p_drop=0.1,kld=1e-5,bias=gaussian,nst=2",
                   "fa91fea7e676536f", 16),
    "sgld": ("prior_sig=1.0,nd=0.05,burnin=1,thin=2,nst=2",
             "02b1b6dba3490d2d", 13),
    "sghmc": ("prior_sig=1.0,nd=0.05,burnin=1,thin=2,nst=2",
              "02b1b6dba3490d2d", 13),
    "adam_sghmc": ("prior_sig=1.0,nd=0.05,burnin=1,thin=2,nst=2",
                   "34eec410f7eb1955", 13),
    "csgld": ("prior_sig=1.0,nd=0.01,thin=2,nst=2", "43a4686a63469555", 19),
    "csghmc": ("prior_sig=0.05,nd=0.01,thin=2,nst=2", "43a4686a63469555", 19),
    "adam_csghmc": ("prior_sig=1.0,nd=0.01,thin=2,nst=2,"
                    "perform_cold_restarts=1", "2e480f3edce089b6", 21),
    "csghmc_fs": ("prior_sig=0.05,nd=0.01,thin=2,nst=2,"
                  "perform_cold_restarts=1", "c66a352f333a1469", 38),
    "la": ("prior_sig=1.0,nst=2,fisher_microbatch=8", "bcf09f7afe2c3992", 5),
}


@pytest.mark.parametrize("method", sorted(STREAMS))
def test_single_chain_streams_unchanged(method, monkeypatch):
    hp, digest, count = STREAMS[method]
    cfg = Config(method=method, hparams=hp, dataset="synthetic",
                 backbone="mlp_mnist", epochs=4 if method == "csghmc_fs" else 2,
                 batch_size=16, lr=2e-2, num_cycles=2, seed=3,
                 val_heldout=0.15, device="cpu")
    cfg.synthetic_n_train = 96
    cfg.synthetic_n_test = 32
    *loaders, nd = prepare(cfg)
    model, _, _ = create_backbone("mlp_mnist", width=16, depth=2)
    target, theta, ns = make_flat_target(
        model, nd_size=nd, num_classes=10,
        rng=torch.Generator().manual_seed(3), device="cpu")
    runner = get_runner_cls(method)(target, theta, ns, cfg)
    if hasattr(runner, "set_reinit_fn"):
        runner.set_reinit_fn(make_reinit_fn(model, target, cfg.seed))
    assert runner.seed == cfg.seed
    keys = []
    generator = rng.generator

    def recorded(device, *ints):
        keys.append([str(device)] + [int(i) for i in ints])
        return generator(device, *ints)
    monkeypatch.setattr(rng, "generator", recorded)
    runner.train(*loaders)
    assert len(keys) == count
    assert all(k[1] == cfg.seed for k in keys)
    assert hashlib.sha256(json.dumps(keys).encode()).hexdigest()[:16] == digest
