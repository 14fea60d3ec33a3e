"""The fused multi-step path on two chains (parallel/chains.py), on the CPU:
each chain's fused run bit for bit (torch.equal) equal to the per-step
two-chain run, noise on, for all eleven methods
(tests/test_multichain_runner.py:176 and :195, fused against per-batch,
for sgld and csghmc, extended to the eleven), host counts (Adam's t
included) equal; and a chain's fused run equal to the single-chain fused
run from its start, batches and seed."""

import numpy as np
import pytest
import torch

from bayesdll_tpu_torch.parallel import MultiChainRunner
from tests.test_torch_fused_steps import (FUSED, host_counts, hparams,
                                          state_tensors)
from tests.test_torch_multichain_runner import (  # noqa: F401
    HPARAMS, build, one_thread)

N_CHAIN = 2


def two_chains(method, fused_steps, *, epochs=None, num_cycles=2,
               batch_size=16):
    epochs = epochs or (4 if method == "csghmc_fs" else 2)
    runner, loaders = build(method, hparams(method), epochs=epochs,
                            num_cycles=num_cycles, batch_size=batch_size,
                            momentum=0.5)
    runner.cfg.fused_steps = fused_steps
    mc = MultiChainRunner(runner, N_CHAIN)
    return mc, mc.train(*loaders)


@pytest.mark.parametrize("method", FUSED)
def test_two_chains_fused_equals_per_step(method):
    a, res_a = two_chains(method, False)
    b, res_b = two_chains(method, True)
    assert a.trainer.bi == b.trainer.bi
    for sa, sb in zip(a.trainer.states, b.trainer.states):
        ta, tb = state_tensors(sa), state_tensors(sb)
        for name in ta:
            assert torch.equal(ta[name], tb[name]), name
        assert host_counts(sa) == host_counts(sb)
    assert res_a["train_losses"] == res_b["train_losses"]
    assert res_a["train_errors"] == res_b["train_errors"]
    assert res_a["nll"] == res_b["nll"]
    for ca, cb in zip(a.chain_cycle_stats, b.chain_cycle_stats):
        assert ca.keys() == cb.keys()
        for cyc in ca:
            for k, v in ca[cyc].items():
                np.testing.assert_array_equal(v, cb[cyc][k], err_msg=k)
    # each chain has its own graph slot: its own buffers and seed row
    assert set(b.runner._step_graphs) == set(b.trainer.seeds)


@pytest.mark.parametrize("method", ["csgld", "csghmc"])
def test_two_chains_cycle_resets_inside_a_fused_epoch(method):
    """Four cycles in one epoch of 20 steps: the chains' cycle ends run at
    segment ends inside the epoch."""
    a, _ = two_chains(method, False, epochs=1, num_cycles=4, batch_size=8)
    b, _ = two_chains(method, True, epochs=1, num_cycles=4, batch_size=8)
    for sa, sb in zip(a.trainer.states, b.trainer.states):
        ta, tb = state_tensors(sa), state_tensors(sb)
        assert all(torch.equal(ta[n], tb[n]) for n in ta)
    assert all(sorted(s) == [1, 2, 3, 4] for s in b.chain_cycle_stats)


def test_fused_chain_is_its_single_chain_fused_run():
    """Chain c's fused steps are the single-chain fused run from the
    chain's initial state, on the chain's batches, under the chain's
    seed."""
    mc_runner, loaders = build("sghmc", HPARAMS["sghmc"], momentum=0.5)
    mc = MultiChainRunner(mc_runner, N_CHAIN)
    tr = mc.trainer
    starts = [s.theta.clone() for s in tr.states]
    its = tr._chain_iters(loaders[0], 1)
    batches = [[next(it) for it in its] for _ in range(len(loaders[0]))]
    xs = np.stack([[b[c][0] for c in range(N_CHAIN)] for b in batches])
    ys = np.stack([[b[c][1] for c in range(N_CHAIN)] for b in batches])
    tr._epoch_begin_chains(1)
    loss, err = tr.run_steps(1, xs, ys, 0)
    assert loss.shape == err.shape == (len(batches), N_CHAIN)
    for c in range(N_CHAIN):
        single, _ = build("sghmc", HPARAMS["sghmc"], momentum=0.5)
        single.state.theta.copy_(starts[c])
        single.seed = tr.seeds[c]
        single.epoch_begin(1)
        loss_c, err_c = single.run_steps(1, xs[:, c], ys[:, c], 0)
        assert torch.equal(loss_c, loss[:, c])
        assert torch.equal(err_c, err[:, c])
        ta, tb = state_tensors(single.state), state_tensors(tr.states[c])
        assert all(torch.equal(ta[n], tb[n]) for n in ta)
        assert single.state.step == tr.states[c].step and single.bi == tr.bi
