"""The port's directory checkpoints (utils/checkpoint.py, the
`chains_ckpt_orbax` path of parallel/runner.py) on the CPU, mirroring
tests/test_orbax_ckpt.py: a sampler state's round trip with its counters,
the multi-chain round trip into a fresh runner, the checks made before a
tensor is read, a second save over a first, the fused path's captured
addresses across a load, and the JAX package's orbax resume against the
port's on the same chains."""

import os
import pickle

import numpy as np
import pytest
import torch

from bayesdll_tpu.parallel import make_mesh
from bayesdll_tpu.parallel.runner import MultiChainRunner as JMultiChainRunner
from bayesdll_tpu_torch import interop
from bayesdll_tpu_torch.parallel import MultiChainRunner
from bayesdll_tpu_torch.parallel import runner as runner_mod
from bayesdll_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_multichain import N_CHAIN, TOL
from tests.test_torch_multichain_runner import build, one_thread  # noqa: F401
from tests.test_torch_sgld import HP, _pair

SGHMC_HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.1", "burnin": "0",
            "thin": "1", "bias": "informative", "nst": "2",
            "momentum_decay": "0.05"}
# tests/test_orbax_ckpt.py:38
SGLD_HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.1", "burnin": "0",
           "thin": "2", "bias": "informative", "nst": "2"}


def _chains(workdir, n_chain=2, *, seed=0, epochs=1, fused=False):
    """tests/test_orbax_ckpt.py:44's run at width 16: SGLD on 2 chains,
    batch 32, 256 training examples, the directory backend."""
    runner, loaders = build("sgld", SGLD_HP, epochs=epochs, lr=1e-2,
                            n_train=256, batch_size=32, seed=seed,
                            workdir=workdir)
    runner.cfg.ckpt_backend = "orbax"
    runner.cfg.fused_steps = fused
    return MultiChainRunner(runner, n_chain, workdir=workdir), loaders


def test_state_roundtrip(tmp_path):
    """tests/test_orbax_ckpt.py:10: θ, v and the moments' count of an SGHMC
    state after an epoch, restored into a fresh state's own tensors."""
    runner, loaders = build("sghmc", SGHMC_HP, epochs=1, lr=1e-2,
                            batch_size=64)
    theta_init = runner.state.theta.clone()
    runner.epoch_begin(0)
    runner.train_one_epoch(0, loaders[0])
    state = runner.state
    assert state.moments.cnt > 1 and state.step > 1

    path = ckpt.save(str(tmp_path / "dcp_state"), state)
    assert path == os.path.abspath(tmp_path / "dcp_state")
    template = runner.init_state(theta_init)
    held = {f: getattr(template, f) for f in ("theta", "buf", "v")}
    restored = ckpt.restore(path, template)
    for f, t in held.items():
        assert getattr(restored, f) is t  # loaded in place
        assert torch.equal(t, getattr(state, f)), f
    assert restored.moments.mom1 is template.moments.mom1
    assert torch.equal(restored.moments.mom1, state.moments.mom1)
    assert torch.equal(restored.moments.mom2, state.moments.mom2)
    assert restored.moments.cnt == state.moments.cnt
    assert restored.step == state.step
    assert ckpt.host_values(restored) == {"moments": {"cnt": state.moments.cnt},
                                          "step": state.step}


def test_multichain_roundtrip(tmp_path):
    """tests/test_orbax_ckpt.py:33: `ckpt_backend="orbax"` writes the
    directory and its sidecar; a fresh runner restores the chains, their
    counters and the step exactly."""
    mc, loaders = _chains(str(tmp_path))
    mc.train(*loaders)
    assert mc._use_orbax()
    path = mc.save_ckpt(0)
    assert path.endswith("chains_ckpt_orbax") and os.path.isdir(path)
    with open(path + ".meta.pkl", "rb") as f:
        meta = pickle.load(f)
    assert meta["n_chain"] == 2 and meta["seeds"] == mc.trainer.seeds
    assert meta["bi"] == mc.trainer.bi and meta["method"] == "sgld"

    mc2, _ = _chains(str(tmp_path / "other"))
    assert not torch.equal(mc2.trainer.iterates(), mc.trainer.iterates())
    assert mc2.load_ckpt(path) == 0
    assert torch.equal(mc2.trainer.iterates(), mc.trainer.iterates())
    assert mc2.trainer.bi == mc2.runner.bi == mc.trainer.bi
    for a, b in zip(mc2.trainer.states, mc.trainer.states):
        assert torch.equal(a.buf, b.buf)
        assert torch.equal(a.moments.mom1, b.moments.mom1)
        assert (a.moments.cnt, a.step) == (b.moments.cnt, b.step)


def test_pickle_backend_and_auto(tmp_path):
    """"pickle" writes chains_ckpt.pkl; "auto" in one process (no process
    group) is the pickle, as in the JAX package."""
    mc, _ = _chains(str(tmp_path))
    for backend, name in (("pickle", "chains_ckpt.pkl"),
                          ("auto", "chains_ckpt.pkl"),
                          ("orbax", "chains_ckpt_orbax")):
        mc.cfg.ckpt_backend = backend
        assert os.path.basename(mc.save_ckpt(0)) == name


@pytest.mark.parametrize("n_chain,seed,flag", [(3, 0, "--num_chains"),
                                               (2, 1, "--seed")])
def test_mismatch_raises_before_any_tensor_is_read(tmp_path, monkeypatch,
                                                   n_chain, seed, flag):
    mc, _ = _chains(str(tmp_path))
    path = mc.save_ckpt(0)
    other, _ = _chains(str(tmp_path / "other"), n_chain, seed=seed)
    before = other.trainer.iterates().clone()
    reads = []
    monkeypatch.setattr(runner_mod.ckpt, "restore",
                        lambda *a: reads.append(a))
    with pytest.raises(ValueError, match=flag):
        other.load_ckpt(path)
    assert not reads
    assert torch.equal(other.trainer.iterates(), before)


def test_sidecar_from_another_save_raises(tmp_path):
    """The directory's counters must be its sidecar's."""
    mc, loaders = _chains(str(tmp_path))
    path = mc.save_ckpt(0)
    with open(path + ".meta.pkl", "rb") as f:
        stale = f.read()
    mc.train(*loaders)
    mc.save_ckpt(0)
    with open(path + ".meta.pkl", "wb") as f:
        f.write(stale)
    fresh, _ = _chains(str(tmp_path / "other"))
    with pytest.raises(ValueError, match="sidecar"):
        fresh.load_ckpt(path)


def test_second_save_leaves_no_stale_files(tmp_path):
    """A save replaces the directory whole: the files of an earlier save
    with more shards and more chains are gone, no temporary directory is
    left, and the second save is what loads."""
    three, _ = _chains(str(tmp_path), 3)
    path = three.save_ckpt(0)
    with open(os.path.join(path, "__1_0.distcp"), "wb") as f:
        f.write(b"a second rank's shard")
    first = set(os.listdir(path))
    mc, loaders = _chains(str(tmp_path))
    mc.train(*loaders)
    assert mc.save_ckpt(0) == path
    assert set(os.listdir(path)) == first - {"__1_0.distcp"}
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    fresh, _ = _chains(str(tmp_path / "other"))
    fresh.load_ckpt(path)
    assert torch.equal(fresh.trainer.iterates(), mc.trainer.iterates())


def _graph_keys(mc, ep):
    """Each chain's fused StepGraph key: what its captured graphs were
    captured against (methods/graphed.py)."""
    r, tr = mc.runner, mc.trainer
    keys = []
    for c in range(tr.n_chain):
        with r.bound(tr.states[c], tr.net_states[c], tr.seeds[c]):
            keys.append(r._step_graphs[tr.seeds[c]]._key(r, ep))
    return keys


def test_fused_keeps_its_graphs_after_a_load_in_place(tmp_path):
    """A directory load writes the chains' own tensors, so a fused run's
    captured addresses stay and its graphs replay on the loaded values;
    a pickle load binds new tensors, so the graphs are captured again.
    Both continue as the uninterrupted fused run, bit for bit."""
    full, loaders = _chains(str(tmp_path / "full"), epochs=2, fused=True)
    full.train(loaders[0], None, None)
    part, loaders = _chains(str(tmp_path / "int"), epochs=1, fused=True)
    part.train(loaders[0], None, None)
    part.cfg.ckpt_backend = "pickle"
    part.save_ckpt(0)

    for label, name, move in (("dir", "chains_ckpt_orbax", False),
                              ("pkl", "chains_ckpt.pkl", True)):
        mc, loaders = _chains(str(tmp_path / label), epochs=2, fused=True)
        mc.train(loaders[0], None, None)  # the graphs of an uninterrupted run
        keys = _graph_keys(mc, 1)
        mc.load_ckpt(str(tmp_path / "int" / name))
        assert torch.equal(mc.trainer.iterates(), part.trainer.iterates())
        moved = [a != b for a, b in zip(keys, _graph_keys(mc, 1))]
        assert moved == [move] * N_CHAIN, name
        mc.train(loaders[0], None, None, start_epoch=1)
        assert torch.equal(mc.trainer.iterates(), full.trainer.iterates())
        assert mc.trainer.bi == full.trainer.bi


def test_orbax_resume_matches_jax(tmp_path):
    """The same 2-chain SGLD run at nd = 0 in both packages: an epoch, the
    directory checkpoint (orbax in the JAX package, DCP in the port), a
    fresh runner restored from it and continued to 2 epochs; the port's
    chains end within rtol 1e-4 of the JAX package's, and equal to its
    own uninterrupted run."""
    hp = dict(HP, nd="0.0", nst="0")

    def pair(epochs, name):
        jr, tr, jl, tl = _pair("sgld", hp, momentum=0.5, epochs=epochs,
                               width=16, n_train=192, batch_size=16)
        jr.cfg.ckpt_backend = tr.cfg.ckpt_backend = "orbax"
        jmc = JMultiChainRunner(jr, make_mesh(1, 1), n_chain=N_CHAIN,
                                workdir=str(tmp_path / "jax" / name))
        tmc = MultiChainRunner(tr, N_CHAIN, workdir=str(tmp_path / name))
        tmc.trainer.states, tmc.trainer.net_states = interop.chain_states(
            tr, jmc.trainer.states, jmc.trainer.net_states, N_CHAIN, "cpu")
        return jmc, tmc, jl, tl

    jfull, tfull, jl, tl = pair(2, "full")
    tfull.train(tl[0], None, None)
    jmc, tmc, jl, tl = pair(1, "int")
    jmc.train(jl[0], None, None)
    tmc.train(tl[0], None, None)
    jres, tres, jl, tl = pair(2, "res")
    jpath = str(tmp_path / "jax" / "int" / "chains_ckpt_orbax")
    tpath = str(tmp_path / "int" / "chains_ckpt_orbax")
    assert jres.load_ckpt(jpath) == tres.load_ckpt(tpath) == 0
    jres.train(jl[0], None, None, start_epoch=1)
    tres.train(tl[0], None, None, start_epoch=1)
    assert tres.trainer.bi == jres.trainer.bi == 2 * len(tl[0])
    js = jres.trainer.states
    for c in range(N_CHAIN):
        st = tres.trainer.states[c]
        for f in ("theta", "buf"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       np.asarray(getattr(js, f))[c], **TOL,
                                       err_msg=f)
        assert st.moments.cnt == int(np.asarray(js.moments.cnt)[c]) > 1
    assert torch.equal(tres.trainer.iterates(), tfull.trainer.iterates())


def test_resume_keeps_the_likelihood_examples(tmp_path):
    """cSGHMC on 2 chains at nd = 0, its cycles one epoch long, resumed
    after the first from the directory: a cycle end's likelihood pass
    iterates the shared train loader (shuffled, drop_last), whose state
    the port saves with the checkpoint, so its resumed cycle-2 likelihoods
    are its uninterrupted run's, bit for bit.  The JAX package does not
    save it (parallel/runner.py:366, ROADMAP.md queue 3): its resumed pass
    drops other examples, and its likelihoods move off its uninterrupted
    run's, which agrees with the port's within rtol 1e-4."""
    from tests.test_torch_multichain import CSGHMC_HP

    def pair(epochs, name):
        jr, tr, jl, tl = _pair("csghmc", CSGHMC_HP, epochs=epochs,
                               num_cycles=epochs, width=16, n_train=192,
                               batch_size=16)
        jr.cfg.ckpt_backend = tr.cfg.ckpt_backend = "orbax"
        jmc = JMultiChainRunner(jr, make_mesh(1, 1), n_chain=N_CHAIN,
                                workdir=str(tmp_path / "jax" / name))
        tmc = MultiChainRunner(tr, N_CHAIN, workdir=str(tmp_path / name))
        tmc.trainer.states, tmc.trainer.net_states = interop.chain_states(
            tr, jmc.trainer.states, jmc.trainer.net_states, N_CHAIN, "cpu")
        return jmc, tmc, jl[0], tl[0]

    runs = {}
    for name, epochs in (("full", 2), ("int", 1), ("res", 2)):
        jmc, tmc, jl, tl = runs[name] = pair(epochs, name)
        if name == "res":
            jmc.load_ckpt(str(tmp_path / "jax" / "int" / "chains_ckpt_orbax"))
            tmc.load_ckpt(str(tmp_path / "int" / "chains_ckpt_orbax"))
        start = 1 if name == "res" else 0
        jmc.train(jl, None, None, start_epoch=start)
        tmc.train(tl, None, None, start_epoch=start)

    def liks(mc, cyc):
        return np.stack([st[cyc]["likelihoods"] for st in mc.chain_cycle_stats])

    jfull, tfull = runs["full"][:2]
    jres, tres = runs["res"][:2]
    np.testing.assert_allclose(liks(tfull, 2), liks(jfull, 2), rtol=1e-4)
    np.testing.assert_array_equal(liks(tres, 2), liks(tfull, 2))
    assert not np.allclose(liks(jres, 2), liks(jfull, 2), rtol=1e-4, atol=0)
    np.testing.assert_allclose(liks(jres, 1), liks(jfull, 1), rtol=1e-6)
