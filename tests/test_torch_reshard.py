"""The DCP checkpoint (parallel/runner.py, `chains_ckpt_orbax`) restored at
a layout other than the one that wrote it, on one spawned world of 2 gloo
ranks and in the test process (a world of one), mirroring what the JAX
package's orbax template with the live shardings does
(bayesdll_tpu/parallel/runner.py:455-481):

  * 2 cSGHMC chains on the width-16 MLP with --data_parallel 2 --fsdp save
    the directory (and the pickle) after an epoch; one process without
    fsdp restores it, the chains' whole states bitwise those the ranks
    saved, and its next epoch is bitwise the pickle's resume;
  * the reverse: a world-1 save resumed in the 2-rank fsdp world, bitwise
    that world's resume from the pickle;
  * 2 chains over the 2 ranks (each rank its own chain) resumed at world 1;
  * a fused run at world 1 keeps its captured graphs across a load of the
    fsdp ranks' directory, and resumes bitwise as the per-step path;
  * a padded length other than the directory's raises ValueError, naming
    both, before any tensor is read;
  * the JAX package's own behaviour on the conftest's 8 virtual devices:
    its orbax directory from make_mesh(1, 2) with fsdp restores at
    make_mesh(1, 4) and make_mesh(1, 1) with θ bitwise; and the port's
    world-2 fsdp run from the JAX trainer's states, resumed at world 1,
    matches the JAX package's next epoch at nd = 0 within rtol 1e-5 /
    atol 1e-6 (tests/test_torch_data_parallel.py's tolerances).
"""

import os

import numpy as np
import pytest
import torch

from bayesdll_tpu.methods import get_runner_cls as j_get_runner_cls
from bayesdll_tpu.parallel import make_mesh as j_make_mesh
from bayesdll_tpu.parallel.runner import MultiChainRunner as JMultiChainRunner
from bayesdll_tpu_torch.parallel import runner as runner_mod
from tests import torch_dist
from tests.helpers import tiny_setup
from tests.test_torch_checkpoint import _graph_keys
from tests.test_torch_data_parallel import _assert_trees_equal, _np_tree

HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "1.0", "thin": "1",
      "bias": "informative", "nst": "2", "momentum_decay": "0.05"}
HP0 = dict(HP, nd="0.0")


def _jax_mc(epochs, mesh, workdir):
    cfg, target, theta, ns, *loaders = tiny_setup(
        "csghmc", dict(HP0), epochs=epochs, num_cycles=epochs, lr=1e-3,
        width=16, n_train=192, batch_size=16, ckpt_backend="orbax")
    r = j_get_runner_cls("csghmc")(target, theta, ns, cfg)
    return JMultiChainRunner(r, mesh, n_chain=2, fsdp=True,
                             workdir=workdir), loaders, (target, theta)


def _jax(root):
    """The JAX package's 2 chains under fsdp at make_mesh(1, 2) for an
    epoch, their orbax directory restored at (1, 4) and (1, 1), and the
    (1, 1) run's second epoch; the trainer's initial states and flat arrays
    for the port."""
    mc, loaders, (target, theta) = _jax_mc(1, j_make_mesh(1, 2),
                                           f"{root}/jax_int")
    start = _np_tree(mc.trainer.states)
    mc.train(loaders[0], None, None)
    path = f"{root}/jax_int/chains_ckpt_orbax"
    saved = np.asarray(mc.trainer.states.theta)
    restored = {}
    for n in (4, 1):
        res, res_loaders, _ = _jax_mc(2, j_make_mesh(1, n), f"{root}/jax{n}")
        res.load_ckpt(path)
        restored[n] = np.asarray(res.trainer.states.theta)
    res.train(res_loaders[0], None, None, start_epoch=1)
    arrays = {"theta": np.asarray(theta), "theta0": np.asarray(target.theta0),
              "is_head": np.asarray(target.is_head),
              "is_bias": np.asarray(target.is_bias)}
    return {"saved": saved, "restored": restored,
            "next": np.asarray(res.trainer.states.theta)}, arrays, start


def _mismatch(path, root):
    """Load `path` into a runner padded to 3072 (the world-3 CLI's
    lcm(1024, 12)) with DCP's restore watched: (the error, the reads)."""
    mc, _ = torch_dist.reshard_chains(HP, f"{root}/mismatch", epochs=2,
                                      pad_to=3072)
    reads = []
    restore = runner_mod.ckpt.restore
    runner_mod.ckpt.restore = lambda *a: reads.append(a)
    try:
        mc.load_ckpt(path)
        err = None
    except ValueError as e:
        err = str(e)
    finally:
        runner_mod.ckpt.restore = restore
    return err, len(reads), mc.runner.target.dim


def _fused(path, root):
    """A fused world-1 run that has captured its graphs, loaded from the
    fsdp ranks' directory and resumed: (graph keys moved, its end)."""
    mc, loaders = torch_dist.reshard_chains(HP, f"{root}/fused", epochs=2,
                                            fused=True)
    mc.train(loaders[0], None, None)
    keys = _graph_keys(mc, 1)
    mc.load_ckpt(path)
    moved = [a != b for a, b in zip(keys, _graph_keys(mc, 1))]
    mc.train(loaders[0], None, None, start_epoch=1)
    return moved, torch_dist.chains_host(mc)


def _compute(root):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax_out, arrays, start = _jax(root)
        world1 = torch_dist.interrupted(HP, f"{root}/world1")
        inp = {"hp": HP, "hp0": HP0, "arrays": arrays, "start": start,
               "world1": world1}
        ranks = torch_dist.run_world(torch_dist.reshard_world, 2, inp,
                                     f"{root}/ranks", timeout=240)
        out = {"jax": jax_out, "world1": world1[0], "ranks": ranks}
        for name in ("fsdp", "chains"):
            _, directory, pkl = ranks[0][name]
            for kind, path in (("dcp", directory), ("pkl", pkl)):
                out[f"{name} {kind}"] = torch_dist.resumed(
                    HP, path, f"{root}/{name}_{kind}")
        out["jax port"] = torch_dist.resumed(
            HP0, ranks[0]["jax"][1], f"{root}/jax_port", arrays=arrays)
        out["fused"] = _fused(ranks[0]["fsdp"][1], root)
        out["mismatch"] = _mismatch(ranks[0]["fsdp"][1], root)
        return out
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reshard"))
    return torch_dist.shared("reshard", lambda: _compute(root))


def _equal_chains(a, b, what):
    assert len(a) == len(b) == 2, what
    for c in range(2):
        _assert_trees_equal(a[c], b[c], f"{what} chain {c}")


@pytest.mark.parametrize("name", ["fsdp", "chains"])
def test_two_rank_save_resumes_at_world_1_as_the_pickle(runs, name):
    saved = runs["ranks"][0][name][0]
    _equal_chains(runs["ranks"][1][name][0], saved, "the ranks' states")
    dcp, pkl = runs[f"{name} dcp"], runs[f"{name} pkl"]
    assert dcp["layout"] == (2, saved[0]["theta"].shape[0])  # whole, 1 rank
    _equal_chains(dcp["loaded"], saved, "restored at world 1")
    _equal_chains(dcp["end"], pkl["end"], "resumed epoch")
    assert dcp["losses"] == pkl["losses"]
    assert not np.array_equal(dcp["end"][0]["theta"], saved[0]["theta"])


def test_world_1_save_resumes_in_the_fsdp_world_as_the_pickle(runs):
    saved = runs["world1"]
    for rank in runs["ranks"]:
        dcp, pkl = rank["from world1 dcp"], rank["from world1 pkl"]
        d = saved[0]["theta"].shape[0]
        assert dcp["layout"] == (2, d // 2)  # 2 chains, half of D each
        _equal_chains(dcp["loaded"], saved, "restored under fsdp")
        _equal_chains(dcp["end"], pkl["end"], "resumed epoch")
        assert dcp["losses"] == pkl["losses"]


def test_fused_keeps_its_graphs_after_a_load_at_another_layout(runs):
    moved, end = runs["fused"]
    assert moved == [False, False]
    _equal_chains(end, runs["fsdp dcp"]["end"], "fused resume")


def test_padded_length_mismatch_raises_before_any_read(runs):
    err, reads, dim = runs["mismatch"]
    d = runs["world1"][0]["theta"].shape[0]
    assert err is not None and str(d) in err and str(dim) in err
    assert dim != d and reads == 0


def test_jax_orbax_restores_at_another_mesh_bitwise(runs):
    j = runs["jax"]
    for n in (4, 1):
        np.testing.assert_array_equal(j["restored"][n], j["saved"])


def test_port_world_2_to_world_1_resume_matches_jax(runs):
    port = runs["jax port"]
    np.testing.assert_allclose(port["loaded"][0]["theta"],
                               runs["jax"]["saved"][0], rtol=1e-5, atol=1e-6)
    for c in range(2):
        np.testing.assert_allclose(port["end"][c]["theta"],
                                   runs["jax"]["next"][c], rtol=1e-5,
                                   atol=1e-6)
    assert not np.allclose(port["end"][0]["theta"], port["loaded"][0]["theta"])
