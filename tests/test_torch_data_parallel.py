"""Data parallelism and fsdp of the port (parallel/chains.py over a
('chain', 'data') mesh) on 2 spawned gloo ranks, mirroring
tests/test_parallel.py and the worker of tests/test_multihost.py:

  * SGLD at nd = 0 on 1 chain x 2 data ranks: θ within rtol 1e-5 / atol
    1e-6 of the JAX package's make_mesh(1, 2) step and of the port's
    single-process step (the batch's mean gradient summed in another order);
  * 2 chains over 2 ranks: each chain bitwise its single-process run, per
    step and fused, noise on;
  * fsdp bitwise equal to replicated data parallel at nd > 0 for SGLD,
    cSGHMC and VI (the sgld_update, csghmc_update and philox_draw families:
    each shard draws its own elements of the whole vector's noise), each
    rank holding half of every vector;
  * a mini ResNet whose BatchNorm normalises over the whole chain batch of
    the 2 ranks against JAX's mesh step, judged as the single-process
    ResNet runs are (tests/test_torch_resnet.py::_assert_same_walk);
  * the CLI with --multihost on 2 processes, --data_parallel 2 --fsdp, one
    epoch of cSGHMC with a cycle end: the DCP checkpoint (each vector one
    whole tensor of the directory, the sidecar naming the layout) resumes
    to a second epoch bitwise equal to the uninterrupted run, and the same
    GMM NLL on both ranks.
"""

import dataclasses
import json
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesdll_tpu.config import Config as JConfig
from bayesdll_tpu.core.prior import make_flat_target as j_make_flat_target
from bayesdll_tpu.methods import get_runner_cls as j_get_runner_cls
from bayesdll_tpu.models.resnet import ResNet as JResNet
from bayesdll_tpu.parallel import MultiChainTrainer as JTrainer
from bayesdll_tpu.parallel import make_mesh as j_make_mesh
from tests import torch_dist
from tests.helpers import tiny_setup
from tests.test_torch_resnet import (HP as RESNET_HP, _assert_same_walk,
                                     _random_stats)

SGLD_ND0 = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.0", "burnin": "0",
            "thin": "1", "bias": "informative", "nst": "0"}
NOISE = {
    "sgld": {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "1.0",
             "burnin": "0", "thin": "1", "bias": "informative", "nst": "2"},
    "csghmc": {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "1.0",
               "thin": "1", "bias": "informative", "nst": "2",
               "momentum_decay": "0.05"},
    "vi": {"prior_sig": "1.0", "kld": "1.0", "bias": "uninformative",
           "nst": "2"},
}
K, B = 3, 16  # per-step steps, batch
STAGES, RK, HW, RB = (1, 1, 1, 1), 5, 32, 8  # the mini ResNet's


def _jax_mlp():
    cfg, target, theta_init, net_state, *_ = tiny_setup(
        method="sgld", hparams=SGLD_ND0, epochs=1, batch_size=B, lr=1e-2)
    arrays = {"theta": np.asarray(theta_init),
              "theta0": np.asarray(target.theta0),
              "is_head": np.asarray(target.is_head),
              "is_bias": np.asarray(target.is_bias),
              "nd_size": int(target.nd_size)}
    return cfg, target, theta_init, net_state, arrays


def _resnet_inputs(rng):
    jm = JResNet(stage_sizes=STAGES, num_classes=RK, dtype="float32")
    jt, jth, jns = j_make_flat_target(
        jm, (HW, HW, 3), nd_size=64, num_classes=RK,
        rng=jax.random.PRNGKey(0), has_batch_stats=True)
    stats = _random_stats(jax.tree.map(np.asarray, jns["batch_stats"]), rng)
    xs = rng.randn(3, RB, HW, HW, 3).astype(np.float32)
    ys = rng.randint(0, RK, (3, RB)).astype(np.int32)
    return jt, jth, {"theta": np.asarray(jth),
                     "theta0": np.asarray(jt.theta0),
                     "is_head": np.asarray(jt.is_head),
                     "is_bias": np.asarray(jt.is_bias), "stats": stats,
                     "stages": STAGES, "k": RK, "batch": RB, "hp": RESNET_HP,
                     "xs": xs, "ys": ys}


def _np_tree(tree):
    """A JAX state as nested dicts of numpy arrays (what a rank unpickles
    without JAX)."""
    if dataclasses.is_dataclass(tree):
        return {f.name: _np_tree(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# the JAX trainers whose stacked states the ranks start from (interop):
# name -> (method, hparams, lr, chains, data ranks, fsdp)
JAX_START = {"jax_chains": ("csghmc", dict(NOISE["csghmc"], nd="0.0"), 1e-3,
                            2, 1, False),
             "jax_fsdp": ("sgld", SGLD_ND0, 1e-2, 1, 2, True)}


def _jax_start(name, xs, ys):
    """The JAX trainer's initial stacked states (numpy) and its whole
    states after K steps."""
    method, hp, lr, n_chain, n_data, fsdp = JAX_START[name]
    _, target, theta_init, net_state, _ = _jax_mlp()
    cfg = JConfig(method=method, hparams=dict(hp), dataset="synthetic",
                  backbone="mlp_mnist", epochs=1, batch_size=B, lr=lr,
                  num_cycles=1, seed=0)  # torch_dist.mlp_runner's
    jr = j_get_runner_cls(method)(target, theta_init, net_state, cfg)
    if hasattr(jr, "_ensure_sched"):
        jr._ensure_sched(4)
    jtr = JTrainer(jr, j_make_mesh(n_chain, n_data), fsdp=fsdp)
    start = _np_tree(jtr.states)
    for k in range(K):
        jr.bi = k
        jtr.step(xs[k][:n_chain], ys[k][:n_chain], jr.step_scalars(0))
    return ({"hp": hp, "lr": lr, "states": start},
            np.asarray(jax.device_get(jtr.states.theta)))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(1)
    jt, jth, res = _resnet_inputs(np.random.RandomState(0))
    inp = {"mlp": _jax_mlp()[4], "sgld_nd0": SGLD_ND0, **NOISE,
           "csghmc_lr": 1e-3,
           "xs": rng.randn(K, 2, B, 784).astype(np.float32),
           "ys": rng.randint(0, 10, (K, 2, B)).astype(np.int32),
           "fused_xs": rng.randn(2, 2, B, 784).astype(np.float32),
           "fused_ys": rng.randint(0, 10, (2, 2, B)).astype(np.int32),
           "resnet": res}
    jax_end = {}
    for name in JAX_START:
        inp[name], jax_end[name] = _jax_start(name, inp["xs"], inp["ys"])
    ranks = torch_dist.shared("data_parallel", lambda: torch_dist.run_world(
        torch_dist.dp_world, 2, inp))
    return {"inp": inp, "ranks": ranks, "resnet_jax": (jt, jth),
            "jax_end": jax_end}


@pytest.mark.parametrize("name", sorted(JAX_START))
def test_ranks_started_from_the_jax_trainers_states_step_with_it(setup,
                                                                 name):
    """interop.rank_chain_states hands each rank its chains (or its fsdp
    shard) of the JAX trainer's stacked states; 3 steps at nd = 0 then
    agree with the JAX trainer's within the multi-chain parity tolerance
    (tests/test_torch_multichain.py)."""
    _, _, _, n_chain, n_data, fsdp = JAX_START[name]
    d = setup["inp"]["mlp"]["theta"].shape[0]
    for rank in setup["ranks"]:
        got = rank[name]
        assert got["local_sizes"] == [d // n_data if fsdp else d] * (
            n_chain // (2 // n_data))
        for c in range(n_chain):
            np.testing.assert_allclose(got["states"][c]["theta"],
                                       setup["jax_end"][name][c],
                                       rtol=1e-4, atol=1e-5)


def _assert_trees_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def test_sgld_data_parallel_nd0_matches_jax_and_one_process(setup):
    cfg, target, theta_init, net_state, _ = _jax_mlp()
    jr = j_get_runner_cls("sgld")(target, theta_init, net_state, cfg)
    jtr = JTrainer(jr, j_make_mesh(1, 2))
    st = jr.init_state(jnp.asarray(theta_init))
    jtr.states = jax.tree.map(lambda leaf: jnp.stack([leaf]), st)
    xs, ys = setup["inp"]["xs"], setup["inp"]["ys"]
    for k in range(K):
        jr.bi = k
        jtr.step(xs[k][:1], ys[k][:1], jr.step_scalars(0))
    j_theta = np.asarray(jtr.states.theta)[0]
    for rank in setup["ranks"]:
        dp = rank["dp_nd0"]["states"][0]["theta"]
        np.testing.assert_allclose(dp, j_theta, rtol=1e-5, atol=1e-6)
        assert rank["dp_nd0"]["local_sizes"] == [j_theta.shape[0]]
    single = setup["ranks"][0]["single_nd0"]["states"][0]["theta"]
    np.testing.assert_allclose(single, j_theta, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(setup["ranks"][0]["dp_nd0"]["states"][0]
                               ["theta"], single, rtol=1e-5, atol=1e-6)
    assert not np.array_equal(single, np.asarray(theta_init))


def test_chains_over_ranks_bitwise_their_single_process_runs(setup):
    ref = setup["ranks"][0]["chains_single"]
    for rank in setup["ranks"]:
        got = rank["chains_ranks"]
        assert len(got["states"]) == 2 and got["local_sizes"] == [
            ref["local_sizes"][0]]
        for c in range(2):
            _assert_trees_equal(got["states"][c], ref["states"][c],
                                f"chain {c}")
        for a, b in zip(got["losses"], ref["losses"]):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(ref["states"][0]["theta"],
                              ref["states"][1]["theta"])


@pytest.mark.parametrize("method", ["sgld", "csghmc", "vi"])
def test_fsdp_bitwise_equal_to_replicated_data_parallel(setup, method):
    d = setup["inp"]["mlp"]["theta"].shape[0]
    for rank in setup["ranks"]:
        rep, sh = rank[f"{method}_fsdp0"], rank[f"{method}_fsdp1"]
        assert rep["local_sizes"] == [d] and sh["local_sizes"] == [d // 2]
        _assert_trees_equal(sh["states"][0], rep["states"][0], method)
        for a, b in zip(sh["losses"], rep["losses"]):
            if method == "vi":  # its KL term summed over the shards
                np.testing.assert_allclose(a, b, rtol=1e-6)
            else:
                np.testing.assert_array_equal(a, b)
    # the noise moved the state: the equality is of noisy walks
    st = setup["ranks"][0][f"{method}_fsdp1"]["states"][0]
    it = st["m"] if method == "vi" else st["theta"]
    assert not np.array_equal(it, setup["inp"]["mlp"]["theta"])


def test_batchnorm_resnet_data_parallel_walks_with_jax(setup):
    jt, jth = setup["resnet_jax"]
    res = setup["inp"]["resnet"]
    kw = dict(method="csghmc", hparams=dict(RESNET_HP), dataset="synthetic",
              backbone="resnet_mini", epochs=1, batch_size=RB, lr=1e-3,
              num_cycles=1, seed=0)
    jr = j_get_runner_cls("csghmc")(jt, jth, {"batch_stats": res["stats"]},
                                    JConfig(**kw))
    jr._ensure_sched(3)
    jtr = JTrainer(jr, j_make_mesh(1, 2))
    jtr.states = jax.tree.map(lambda leaf: jnp.stack([leaf]),
                              jr.init_state(jth))
    jtr.net_states = jax.tree.map(lambda leaf: jnp.stack([leaf]),
                                  {"batch_stats": res["stats"]})
    losses = []
    for k in range(3):
        jr.bi = k
        loss, _ = jtr.step(res["xs"][k][None], res["ys"][k][None],
                           jr.step_scalars(0))
        losses.append(float(np.asarray(loss)[0]))
    j_stats = jax.tree.map(lambda a: np.asarray(a)[0],
                           jtr.net_states["batch_stats"])
    for rank in setup["ranks"]:
        got = rank["resnet"]
        np.testing.assert_allclose(got["losses"][0], losses[0], rtol=1e-5)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-3)
        _assert_same_walk(torch.from_numpy(got["theta"]),
                          np.asarray(jtr.states.theta)[0], jth, "theta")
        _assert_same_walk(torch.from_numpy(got["v"]),
                          np.asarray(jtr.states.v)[0], 0 * jth, "v")
        _assert_same_walk(torch_dist_tree(got["stats"]), j_stats,
                          res["stats"], "batch_stats")


def torch_dist_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_dist_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


# ---- the CLI -------------------------------------------------------------

CLI = ["--method", "csghmc", "--dataset", "synthetic", "--batch_size", "512",
       "--lr", "1e-3", "--device", "cpu", "--data_parallel", "2", "--fsdp",
       "--hparams", "prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,"
       "bias=informative,nst=2"]
RUN = ("import json, sys; from bayesdll_tpu_torch.cli import demo; "
       "r = demo.main(sys.argv[1:]); print('RESULT ' + json.dumps("
       "{'nll': r['nll'], 'train_losses': r['train_losses']}))")


def _launch(argv, logdir):
    """The CLI on 2 processes joined by --multihost: the Popen of each."""
    port = str(torch_dist.free_port())
    return [subprocess.Popen(
        [sys.executable, "-c", RUN, *CLI, *argv, "--log_dir", str(logdir),
         "--multihost", "--coordinator", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(r)],
        cwd=torch_dist.REPO, env=torch_dist.child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


def _results(procs):
    out = []
    for p in procs:
        log, _ = p.communicate(timeout=240)
        assert p.returncode == 0, log[-4000:]
        out.append(json.loads(log.split("RESULT ", 1)[1].splitlines()[0]))
    return out


def _dcp_tensors(directory):
    """Every tensor of a DCP directory, read in this process."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    md = dcp.FileSystemReader(str(directory)).read_metadata()
    sd = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
          for k, m in md.state_dict_metadata.items()
          if isinstance(m, TensorStorageMetadata)}
    dcp.load(sd, checkpoint_id=str(directory))
    return sd


def _cli_runs(tmp):
    two = ["--epochs", "2", "--num_cycles", "2"]
    full, first = _launch(two, tmp / "full"), _launch(
        ["--epochs", "1", "--num_cycles", "1"], tmp / "int")
    res = {"full": _results(full), "int": _results(first)}
    ckpt = next((tmp / "int").rglob("chains_ckpt_orbax"))
    res["resumed"] = _results(_launch(two + ["--resume", str(ckpt)],
                                      tmp / "resumed"))
    dirs = {n: next((tmp / n).rglob("chains_ckpt_orbax"))
            for n in ("full", "resumed")}
    res["tensors"] = {n: {k: v.numpy() for k, v in _dcp_tensors(d).items()}
                      for n, d in dirs.items()}
    with open(str(dirs["full"]) + ".meta.pkl", "rb") as f:
        res["layout"] = pickle.load(f)["layout"]
    return res


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_cli")
    return torch_dist.shared("data_parallel_cli", lambda: _cli_runs(tmp))


def test_cli_fsdp_resume_bitwise_and_one_nll_on_both_ranks(cli):
    full, resumed = cli["tensors"]["full"], cli["tensors"]["resumed"]
    assert full.keys() == resumed.keys()
    # every vector under its chain's and field's key, whole: the two
    # ranks' slices are one tensor of the directory
    assert {k.split(".")[1] for k in full if k.startswith("states.")} == {
        "0"}
    assert full["states.0.theta"].shape == full["states.0.v"].shape
    assert cli["layout"] == {"world": 2, "chain_axis": 1, "n_data": 2,
                             "fsdp": True}
    for k in full:
        np.testing.assert_array_equal(full[k], resumed[k], err_msg=k)
    for name in ("full", "int", "resumed"):
        r0, r1 = cli[name]
        assert r0 == r1, name  # the same NLL and losses on both ranks
        assert np.isfinite(r0["nll"])
    assert cli["resumed"][0]["nll"] == cli["full"][0]["nll"]
    assert cli["int"][0]["train_losses"] == cli["full"][0]["train_losses"][:1]
    assert cli["resumed"][0]["train_losses"] == \
        cli["full"][0]["train_losses"][1:]
