"""Tensor parallelism of the port's ViT (parallel/tp.py, models/vit.py) on
spawned gloo worlds, mirroring tests/test_tp.py: the tiny ViT (dim 32,
depth 2, 4 heads, mlp 64, image 32, patch 16), 3 cSGHMC steps at (data 1,
model 2) and (data 2, model 2).

TP changes where the products run, not what they compute: the loss within
rtol 1e-5 and θ within rtol 1e-4 / atol 1e-5 (tests/test_tp.py:66-67) of
the JAX package's single-device steps (noise off: the two packages draw
other noise) and of the port's single-process steps (noise off and on: a
rank's shard draws its own elements of the whole vector's noise).  Each
rank's wide hidden (qkv) has 1/n_model of the features, and each rank holds
1/world of the flat state.

Remat checkpoints the tensor-parallel blocks under each policy ('' full,
'dots', 'names'): the steps are bitwise those without remat, within the
tolerances above of the JAX tiny ViT with the same policy on one device,
and the all-reduces the steps run are counted: "dots" saves the sums over
the model group and runs none again, '' and "names" recompute the first
of a block's two sums (recomputation stops before the second).  The CLI
with --remat --tensor_parallel 2 checkpoints the tensor-parallel blocks.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_dist
from tests.test_tp import _tiny_vit_runner

LAYOUTS = ((1, 2), (2, 2))  # (data, model)
TOL = dict(rtol=1e-4, atol=1e-5)
POLICIES = torch_dist.REMAT_POLICIES
POLICY_IDS = ["full", "dots", "names"]
DEPTH, STEPS = 2, 3


def _remat_runner(policy):
    """tests/test_tp.py's tiny ViT runner with remat under `policy`."""
    import functools
    from bayesdll_tpu.models import vit
    real = vit.ViT
    vit.ViT = functools.partial(real, remat=True, remat_policy=policy)
    try:
        return _tiny_vit_runner()
    finally:
        vit.ViT = real


def _jax_steps(x, y, policy=None):
    """3 steps of the JAX package's single-device runner, noise off; with
    remat under `policy` when one is given."""
    r = _tiny_vit_runner() if policy is None else _remat_runner(policy)
    sc = {"lr": 0.01, "should_sample": False, "collect": True}
    state, ns = r.state, r.net_state
    for i in range(3):
        state, ns, m = r._jit_step(r.target, state, ns, jnp.asarray(x),
                                   jnp.asarray(y), jax.random.PRNGKey(i), sc)
    return np.asarray(state.theta), float(m[0])


@pytest.fixture(scope="module")
def setup():
    return torch_dist.shared("tp", _compute)


def _compute():
    """The worlds of LAYOUTS and, meanwhile, the JAX package's steps (with
    each remat policy) and the port's single-process steps, once per test
    session."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 5, 8).astype(np.int32)
    jr = _tiny_vit_runner()
    arrays = {"theta": np.asarray(jr.state.theta),
              "theta0": np.asarray(jr.target.theta0),
              "is_head": np.asarray(jr.target.is_head),
              "is_bias": np.asarray(jr.target.is_bias),
              "hp": dict(jr.cfg.hparams)}
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        futs = {lay: pool.submit(torch_dist.run_world, torch_dist.tp_world,
                                 lay[0] * lay[1], arrays, x, y, lay[0])
                for lay in LAYOUTS}
        single = {}
        for sample in (False, True):
            loss, state = torch_dist.vit_steps(
                torch_dist.vit_runner(arrays), x, y, sample)
            single[sample] = {"loss": loss, "theta": state.theta.numpy()}
        out = {"jax": _jax_steps(x, y), "single": single,
               "jax_remat": {p: _jax_steps(x, y, p) for p in POLICIES},
               "dim": arrays["theta"].shape[0]}
        out["ranks"] = {lay: f.result() for lay, f in futs.items()}
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_steps_match_jax_single_device(setup, layout):
    j_theta, j_loss = setup["jax"]
    for rank in setup["ranks"][layout]:
        got = rank[False]
        assert np.isfinite(got["loss"])
        np.testing.assert_allclose(got["loss"], j_loss, rtol=1e-5)
        np.testing.assert_allclose(got["theta"], j_theta, **TOL)
    # the port's own single-process steps agree with JAX's too
    np.testing.assert_allclose(setup["single"][False]["theta"], j_theta,
                               **TOL)


@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_steps_match_the_single_process_run(setup, layout, sample):
    ref = setup["single"][sample]
    for rank in setup["ranks"][layout]:
        np.testing.assert_allclose(rank[sample]["loss"], ref["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(rank[sample]["theta"], ref["theta"],
                                   **TOL)
    assert not np.allclose(setup["single"][True]["theta"],
                           setup["single"][False]["theta"], rtol=0,
                           atol=1e-9)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_shards_the_wide_hidden_and_the_state(setup, layout):
    world = layout[0] * layout[1]
    for rank in setup["ranks"][layout]:
        assert rank["model_size"] == layout[1]
        assert rank["qkv_width"] == 3 * 32 // layout[1]
        for sample in (False, True):
            assert rank[sample]["local"] == setup["dim"] // world


@pytest.mark.parametrize("policy", POLICIES, ids=POLICY_IDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_remat_steps_bitwise_equal_to_tp_without_remat(setup, layout,
                                                          policy):
    for rank in setup["ranks"][layout]:
        got, ref = rank[f"remat {policy}"], rank[False]
        assert got["loss"] == ref["loss"]
        np.testing.assert_array_equal(got["theta"], ref["theta"])
        np.testing.assert_array_equal(got["v"], ref["v"])


@pytest.mark.parametrize("policy", POLICIES, ids=POLICY_IDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_remat_steps_match_jax_with_the_same_policy(setup, layout,
                                                       policy):
    j_theta, j_loss = setup["jax_remat"][policy]
    for rank in setup["ranks"][layout]:
        got = rank[f"remat {policy}"]
        np.testing.assert_allclose(got["loss"], j_loss, rtol=1e-5)
        np.testing.assert_allclose(got["theta"], j_theta, **TOL)


@pytest.mark.parametrize("policy", POLICIES, ids=POLICY_IDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_remat_all_reduces_per_step(setup, layout, policy):
    """Per step without remat: f and g twice in each block, the gradient's
    sum and the loss's and error's; with remat "" and "names" one more per
    block (the recompute's first sum), with "dots" none."""
    plain = STEPS * (4 * DEPTH + 3)
    extra = STEPS * DEPTH * {"": 1, "dots": 0, "names": 1}[policy]
    for rank in setup["ranks"][layout]:
        assert rank[False]["all_reduces"] == plain
        assert rank[f"remat {policy}"]["all_reduces"] == plain + extra


def test_cli_remat_with_tensor_parallel_checkpoints_the_tp_blocks(setup):
    ranks = setup["ranks"][(1, 2)]
    for rank in ranks:
        cli = rank["cli"]
        assert cli["tp_remat"] == (True, "names")
        assert cli["checkpointed"] == ["_block_tp"]
        assert cli["n_checkpointed"] > 0
        assert np.isfinite(cli["train_losses"]).all()
    assert ranks[0]["cli"]["train_losses"] == ranks[1]["cli"]["train_losses"]


def test_tp_refuses_chains(tmp_path):
    from bayesdll_tpu_torch.cli import demo
    with pytest.raises(ValueError, match="requires --num_chains 1"):
        demo.main(["--method", "csghmc", "--backbone", "vit_tiny",
                   "--dataset", "synthetic", "--epochs", "1",
                   "--num_chains", "2", "--tensor_parallel", "2",
                   "--device", "cpu", "--log_dir", str(tmp_path)])
