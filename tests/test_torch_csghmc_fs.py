"""The port's cSGHMC-FS against the JAX package's: the snapshot window over
a grid, the BMA numbers from JAX's own snapshots (rtol 1e-5), a whole run
at nd = 0 (snapshots within rtol 1e-4, atol 1e-5, as every MLP runner
comparison); and cSGLD's --full_sample archive."""

import os
import pickle

import numpy as np
import pytest
import torch

from bayesdll_tpu.data.loader import ArrayLoader as JArrayLoader
from bayesdll_tpu_torch.data.loader import ArrayLoader
from tests.test_torch_sgld import HP, _pair

FS_HP = dict(HP, momentum_decay="0.05")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both runners through 8 epochs of 2 cycles at nd = 0: snapshots at
    epochs 1, 2, 5 and 6."""
    work = tmp_path_factory.mktemp("fs")
    jr, tr, jl, tl = _pair("csghmc_fs", FS_HP, epochs=8, lr=1e-2)
    tr.workdir = str(work)
    tr.models_dir = str(work / "collected_models")
    os.makedirs(tr.models_dir)
    jres = jr.train(*jl)
    tres = tr.train(*tl)
    return jr, tr, jl, tl, jres, tres, work


@pytest.mark.parametrize("epochs,num_cycles", [(2, 2), (4, 1), (6, 2),
                                               (8, 2), (12, 3), (10, 4),
                                               (30, 3)])
def test_near_cycle_end_matches_jax(trained, epochs, num_cycles):
    jr, tr = trained[:2]
    got = []
    for r in (jr, tr):
        r.cfg.epochs, r.cfg.num_cycles = epochs, num_cycles
        got.append([ep for ep in range(epochs) if r._near_cycle_end(ep)])
    assert got[0] == got[1]


def test_snapshots_and_bma_match_jax(trained):
    jr, tr, _, _, jres, tres, work = trained
    assert sorted(tr.full_samples) == sorted(jr.full_samples) == [1, 2, 5, 6]
    for ep, theta in tr.full_samples.items():
        np.testing.assert_allclose(theta, np.asarray(jr.full_samples[ep]),
                                   rtol=1e-4, atol=1e-5)
    for k, v in jres["bma"].items():
        assert abs(tres["bma"][k] - v) < 1e-3, k
    assert tres["bma"]["test_ensemble_err"] < 0.5
    files = {p.name for p in work.iterdir()}
    assert {"bma_evaluation_results.pkl", "logits_test_bma.pkl",
            "full_samples_net_ep5.pkl"} <= files
    with open(work / "collected_models" / "model_metadata.pkl", "rb") as f:
        meta = pickle.load(f)
    assert [(m["epoch"], m["cycle"]) for m in meta] == [(1, 1), (2, 1),
                                                        (5, 2), (6, 2)]


def test_bma_numbers_from_jax_snapshots_match(trained):
    """evaluate_full_samples on JAX's own snapshots and unshuffled loaders."""
    jr, tr, jl, tl = trained[:4]
    tr.full_samples = {ep: np.array(th) for ep, th in jr.full_samples.items()}
    x, y = tl[0].x, tl[0].y
    jbma = jr.evaluate_full_samples(JArrayLoader(x, y, 64), jl[1], jl[2])
    tbma = tr.evaluate_full_samples(ArrayLoader(x, y, 64), tl[1], tl[2])
    assert tbma.keys() == jbma.keys()
    for k, v in jbma.items():
        np.testing.assert_allclose(tbma[k], v, rtol=1e-5, err_msg=k)


def test_momentum_zeroed_at_each_boundary(trained):
    tr = trained[1]
    assert float(tr.state.v.abs().max()) == 0.0  # reset after the last cycle
    assert torch.isfinite(tr.state.theta).all()


def test_csgld_full_sample_archive_matches_jax(tmp_path):
    """Mirrors tests/test_cyclical_methods.py::test_csgld_full_sample_archive."""
    jr, tr, jl, tl = _pair("csgld", HP)
    jr.cfg.full_sample = tr.cfg.full_sample = True
    tr.workdir = str(tmp_path)
    jr.train(*jl)
    tr.train(*tl)
    assert sorted(tr.all_samples) == sorted(jr.all_samples)
    assert len(tr.all_samples) > 0
    for k, theta in tr.all_samples.items():
        np.testing.assert_allclose(theta, np.asarray(jr.all_samples[k]),
                                   rtol=1e-4, atol=1e-5)
    with open(tmp_path / "all_samples.pkl", "rb") as f:
        assert sorted(pickle.load(f)) == sorted(tr.all_samples)
