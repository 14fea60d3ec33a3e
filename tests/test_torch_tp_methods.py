"""Every method of the port under tensor parallelism (parallel/tp.py) on
one spawned gloo world of (1 data x 2 model) ranks: the tiny ViT (dim 32,
depth 2, 4 heads, mlp 64, patch 16) trained through each runner's own
`train` for one epoch (cSGHMC-FS three, for its snapshot window), with a
cycle end where the method has one, against the same run in one process;
cSGLD also archives every θ it collects (--full_sample).

At nd = 0 (the noise gate off; VI, MC-dropout and the Adam methods still
draw, each rank its shard's elements of the whole vector's draw) the train
losses are within rtol 1e-5 and the final iterate within rtol 1e-4 / atol
1e-5 of the single process's (tests/test_torch_tp.py's tolerances); SGLD,
SGHMC and Adam-SGHMC train two epochs, the first their burn-in.  One set
of elements is held apart under the Adam methods: the attention's key
bias, whose gradient is zero (a query's softmax does not change when the
same value is added to all its logits), so that each package's gradient
there is rounding noise, which Adam divides by its own magnitude into
steps of order lr; those elements are held to be finite.
Laplace's stage-2 variances, from the Fisher of per-example gradients
vmapped through the tensor-parallel forward, are within rtol 1e-5 of the
single process's.  The fused path (--fused_steps) under tensor
parallelism is bitwise the per-step path, and a cSGHMC run stopped after
its first epoch, saved and resumed in fresh runners is bitwise the
uninterrupted run.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests import torch_dist
from tests.test_torch_multichain_runner import HPARAMS

TOL = dict(rtol=1e-4, atol=1e-5)


def _nd0(hp: dict) -> dict:
    return dict(hp, nd="0.0") if "nd" in hp else dict(hp)


def _options(method: str, hp: dict) -> dict:
    if method == "csghmc_fs":
        return {"epochs": 3}
    if method == "csgld":  # and every θ it collects archived
        return {"full_sample": True}
    return {"epochs": 2} if "burnin" in hp else {}


# name -> (method, hparams, options); cSGHMC first (the resume's)
CASES = {m: (m, _nd0(hp), _options(m, hp)) for m, hp in HPARAMS.items()}
CASES = {"csghmc": CASES.pop("csghmc"), **CASES,
         "csghmc fused": ("csghmc", _nd0(HPARAMS["csghmc"]),
                          {"fused": True})}
METHODS = sorted(HPARAMS)


def _key_bias():
    """Bool [D]: the tiny ViT's key-bias elements (the middle third of each
    layer's qkv bias)."""
    from bayesdll_tpu_torch.core import flat as flat_util
    from bayesdll_tpu_torch.models.vit import ViT
    model = ViT(patch=16, dim=32, depth=2, heads=4, mlp_dim=64,
                image_size=32, num_classes=5)
    nested = {}
    for name, p in model.named_parameters():
        *outer, leaf = name.split(".")
        node = nested
        for part in outer:
            node = node.setdefault(part, {})
        node[leaf] = p
    mask = np.zeros(sum(p.numel() for p in model.parameters()), bool)
    for name, start, n in flat_util.leaf_spans(nested):
        if name == "layers/attention/qkv/bias":
            per_layer = mask[start:start + n].reshape(2, 3, 32)
            per_layer[:, 1] = True
    return mask


def _single_runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: torch_dist.method_run(m, hp, **kw)
                for name, (m, hp, kw) in CASES.items()}
    finally:
        torch.set_num_threads(n)


def _compute(workdir):
    cases = [(name, *case) for name, case in CASES.items()]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(torch_dist.run_world, torch_dist.tp_methods_world,
                            2, cases, workdir, timeout=240)
        single = _single_runs()
        return {"ranks": ranks.result(), "single": single}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp_methods"))
    return torch_dist.shared("tp_methods", lambda: _compute(workdir))


@pytest.mark.parametrize("method", METHODS)
def test_method_under_tp_matches_the_single_process_run(runs, method):
    ref = runs["single"][method]
    held = np.ones(ref["iterate"].shape[0], bool)
    if method.startswith("adam"):
        key_bias = _key_bias()
        held[:key_bias.shape[0]] = ~key_bias
    for rank in runs["ranks"]:
        got = rank[method]
        assert got["local"] * 2 == ref["iterate"].shape[0]
        assert len(got["losses"]) == len(ref["losses"])
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["iterate"][held],
                                   ref["iterate"][held], **TOL)
        assert np.isfinite(got["iterate"]).all()
        assert np.isfinite(got["nll"])
    a, b = (r[method] for r in runs["ranks"])
    np.testing.assert_array_equal(a["iterate"], b["iterate"])
    assert a["nll"] == b["nll"]
    if method == "csgld":  # --full_sample: every collected θ, whole
        assert len(ref["samples"]) == 1  # step 2 of 4 (thin 2)
        for rank in runs["ranks"]:
            assert rank[method]["samples"].keys() == ref["samples"].keys()
            for k, v in ref["samples"].items():
                np.testing.assert_allclose(rank[method]["samples"][k], v,
                                           **TOL)


def test_laplace_fisher_under_tp_matches_the_single_process(runs):
    ref = runs["single"]["la"]["vars"]
    prior = float(HPARAMS["la"]["prior_sig"]) ** 2
    # the data moved the variances off the prior's
    assert (ref < 0.999 * prior).sum() > 0.1 * ref.size
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["la"]["vars"], ref, rtol=1e-5)


def test_fused_under_tp_is_the_per_step_path(runs):
    for rank in runs["ranks"]:
        np.testing.assert_array_equal(rank["csghmc fused"]["iterate"],
                                      rank["csghmc"]["iterate"])
        assert rank["csghmc fused"]["losses"] == rank["csghmc"]["losses"]
    np.testing.assert_allclose(runs["ranks"][0]["csghmc fused"]["iterate"],
                               runs["single"]["csghmc fused"]["iterate"],
                               **TOL)


def test_resume_under_tp_is_the_uninterrupted_run(runs):
    for rank in runs["ranks"]:
        res = rank["resume"]
        assert res["start"] == 1
        for field in res["full"]:
            a, b = res["full"][field], res["resumed"][field]
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=field)
        assert res["loss"][0] == res["loss"][1]
