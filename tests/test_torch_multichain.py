"""The port's MultiChainRunner against the JAX package's on the same chain
states and data orders: two chains on one device (a (1, 1) mesh, so no
collective), nd = 0 and nst = 0, so no noise is drawn and the two agree up
to fp32 rounding.  The JAX trainer's jittered initial states reach the
port through `interop.chain_states`; both packages take chain c's batches
from `chain_view(c, epoch)`."""

import numpy as np
import pytest

from bayesdll_tpu.parallel import make_mesh
from bayesdll_tpu.parallel.runner import MultiChainRunner as JMultiChainRunner
from bayesdll_tpu_torch import interop
from bayesdll_tpu_torch.parallel import MultiChainRunner
from tests.test_torch_la import FISHER_TOL, LA_HP
from tests.test_torch_multichain_runner import one_thread  # noqa: F401
from tests.test_torch_sgld import HP, _pair

TOL = dict(rtol=1e-4, atol=1e-5)  # as tests/test_torch_csghmc.py
CSGHMC_HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.0", "thin": "2",
             "bias": "informative", "nst": "0", "momentum_decay": "0.05"}
N_CHAIN = 2


def _mc_pair(method, hp, *, momentum=0.0, epochs=2, lr=2e-2):
    """JAX and port multi-chain runners with the same chain states, on the
    same data (width 16, 163 training examples, batch 16)."""
    jr, tr, jl, tl = _pair(method, hp, momentum=momentum, epochs=epochs,
                           lr=lr, width=16, n_train=192, batch_size=16)
    jmc = JMultiChainRunner(jr, make_mesh(1, 1), n_chain=N_CHAIN)
    tmc = MultiChainRunner(tr, N_CHAIN)
    tmc.trainer.states, tmc.trainer.net_states = interop.chain_states(
        tr, jmc.trainer.states, jmc.trainer.net_states, N_CHAIN, "cpu")
    return jmc, tmc, jl, tl


def _state_close(t_state, j_states, c, fields):
    for f in fields:
        np.testing.assert_allclose(getattr(t_state, f).numpy(),
                                   np.asarray(getattr(j_states, f))[c],
                                   **TOL, err_msg=f)


CASES = {
    "csghmc": (CSGHMC_HP, 0.0, ("theta", "v")),
    "sgld": (HP, 0.5, ("theta", "buf")),
    "sghmc": (HP, 0.5, ("theta", "buf", "v")),
}


@pytest.mark.parametrize("method", sorted(CASES))
def test_two_chains_match_jax(method):
    hp, momentum, fields = CASES[method]
    jmc, tmc, jl, tl = _mc_pair(method, hp, momentum=momentum)
    for c in range(N_CHAIN):  # the same start, jitter included
        _state_close(tmc.trainer.states[c], jmc.trainer.states, c, fields)
    jres = jmc.train(*jl)
    tres = tmc.train(*tl)
    assert tmc.trainer.bi == jmc.trainer.bi == 2 * len(tl[0])
    js = jmc.trainer.states
    for c in range(N_CHAIN):
        st = tmc.trainer.states[c]
        _state_close(st, js, c, fields)
        if method == "csghmc":
            assert st.moments.n == int(np.asarray(js.moments.n)[c])
            _state_close(st.moments, js.moments, c, ("mean", "m2"))
        else:
            assert st.moments.cnt == int(np.asarray(js.moments.cnt)[c]) > 1
            _state_close(st.moments, js.moments, c, ("mom1", "mom2"))
    assert not np.allclose(tmc.trainer.iterates()[0].numpy(),
                           tmc.trainer.iterates()[1].numpy())
    if method == "csghmc":
        # the GMM predictive at nst = 0 draws nothing in either package (the
        # JAX package's Gaussian mixture of SGLD's and SGHMC's chains draws
        # one sample at nst = 0, parallel/runner.py:618; the port, as both
        # packages' single-chain runners, takes the mean)
        for key in ("nll", "test_loss"):
            assert abs(tres[key] - jres[key]) < 1e-3, key
        assert len(tmc.chain_cycle_stats) == N_CHAIN
        for ts, js_c in zip(tmc.chain_cycle_stats, jmc.chain_cycle_stats):
            assert sorted(ts) == sorted(js_c) == [1, 2]
            for cyc in ts:
                assert ts[cyc]["n"] == js_c[cyc]["n"] > 0
                np.testing.assert_allclose(ts[cyc]["likelihoods"],
                                           js_c[cyc]["likelihoods"], rtol=1e-4)
                np.testing.assert_allclose(ts[cyc]["mean"], js_c[cyc]["mean"],
                                           **TOL)
        tw, jw = tmc.gmm_weights_per_chain(), jmc.gmm_weights_per_chain()
        for a, b in zip(tw, jw):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k] == pytest.approx(b[k], rel=1e-3)


def test_laplace_two_chains_match_jax():
    """Each chain's best-val loss and iterate, and its stage-2 variance
    (rtol 2e-3, as tests/test_torch_la.py)."""
    jmc, tmc, jl, tl = _mc_pair("la", dict(LA_HP), momentum=0.5, epochs=3)
    jmc.train(*jl)
    tmc.train(*tl)
    jl_best, jt_best, _ = jmc._la_best
    tl_best, tt_best, _ = tmc._la_best
    np.testing.assert_allclose(tl_best, jl_best, rtol=1e-5)
    jmeans, jvars = (np.asarray(a) for a in jmc._la_stage2)
    tmeans, tvars = tmc._la_stage2
    for c in range(N_CHAIN):
        np.testing.assert_allclose(tt_best[c].numpy(), jt_best[c], **TOL)
        np.testing.assert_array_equal(tmeans[c].numpy(), tt_best[c].numpy())
        np.testing.assert_allclose(tvars[c].numpy(), jvars[c], **FISHER_TOL)
    assert not np.allclose(tmeans[0].numpy(), tmeans[1].numpy())
