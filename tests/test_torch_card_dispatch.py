"""The dispatchers of ops/fused.py on the card, called as the per-step path
calls them, with the seed, the step and the gate as host values: each
turns them into the kernels' int64 row (`kernels.dev_scalars`, a copy from
pinned host memory) without the host waiting on the card, and gives the
bits of the same call with the row built beforehand.

On a card (marker `card`; `python -m pytest tests/test_torch_card_dispatch.py
-m card` there).  The CPU path reads the row as the host values
(tests/test_torch_fused_steps.py::test_cpu_dispatch_reads_the_device_row).
"""

import pytest
import torch

from bayesdll_tpu_torch.ops import fused, kernels

D = 4096 + 3  # a scalar tail
SEED, STEP = 2**63 + 5, 2**32 + 9  # all 64 bits of each


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")


def _vectors():
    gen = torch.Generator(device="cuda").manual_seed(0)
    vec = {k: s * torch.randn(D, generator=gen, device="cuda")
           for k, s in (("g", 0.1), ("theta", 0.05), ("theta0", 0.05),
                        ("v", 0.01))}
    vec["lr"] = 1e-2 * (1.0 + torch.rand(D, generator=gen, device="cuda"))
    vec["mask"] = (torch.rand(D, generator=gen, device="cuda") > 0.1).float()
    vec.update({k: s * torch.randn(D, generator=gen, device="cuda")
                for k, s in (("m", 0.01), ("buf", 0.01))})
    vec["v2"] = 1e-3 * torch.rand(D, generator=gen, device="cuda")
    return vec


SG = dict(prior_sig=1.0, n_eff=1000.0, nd=1.0)
CALLS = {
    "csghmc_update_": lambda a, **kw: fused.csghmc_update_(
        a["g"], a["theta"], a["v"], lr=a["lr"], alpha=0.05, **SG, **kw),
    "sgld_update_": lambda a, **kw: (fused.sgld_update_(
        a["g"], a["theta"], a["theta0"], a["mask"], a["lr"], **SG, **kw),),
    "sghmc_update_": lambda a, **kw: fused.sghmc_update_(
        a["g"], a["theta"], a["theta0"], a["v"], a["mask"], a["lr"],
        alpha=0.05, **SG, **kw),
    "draw_": lambda a, **kw: (fused.draw_(
        a["g"], kind="normal", stream=kernels.STREAM_VI, **kw),),
    # the per-step path's bias corrections: a second row from pinned memory
    "adam_sghmc_update_": lambda a, **kw: fused.adam_sghmc_update_(
        a["g"], a["theta"], a["theta0"], a["v"], a["m"], a["v2"], a["buf"],
        3, a["mask"], a["lr"], add_g=False, momentum=0.0, sgd_count=2,
        alpha=0.05, beta1=0.9, beta2=0.999, eps_adam=1e-8, temperature=0.5,
        **SG, **kw),
}


@pytest.mark.card
def test_host_values_dispatch_without_a_host_wait(card):
    vec = _vectors()
    for name, call in CALLS.items():
        host = {k: t.clone() for k, t in vec.items()}
        row = {k: t.clone() for k, t in vec.items()}
        gate = {"should_sample": True} if name == "csghmc_update_" else {}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = call(host, seed=SEED, step=STEP, **gate)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = call(row, dev=kernels.dev_scalars(SEED, STEP, True))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        assert all(torch.equal(host[k], row[k]) for k in vec), name
