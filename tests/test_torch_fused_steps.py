"""The port's fused multi-step path (`fused_steps`, methods/graphed.py) on
the CPU, where the step body that the card captures as a CUDA graph runs
eagerly on the same static buffers and device-side scalars:
  * fused against per-step in the port, bit for bit (torch.equal), noise
    on, for all eleven methods (tests/test_fused_steps.py, which holds the
    JAX package's sgld, csghmc and vanilla, extended to the other eight),
    across cycle resets (and Adam-cSGHMC's t, moments and cold restarts)
    inside a fused epoch, and through the CLI;
  * the port's fused runs against the JAX package's, with no noise or with
    JAX's draws handed to the port (rtol 1e-4, atol 1e-5, as the port's
    parity tests);
  * `update_masked` and `segment_ends` against the JAX package's;
  * the dispatchers read the device row (seed, step, gate) on the CPU as
    the host values; a step that rebinds state tensors keeps the state's
    addresses on the fused path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesdll_tpu.core import moments as jmom
from bayesdll_tpu_torch.core import moments as tmom
from bayesdll_tpu_torch.methods import graphed
from bayesdll_tpu_torch.ops import fused, kernels, window_attention
from tests.test_torch_multichain import CSGHMC_HP as CSGHMC_HP0
from tests.test_torch_multichain_runner import (  # noqa: F401
    HPARAMS, build, one_thread)
from tests.test_torch_sgld import HP as SGLD_HP0
from tests.test_torch_sgld import _pair

FUSED = ("vanilla", "la", "sgld", "sghmc", "csgld", "csghmc", "csghmc_fs",
         "vi", "mc_dropout", "adam_sghmc", "adam_csghmc")
TOL = dict(rtol=1e-4, atol=1e-5)  # as tests/test_torch_sgld.py
# cSGHMC-FS with cold restarts: a restart writes θ inside a fused epoch
FS_HP = dict(HPARAMS["csghmc_fs"], perform_cold_restarts="1")


def hparams(method):
    return FS_HP if method == "csghmc_fs" else HPARAMS[method]


def trained(method, fused_steps, *, epochs=None, num_cycles=2,
            batch_size=16, momentum=0.5, hp=None):
    """A width-16 port runner trained on the CPU, with or without the fused
    path; returns (runner, results)."""
    epochs = epochs or (4 if method == "csghmc_fs" else 2)
    runner, loaders = build(method, hp or hparams(method), epochs=epochs,
                            num_cycles=num_cycles, batch_size=batch_size,
                            momentum=momentum)
    runner.cfg.fused_steps = fused_steps
    return runner, runner.train(*loaders)


def state_tensors(state):
    """Every tensor of a sampler state, its moments' included, by name."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": t
                        for k, t in state_tensors(v).items()})
    return out


def host_counts(state):
    """(step, Adam's t, moments count), None where the state has none."""
    m = getattr(state, "moments", None)
    return (state.step, getattr(state, "t", None), None if m is None
            else getattr(m, "cnt", getattr(m, "n", None)))


def assert_same_run(a, b):
    """Two runners' states, counts and cycle statistics bit for bit."""
    ta, tb = state_tensors(a.state), state_tensors(b.state)
    assert ta.keys() == tb.keys()
    for name in ta:
        assert torch.equal(ta[name], tb[name]), name
    assert host_counts(a.state) == host_counts(b.state)
    assert a.bi == b.bi
    stats_a, stats_b = (getattr(r, "cycle_stats", {}) for r in (a, b))
    assert stats_a.keys() == stats_b.keys()
    for c in stats_a:
        for k, v in stats_a[c].items():
            np.testing.assert_array_equal(v, stats_b[c][k], err_msg=k)


@pytest.mark.parametrize("method", FUSED)
def test_fused_equals_per_step(method):
    """Exact: the same kernels' plain versions, the same draws (keyed by
    (seed, step) read from the device row), the same moments arithmetic."""
    a, res_a = trained(method, False)
    b, res_b = trained(method, True)
    assert_same_run(a, b)
    assert res_a["train_losses"] == res_b["train_losses"]
    assert res_a["train_errors"] == res_b["train_errors"]
    assert res_a["nll"] == res_b["nll"]
    assert b._step_graphs and all(not g.graphs  # no capture on the CPU
                                  for g in b._step_graphs.values())


@pytest.mark.parametrize("method", ["csgld", "csghmc", "csghmc_fs"])
def test_cycle_resets_inside_a_fused_epoch(method):
    """Four cycles in one epoch of 20 steps: three cycle ends fall inside
    the epoch, so segments end there, the moments are cleared (and, for
    cSGHMC-FS, v zeroed and θ restarted) in place between segments, and the
    next segment's steps read the reset state."""
    a, _ = trained(method, False, epochs=1, num_cycles=4, batch_size=8)
    b, _ = trained(method, True, epochs=1, num_cycles=4, batch_size=8)
    assert_same_run(a, b)
    assert sorted(b.cycle_stats) == [1, 2, 3, 4]
    b.bi = 0
    assert b.segment_ends(0, 20) == [5, 10, 15, 20]


def test_resets_keep_the_state_addresses():
    """The cycle reset and SGLD's burn-in seeding write in place, so the
    graph captured before them keeps reading the live tensors."""
    r, loaders = build("csghmc_fs", FS_HP, epochs=4)
    r._ensure_sched(len(loaders[0]))
    r._train_loader = loaders[0]
    before = {k: t.data_ptr() for k, t in state_tensors(r.state).items()}
    r._end_of_cycle(1)
    assert {k: t.data_ptr() for k, t in state_tensors(r.state).items()} \
        == before
    s, _ = build("sgld", HPARAMS["sgld"])
    before = {k: t.data_ptr() for k, t in state_tensors(s.state).items()}
    s.epoch_begin(int(s.burnin))
    assert s.state.moments.cnt == 1
    assert torch.equal(s.state.moments.mom1, s.state.theta)
    assert {k: t.data_ptr() for k, t in state_tensors(s.state).items()} \
        == before


def test_run_steps_equals_step_loop_with_a_short_segment():
    """run_steps of one step, then of the rest: the segment boundary falls
    anywhere without changing a bit."""
    a, la = build("sghmc", HPARAMS["sghmc"], momentum=0.5)
    b, _ = build("sghmc", HPARAMS["sghmc"], momentum=0.5)
    xs = np.stack([x for x, _, _ in la[0]])
    ys = np.stack([y for _, y, _ in la[0]])
    for r in (a, b):
        r.epoch_begin(1)
    loss_a, err_a = a.step_loop(1, xs, ys, 0)
    l1, e1 = b.run_steps(1, xs[:1], ys[:1], 0)
    l2, e2 = b.run_steps(1, xs[1:], ys[1:], 1)
    assert torch.equal(loss_a, torch.cat([l1, l2]))
    assert torch.equal(err_a, torch.cat([e1, e2]))
    assert_same_run(a, b)


# method -> (hparams, momentum, lr, state fields held to the JAX package's,
# whether the predictive is compared).  The Adam methods at nd = 0 (no
# noise); MC-dropout with JAX's keep-mask uniforms handed to the port
# (`hand_jax_draws`); its predictive draws its masks from each package's
# own generator, so only its state is compared.
ADAM_HP0 = dict(SGLD_HP0, beta1="0.9", beta2="0.999", epsilon="1e-8",
                nd="0.0")
JAX_CASES = {
    "sgld": (dict(SGLD_HP0), 0.5, 2e-2, ("theta", "buf"), True),
    "csghmc": (dict(CSGHMC_HP0), 0.0, 2e-2, ("theta", "v"), True),
    "mc_dropout": (dict(HPARAMS["mc_dropout"], bias="gaussian"), 0.5, 2e-2,
                   ("m", "buf"), False),
    "adam_sghmc": (ADAM_HP0, 0.5, 1e-3, ("theta", "buf", "v_mom", "m", "v2"),
                   True),
    "adam_csghmc": (dict(ADAM_HP0, temperature="2.0"), 0.5, 1e-3,
                    ("theta", "buf", "v_mom", "m", "v2"), True),
}


def hand_jax_draws(jr, tr):
    """The port's VI and MC-dropout step draws become the JAX package's:
    the draw from the key JAX folds from the global step, which on the
    fused path the port reads from the scalars' device row."""
    dim = tr.target.dim

    def key(step, scalars):
        step = int(scalars["dev"][1]) if step is None else step
        return jax.random.fold_in(jr.train_key, step)

    def uniform(step, scalars):
        kz, _ = jax.random.split(key(step, scalars))
        return torch.from_numpy(np.array(jax.random.uniform(kz, (dim,))))
    tr._train_normal = lambda step, scalars: torch.from_numpy(
        np.array(jax.random.normal(key(step, scalars), (dim,))))
    tr._train_uniform = uniform


@pytest.mark.parametrize("method", sorted(JAX_CASES))
def test_fused_matches_jax_fused(method):
    """The port's fused training against the JAX package's fused (scanned)
    training from the same θ on the same batches, with no noise or the
    same draws: the state within TOL, the counts (Adam's t included)
    equal; with a predictive that draws nothing of its own, nll and ece
    within 1e-3; for Adam-cSGHMC each cycle's moments within TOL."""
    hp, momentum, lr, fields, eval_same = JAX_CASES[method]
    jr, tr, jl, tl = _pair(method, hp, momentum=momentum, lr=lr, width=16,
                           n_train=192, batch_size=16)
    hand_jax_draws(jr, tr)
    jr.cfg.fused_steps = tr.cfg.fused_steps = True
    jres = jr.train(*jl)
    tres = tr.train(*tl)
    for f in fields:
        np.testing.assert_allclose(getattr(tr.state, f).numpy(),
                                   np.asarray(getattr(jr.state, f)), **TOL,
                                   err_msg=f)
    tm, jm = tr.state.moments if hasattr(tr.state, "moments") else None, \
        getattr(jr.state, "moments", None)
    if tm is not None:
        assert getattr(tm, "cnt", getattr(tm, "n", None)) == \
            int(getattr(jm, "cnt", getattr(jm, "n", -1)))
    if hasattr(tr.state, "t"):
        assert tr.state.t == int(jr.state.t)
    assert tr.bi == jr.bi
    for c, stats in getattr(tr, "cycle_stats", {}).items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[k], np.asarray(
                jr.cycle_stats[c][k]), **TOL, err_msg=f"cycle {c} {k}")
    if eval_same:
        for key in ("nll", "ece"):
            assert abs(tres[key] - jres[key]) < 1e-3, key


def test_vi_fused_steps_with_jax_draws_match_jax():
    """VI's fused segment of three steps against the JAX package's scanned
    segment, JAX's eps handed to the port, at the smoke matrix's kld 1e-5:
    m and its buffer within TOL and s_ as tests/test_torch_vi_mcd.py holds
    it over three steps (g_s takes (theta - m) / s, so an ulp of m left
    different by the two packages' matmuls moves a few elements of s_ by
    up to ~0.4%).  Longer runs amplify that gap step by step."""
    jr, tr, jl, tl = _pair("vi", dict(HPARAMS["vi"], nst="0"),
                           momentum=0.5, width=16, n_train=192,
                           batch_size=16)
    hand_jax_draws(jr, tr)
    xs = np.stack([x for x, _, _ in tl[0]])[:3]
    ys = np.stack([y for _, y, _ in tl[0]])[:3]
    jloss, _ = jr.run_steps(0, jnp.asarray(xs), jnp.asarray(ys), 0)
    tloss, _ = tr.run_steps(0, xs, ys, 0)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5)
    for f in ("m", "buf_m"):
        np.testing.assert_allclose(getattr(tr.state, f).numpy(),
                                   np.asarray(getattr(jr.state, f)), **TOL,
                                   err_msg=f)
    ts, js = tr.state.s_.numpy(), np.asarray(jr.state.s_)
    rel = np.abs(ts - js) / np.abs(js)
    assert (rel <= 1e-4).mean() >= 0.99 and rel.max() < 1e-2, rel.max()
    assert tr.state.step == int(jr.state.step) == 3


def test_adam_csghmc_cycle_end_inside_a_fused_epoch():
    """Adam-cSGHMC with cold restarts, four cycles in one epoch of 20 steps:
    segments end at the cycle ends inside the epoch, where t, v_mom, m, v2
    and buf are reset and θ re-drawn in place; the next segment's bias
    corrections count t from 0 again.  Bitwise the per-step run, noise
    on, t included."""
    hp = dict(HPARAMS["adam_csghmc"], perform_cold_restarts="1")
    a, _ = trained("adam_csghmc", False, epochs=1, num_cycles=4,
                   batch_size=8, hp=hp)
    b, _ = trained("adam_csghmc", True, epochs=1, num_cycles=4, batch_size=8,
                   hp=hp)
    assert_same_run(a, b)
    assert sorted(b.cycle_stats) == [1, 2, 3, 4]
    b.bi = 0
    assert b.segment_ends(0, 20) == [5, 10, 15, 20]
    # the rows of a segment that starts after a cycle end count from t = 0
    b.state.t = 0
    _, flts = b.fused_rows(0, 5, 5)
    beta1, beta2 = b.adam["beta1"], b.adam["beta2"]
    for j in range(5):
        assert tuple(flts[j, 3:]) == fused.adam_bias_corrections(
            j + 1, beta1, beta2)


@pytest.mark.parametrize("flags", [(1, 1, 0, 1, 1), (0, 0, 0), (1, 0, 1, 0)],
                         ids=["mostly-on", "off", "alternating"])
@pytest.mark.parametrize("name", ["RunningMoments", "WelfordMoments",
                                  "RefWelfordMoments"])
def test_update_masked_matches_jax(name, flags):
    """The masked update against the JAX package's (its count advanced on
    the device), and bit for bit against the port's own update."""
    dim = 1000
    rng = np.random.RandomState(len(flags))
    samples = (rng.randn(len(flags), dim) * 3 + 1).astype(np.float32)
    jcls, tcls = getattr(jmom, name), getattr(tmom, name)
    j = jcls.zeros(dim)
    t = tcls.zeros(dim, "cpu")
    ref = tcls.zeros(dim, "cpu")
    cnt = torch.zeros(())
    for s, c in zip(samples, flags):
        j = j.update_masked(jnp.asarray(s), bool(c))
        t.update_masked(torch.from_numpy(s), torch.tensor(float(c)), cnt)
        if c:
            ref.update(torch.from_numpy(s))
    t.advance(sum(flags))
    jn = int(getattr(j, "cnt", getattr(j, "n", -1)))
    tn = getattr(t, "cnt", getattr(t, "n", None))
    assert tn == jn == int(cnt) == getattr(ref, "cnt", getattr(ref, "n", None))
    for f in ("mom1", "mom2", "mean", "m2"):
        if hasattr(t, f):
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       np.asarray(getattr(j, f)),
                                       rtol=1e-6, atol=1e-5, err_msg=f)
            assert torch.equal(getattr(t, f), getattr(ref, f)), f


@pytest.fixture(scope="module")
def csgld_pair():
    """JAX and port cSGLD runners with a schedule of 5 cycles over 2 epochs
    of 10 steps: a cycle ends at every 4th step, several inside one
    epoch."""
    jr, tr, jl, tl = _pair("csgld", dict(SGLD_HP0), width=16, n_train=192,
                           batch_size=16, num_cycles=5)
    n = len(tl[0])
    assert n == len(jl[0]) == 10
    jr._ensure_sched(n)
    tr._ensure_sched(n)
    return jr, tr, n


@pytest.mark.parametrize("bi0", [0, 7, 13])
def test_segment_ends_match_jax(csgld_pair, bi0):
    jr, tr, n = csgld_pair
    jr.bi = tr.bi = bi0
    ends = tr.segment_ends(0, n)
    assert ends == list(jr.segment_ends(0, n))
    assert len(ends) >= 2


def test_fused_rows_are_the_step_scalars():
    """The host rows the graph indexes carry step_scalars' values: the
    step, the gate, the collect flag and the lr pair rounded to fp32."""
    r, loaders = build("csghmc", HPARAMS["csghmc"], num_cycles=2)
    r._ensure_sched(len(loaders[0]))
    r.bi = 3
    ints, flts = r.fused_rows(1, 5, 8)
    assert r.bi == 3
    for j in range(8):
        r.bi = 5 + j
        sc = r.step_scalars(1)
        assert ints[j, 0] == r.seed and ints[j, 1] == 5 + j
        assert ints[j, 2] == int(sc["should_sample"])
        assert flts[j, 2] == float(sc["collect"])
        assert flts[j, 0] == np.float32(sc["lr"])
        assert float(flts[j, 1]) == r.lr_pair(sc["lr"])[1]
        assert tuple(flts[j, 3:]) == (1.0, 1.0)  # no Adam: bc1 = bc2 = 1


@pytest.mark.parametrize("method", ["adam_sghmc", "adam_csghmc"])
def test_steps_keep_the_state_addresses(method):
    """The Adam step writes v_mom, m and v2 in place, per step and fused,
    so the addresses a captured graph reads stay the state's, and t
    advances by one a step; a step that binds a state field to a new
    tensor is refused on the fused path."""
    r, loaders = build(method, HPARAMS[method])
    if method == "adam_csghmc":
        r._ensure_sched(len(loaders[0]))
    xs = np.stack([x for x, _, _ in loaders[0]])[:3]
    ys = np.stack([y for _, y, _ in loaders[0]])[:3]
    before = {k: t.data_ptr() for k, t in state_tensors(r.state).items()}
    r.step_loop(1, xs[:1], ys[:1], 0)
    r.run_steps(1, xs[1:], ys[1:], 1)
    assert {k: t.data_ptr() for k, t in state_tensors(r.state).items()} \
        == before
    assert r.state.t == r.state.step == 3
    assert float(r.state.m.abs().max()) > 0
    step = r._step

    def rebinding(state, *args):
        out = step(state, *args)
        state.v2 = state.v2.clone()
        return out
    r._step = rebinding
    with pytest.raises(RuntimeError, match=r"in place.*\['v2'\]"):
        r.run_steps(1, xs[:1], ys[:1], 3)


# method -> (hparams, extra flags) of a CLI run: cSGHMC as the module
# docstring's example; Adam-cSGHMC at the smoke matrix's settings with cold
# restarts and two cycles in its one epoch, so a cycle end, its reset and a
# restart fall inside the fused epoch
CLI_CASES = {
    "csghmc": ("prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,bias=informative,"
               "nst=2", ["--num_cycles", "1"]),
    "adam_csghmc": ("prior_sig=1.0,Ninflate=1.0,nd=0.01,thin=2,"
                    "bias=informative,nst=2,perform_cold_restarts=1",
                    ["--num_cycles", "2"]),
}


@pytest.mark.parametrize("method", sorted(CLI_CASES))
def test_cli_fused_steps_same_results(method, tmp_path, monkeypatch):
    """`--fused_steps` through the port's CLI on the CPU gives the RESULTS
    of the same run without it (the full-width MLP on a synthetic set cut
    to 300 training examples)."""
    import bayesdll_tpu_torch.data as data
    from bayesdll_tpu_torch.cli import demo
    prepare_full = data.prepare

    def small(cfg):
        cfg.synthetic_n_train, cfg.synthetic_n_test = 300, 64
        return prepare_full(cfg)
    monkeypatch.setattr(data, "prepare", small)
    hp, extra = CLI_CASES[method]
    args = ["--method", method, "--dataset", "synthetic", "--epochs", "1",
            "--batch_size", "64", "--lr", "1e-3", "--device", "cpu",
            "--hparams", hp, *extra]
    plain = demo.main(args + ["--log_dir", str(tmp_path / "plain")])
    fused_res = demo.main(args + ["--log_dir", str(tmp_path / "fused"),
                                  "--fused_steps"])
    for key in ("train_losses", "train_errors", "nll", "ece", "mce",
                "test_err", "best_epoch"):
        assert fused_res[key] == plain[key], key


def test_cpu_dispatch_reads_the_device_row():
    """On the CPU the dispatchers read (seed, step, gate) from the row, an
    int64 tensor that keeps the seed's 64 bits, and give the bits of the
    call with host values."""
    gen = torch.Generator().manual_seed(0)
    d = 1027
    g, th, th0, v = (torch.randn(d, generator=gen) for _ in range(4))
    mask, lr = torch.ones(d), torch.full((d,), 1e-2)
    seed = 2**63 + 12345  # the row keeps all 64 bits
    dev = kernels.dev_scalars(seed, 9, True, device="cpu")
    assert dev.dtype == torch.int64 and dev.tolist() == [seed - 2**64, 9, 1]
    assert kernels.dev_scalars(2**64 - 1, 3, device="cpu").tolist() \
        == [-1, 3, 0]
    kw = dict(prior_sig=1.0, n_eff=100.0, nd=1.0)
    a = [t.clone() for t in (g, th, v)]
    b = [t.clone() for t in (g, th, v)]
    fused.csghmc_update_(*a, alpha=0.05, lr=lr, should_sample=True,
                         seed=seed, step=9, **kw)
    fused.csghmc_update_(*b, alpha=0.05, lr=lr, dev=dev, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a, b = g.clone(), g.clone()
    fused.sgld_update_(a, th, th0, mask, lr, seed=seed, step=9, **kw)
    fused.sgld_update_(b, th, th0, mask, lr, dev=dev, **kw)
    assert torch.equal(a, b)
    a = [g.clone(), v.clone()]
    b = [g.clone(), v.clone()]
    fused.sghmc_update_(a[0], th, th0, a[1], mask, lr, alpha=0.05, seed=seed,
                        step=9, **kw)
    fused.sghmc_update_(b[0], th, th0, b[1], mask, lr, alpha=0.05, dev=dev,
                        **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_launch_counts_round_trip():
    saved = kernels.launch_counts()
    try:
        kernels.set_launch_counts({n: 5 for n in saved})
        assert kernels.launch_counts() == {n: 5 for n in saved}
        assert set(saved) == set(kernels.KERNELS) | set(
            window_attention.KERNELS)
    finally:
        kernels.set_launch_counts(saved)


@pytest.mark.parametrize("backbone", ["resnet_mini", "vit_tiny"])
def test_fused_equals_per_step_on_other_backbones(backbone):
    """A ResNet with one bottleneck per stage (BatchNorm: the fused step
    copies the new running statistics into the static net_state) and
    vit_tiny, cSGHMC with noise on: the fused segment bit for bit the
    per-step loop, BatchNorm statistics included."""
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models import create_backbone
    from bayesdll_tpu_torch.models.resnet import ResNet

    rng = np.random.RandomState(1)
    hw, classes, steps, batch = 32, 5, 4, 8
    xs = rng.randn(steps, batch, hw, hw, 3).astype(np.float32)
    ys = rng.randint(0, classes, (steps, batch)).astype(np.int32)
    runners = []
    for _ in range(2):
        cfg = Config(method="csghmc", hparams=dict(HPARAMS["csghmc"]),
                     dataset="synthetic", backbone=backbone, epochs=1,
                     batch_size=batch, lr=1e-3, num_cycles=1, seed=0,
                     device="cpu")
        if backbone == "resnet_mini":
            model, stats = ResNet((1, 1, 1, 1), classes), True
        else:
            model, _, meta = create_backbone("vit_tiny", num_classes=classes)
            stats = meta["has_batch_stats"]
        target, theta, ns = make_flat_target(
            model, nd_size=64, num_classes=classes,
            rng=torch.Generator().manual_seed(0), has_batch_stats=stats,
            device="cpu")
        r = get_runner_cls("csghmc")(target, theta, ns, cfg)
        r._ensure_sched(steps)
        runners.append(r)
    a, b = runners
    la, _ = a.step_loop(0, xs, ys, 0)
    lb, _ = b.run_steps(0, xs, ys, 0)
    assert torch.equal(la, lb)
    assert_same_run(a, b)
    sa, sb = (list(graphed._tensors(r.net_state)) for r in (a, b))
    assert len(sa) == len(sb) == (34 if backbone == "resnet_mini" else 0)
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_segments_cut_at_ends_and_at_the_budget():
    """The epoch's cuts: after each segment end, and whenever the next
    batch would pass the byte budget (here 3 batches' worth), as the JAX
    package's `_train_one_epoch_fused` cuts."""
    x, y = np.zeros((4, 8), np.float32), np.zeros(4, np.int32)
    per = x.nbytes + y.nbytes
    got = [(len(xs), at_end) for xs, _, at_end in graphed.segments(
        ((x, y) for _ in range(10)), 10, [2, 7], 3 * per)]
    assert got == [(2, True), (3, False), (2, True), (3, True)]
    # a budget below one batch still takes a batch a segment
    assert [len(xs) for xs, _, _ in graphed.segments(
        ((x, y) for _ in range(3)), 3, [], 1)] == [1, 1, 1]
