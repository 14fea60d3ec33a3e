"""ArrayLoader's staged iteration (`batches_on`): the in-memory set copied
to the device once and each batch gathered there.  Its batches, their
order and the loader's RandomState are `iter(loader)`'s bit for bit; a
loader that augments, or a set too large for the card's free memory,
serves the host's batches; the copy is made and counted once; and a
cSGHMC epoch through `train_one_epoch` on the staged batches is the same
steps through `step_loop` on the host's, bit for bit."""

import numpy as np
import pytest
import torch

from bayesdll_tpu_torch.data.loader import ArrayLoader, fits_on_device
from bayesdll_tpu_torch.utils import profiling
from tests.test_torch_multichain_runner import (CSGHMC_HP, build,  # noqa: F401
                                                one_thread)


@pytest.fixture
def recording():
    """The recorder on and empty for the test, off and empty after."""
    was = profiling.enable(True)
    profiling.reset()
    yield
    profiling.enable(was)
    profiling.reset()


def _twins(shuffle=True, drop_last=False, augment_fn=None, n=37, bs=8):
    """Two loaders over the same seeded set with the same seed."""
    rs = np.random.RandomState(5)
    x = rs.randn(n, 3, 2).astype(np.float32)
    y = rs.randint(0, 10, n)
    return [ArrayLoader(x, y, bs, shuffle=shuffle, seed=11,
                        drop_last=drop_last, augment_fn=augment_fn)
            for _ in range(2)]


def _flip(xb, rng):
    """An augment that draws from the loader's RandomState."""
    return xb * rng.choice([-1.0, 1.0], size=(len(xb), 1, 1)).astype(
        xb.dtype)


def _assert_same_batch(staged, host):
    for s, h in zip(staged, host):
        s = torch.as_tensor(s)
        assert s.dtype == torch.from_numpy(h).dtype
        assert torch.equal(s, torch.from_numpy(h))


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [True, False])
def test_staged_batches_are_the_host_batches_bit_for_bit(shuffle, drop_last):
    staged, host = _twins(shuffle=shuffle, drop_last=drop_last)
    for _ in range(2):
        s_batches, h_batches = list(staged.batches_on("cpu")), list(host)
        assert len(s_batches) == len(h_batches) == len(host)
        for s, h in zip(s_batches, h_batches):
            assert all(isinstance(t, torch.Tensor) for t in s)
            _assert_same_batch(s, h)
        for a, b in zip(staged._rng.get_state(), host._rng.get_state()):
            assert np.array_equal(a, b)


def test_a_loader_that_augments_serves_the_host_batches(recording):
    staged, host = _twins(augment_fn=_flip)
    s_batches, h_batches = list(staged.batches_on("cpu")), list(host)
    assert all(isinstance(t, np.ndarray) for b in s_batches for t in b)
    for s, h in zip(s_batches, h_batches):
        _assert_same_batch(s, h)
    counters = profiling.snapshot()["counters"]
    assert counters["loader_batches"] == {"host": 2 * len(host)}
    assert "staged_bytes" not in counters


@pytest.mark.parametrize("free_per_byte, fits", [
    (4, True), (100, True), (3.99, False), (1, False)])
def test_the_fit_rule_stages_at_most_a_quarter_of_free_memory(
        free_per_byte, fits):
    nbytes = 1_987_117_056  # 3,312 images at 224^2 x 3 in fp32
    assert fits_on_device(nbytes, int(free_per_byte * nbytes)) is fits


def test_a_set_too_large_for_the_card_serves_the_host_batches(
        monkeypatch, recording):
    """On a card whose free memory is under four times the set, nothing is
    copied to it: the batches are the host's, and the card is asked once."""
    staged, host = _twins()
    nbytes = staged.x.nbytes + staged.y.nbytes
    asked = []

    def mem_get_info(device=None):
        asked.append(device)
        return 4 * nbytes - 1, 80 * 2 ** 30

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    for _ in range(2):
        for s, h in zip(staged.batches_on("cuda"), host):
            assert all(isinstance(t, np.ndarray) for t in s)
            _assert_same_batch(s, h)
    assert len(asked) == 1
    counters = profiling.snapshot()["counters"]
    assert counters["loader_batches"] == {"host": 4 * len(host)}
    assert "staged_bytes" not in counters


def test_the_set_is_staged_and_counted_once(recording):
    loader, _ = _twins()
    nbytes = loader.x.nbytes + loader.y.nbytes
    for epoch in range(2):
        profiling.reset()
        list(loader.batches_on("cpu"))
        snap = profiling.snapshot()
        stages = [s for s in snap["spans"] if s["name"] == "loader.stage"]
        assert len(stages) == (1 if epoch == 0 else 0)
        assert snap["counters"]["loader_batches"] == {"staged": len(loader)}
        assert snap["counters"].get("staged_bytes") == (
            {"cpu": nbytes} if epoch == 0 else None)
    # on the CPU the staged set is the loader's own memory
    x, y, _ = loader._stage(torch.device("cpu"))
    assert x.data_ptr() == loader.x.ctypes.data
    assert y.data_ptr() == loader.y.ctypes.data


def test_csghmc_epoch_on_staged_batches_is_step_loop_on_host_batches(
        recording):
    """One cSGHMC epoch (no cycle end in it) through train_one_epoch, which
    gathers from the staged set, against the same steps through step_loop
    on iter(loader)'s batches: θ, v, the moments and the epoch's loss and
    error bitwise, and the loaders' RandomStates equal after."""
    (a, (train_a, _, _)), (b, (train_b, _, _)) = [
        build("csghmc", CSGHMC_HP, epochs=4, num_cycles=1)
        for _ in range(2)]
    for r, train in ((a, train_a), (b, train_b)):
        r.cfg.proportion_exploration = 0.0
        r._ensure_sched(len(train))
        r._train_loader = train
    assert isinstance(train_a, ArrayLoader)
    loss_a, err_a = a.train_one_epoch(0, train_a)
    assert profiling.snapshot()["counters"]["loader_batches"] == {
        "staged": len(train_a)}
    batches = list(train_b)
    losses, errs = b.step_loop(0, [x for x, _, _ in batches],
                               [y for _, y, _ in batches], 0)
    bs, nb = train_b.batch_size, len(batches) * train_b.batch_size
    assert loss_a == float(losses.sum()) * bs / nb
    assert err_a == float(errs.sum()) / nb
    assert a.bi == b.bi == len(batches)
    sa, sb = a.state, b.state
    for name in ("theta", "v"):
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    assert sa.moments.n == sb.moments.n > 0
    assert torch.equal(sa.moments.mean, sb.moments.mean)
    assert torch.equal(sa.moments.m2, sb.moments.m2)
    for x, y in zip(train_a._rng.get_state(), train_b._rng.get_state()):
        assert np.array_equal(x, y)
