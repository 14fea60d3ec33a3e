"""In-memory array loader (copy of bayesdll_tpu.data.loader).

Training batches share one shape (`drop_last=True`).  Eval batches are
padded to the batch size with a `valid` 0/1 mask, which the metric code
applies.  `augment_fn(batch_x, rng)` transforms each batch with the
loader's RandomState after its indices are drawn (CIFAR's crop and flip),
so the draws come in the JAX package's order.

Two ways to iterate, with the same batches bit for bit, in the same order
and leaving the RandomState in the same state:

  * `iter(loader)`: numpy batches gathered on the host, which the runner
    moves to its device.  Every caller but the training epoch takes it.
  * `loader.batches_on(device)`: tensors gathered on `device` from a copy
    of `x` and `y` staged there at the first call and kept on the loader
    (on the CPU `torch.from_numpy`, no copy at all), the epoch's order
    uploaded once.  `Runner.train_one_epoch` takes it.  It serves
    `iter(loader)`'s batches instead where the loader augments (the
    draws stay on the host, in the JAX package's order) and on a card
    where the set is more than a quarter of the card's free memory when
    it first stages (`fits_on_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from bayesdll_tpu_torch.utils import profiling


def fits_on_device(nbytes: int, free_bytes: int) -> bool:
    """Whether a set of `nbytes` is staged on a card with `free_bytes` free:
    at most a quarter of it, the rest left to the model, its state and the
    steps' activations."""
    return 4 * nbytes <= free_bytes


class ArrayLoader:
    def __init__(self, x, y, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, augment_fn=None):
        if len(x) != len(y):
            raise ValueError(f"{len(x)} inputs but {len(y)} labels")
        self.x = np.asarray(x)
        self.y = np.asarray(y, dtype=np.int32)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self.n = len(x)
        self.augment_fn = augment_fn  # (batch_x, rng) -> batch_x
        self._staged = {}  # device -> (x, y, ones) there, or None: declined

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def eval_view(self):
        """An unshuffled view over the same examples that drops no batch
        (the last one padded, with its `valid` mask): the pass that must see
        every training example once, LA's Fisher.  It does not augment."""
        return ArrayLoader(self.x, self.y, self.batch_size, shuffle=False,
                           drop_last=False)

    def chain_view(self, c: int, epoch: int = 0):
        """A view over the same examples whose order is a pure function of
        (seed, chain, epoch), as the JAX package's: chain c of a multi-chain
        run sees the same batches in both packages, and a resumed run the
        same order with no replay of earlier epochs."""
        return ArrayLoader(self.x, self.y, self.batch_size,
                           shuffle=self.shuffle,
                           seed=(self._seed + 7919 * (c + 1)
                                 + 104729 * epoch) % (2 ** 31 - 1),
                           drop_last=self.drop_last,
                           augment_fn=self.augment_fn)

    @property
    def num_examples(self):
        return self.n

    def _order(self) -> np.ndarray:
        """The epoch's order of the examples: one shuffle of the
        RandomState."""
        idx = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def __iter__(self):
        idx = self._order()
        bs = self.batch_size
        for b in range(len(self)):
            with profiling.span("loader.gather"):
                sel = idx[b * bs:(b + 1) * bs]
                xb, yb = self.x[sel], self.y[sel]
                if self.augment_fn is not None:
                    xb = self.augment_fn(xb, self._rng)
                if len(sel) < bs:  # pad the final eval batch to the batch size
                    pad = bs - len(sel)
                    xb = np.concatenate(
                        [xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
                    yb = np.concatenate([yb, np.zeros((pad,), yb.dtype)])
                    valid = np.concatenate([np.ones(len(sel), np.float32),
                                            np.zeros(pad, np.float32)])
                else:
                    valid = np.ones(bs, np.float32)
            profiling.count("loader_batches", 1, "host")
            yield xb, yb, valid

    def _stage(self, device: torch.device):
        """(x, y, a batch of ones) on `device`, copied there at the first
        call and kept; None where the loader serves from the host."""
        if device not in self._staged:
            self._staged[device] = None
            nbytes = self.x.nbytes + self.y.nbytes
            if self.augment_fn is not None or (
                    device.type == "cuda" and not fits_on_device(
                        nbytes, torch.cuda.mem_get_info(device)[0])):
                return None
            with profiling.span("loader.stage"):
                self._staged[device] = (
                    torch.from_numpy(self.x).to(device),
                    torch.from_numpy(self.y).to(device),
                    torch.ones(self.batch_size, dtype=torch.float32,
                               device=device))
            profiling.count("staged_bytes", nbytes, device.type)
        return self._staged[device]

    def batches_on(self, device):
        """The epoch's batches as tensors on `device`, gathered there from
        the staged set: `iter(self)`'s batches and order, and its draws
        from the RandomState, bit for bit.  `iter(self)`'s own batches
        where `_stage` declines."""
        device = torch.device(device)
        staged = self._stage(device)
        if staged is None:
            yield from self
            return
        x, y, ones = staged
        idx = torch.from_numpy(self._order())
        if device.type == "cuda":
            idx = idx.pin_memory().to(device, non_blocking=True)
        bs = self.batch_size
        for b in range(len(self)):
            with profiling.span("loader.gather"):
                sel = idx[b * bs:(b + 1) * bs]
                xb, yb = x.index_select(0, sel), y.index_select(0, sel)
                if len(sel) < bs:  # pad the final eval batch to the batch size
                    pad = bs - len(sel)
                    xb = torch.cat([xb, xb.new_zeros((pad,) + xb.shape[1:])])
                    yb = torch.cat([yb, yb.new_zeros(pad)])
                    valid = torch.cat([ones[:len(sel)], ones.new_zeros(pad)])
                else:
                    valid = ones
            profiling.count("loader_batches", 1, "staged")
            yield xb, yb, valid
