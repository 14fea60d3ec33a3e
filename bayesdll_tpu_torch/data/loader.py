"""Host-side array loader (copy of bayesdll_tpu.data.loader).

Training batches share one shape (`drop_last=True`).  Eval batches are
padded to the batch size with a `valid` 0/1 mask, which the metric code
applies.  `augment_fn(batch_x, rng)` transforms each batch with the
loader's RandomState after its indices are drawn (CIFAR's crop and flip),
so the draws come in the JAX package's order.  Batches are numpy arrays;
the runner moves them to its device.
"""

from __future__ import annotations

import numpy as np

from bayesdll_tpu_torch.utils import profiling


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

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(idx)
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
            yield xb, yb, valid
