"""File-backed image loader with thread prefetch (counterpart of
bayesdll_tpu.data.image_loader).

Replaces the reference's `DataLoader(num_workers=4)` worker processes
(reference `datasets.py:104`) with a double-buffered thread pool: batch k+1
decodes and augments on the host while batch k trains on the card.  Batches
are numpy arrays, which the runner moves to its device.  Train batches all
have the batch size (drop_last); the final eval batch is padded, with its
`valid` mask.

Each train image draws its crop, flip and rotation from its own RandomState,
seeded by (epoch seed, index) as in the JAX package, so the batches do not
depend on which thread decoded which image and both packages give the same
batches for the same files and seed.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from bayesdll_tpu_torch.data import vision_transforms as vt


class ImageFileLoader:
    """Yields (x [B,S,S,3] float32 normalised, y [B] int32, valid [B])."""

    def __init__(self, paths, labels, batch_size: int, *, train: bool,
                 size: int = 224, seed: int = 0, num_threads: int = 4):
        if len(paths) != len(labels):
            raise ValueError(f"{len(paths)} images but {len(labels)} labels")
        self.paths = list(paths)
        self.labels = np.asarray(labels, np.int32)
        self.batch_size = int(batch_size)
        self.train = train
        self.size = size
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self.n = len(paths)
        self.num_threads = num_threads

    def __len__(self):
        if self.train:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    @property
    def num_examples(self):
        return self.n

    def eval_view(self):
        """Un-augmented, unshuffled view over the SAME images (eval
        transforms: resize+center-crop, no flip/crop jitter) — for LA
        stage-2 Fisher (reference `methods/la.py:375-387`)."""
        return ImageFileLoader(self.paths, self.labels, self.batch_size,
                               train=False, size=self.size,
                               num_threads=self.num_threads)

    def chain_view(self, c: int, epoch: int = 0):
        """Same files, shuffle/augment order a pure function of
        (seed, chain, epoch) — see ArrayLoader.chain_view."""
        return ImageFileLoader(self.paths, self.labels, self.batch_size,
                               train=self.train, size=self.size,
                               seed=(self._seed + 7919 * (c + 1)
                                     + 104729 * epoch) % (2 ** 31 - 1),
                               num_threads=self.num_threads)

    def _load_one(self, idx: int, epoch_rng_seed: int):
        img = vt.load_image(self.paths[idx])
        if self.train:
            rng = np.random.RandomState((epoch_rng_seed * 1_000_003 + idx)
                                        % (2 ** 31 - 1))
            return vt.train_transform(img, rng, self.size)
        return vt.eval_transform(img, self.size)

    def __iter__(self):
        idx = np.arange(self.n)
        if self.train:
            self._rng.shuffle(idx)
        epoch_seed = int(self._rng.randint(0, 2 ** 31 - 1))
        bs = self.batch_size
        nb = len(self)

        def make_batch(b):
            sel = idx[b * bs:(b + 1) * bs]
            with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
                imgs = list(ex.map(
                    lambda i: self._load_one(int(i), epoch_seed), sel))
            xb = np.stack(imgs).astype(np.float32)
            yb = self.labels[sel]
            if len(sel) < bs:
                pad = bs - len(sel)
                xb = np.concatenate(
                    [xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
                yb = np.concatenate([yb, np.zeros((pad,), yb.dtype)])
                valid = np.concatenate(
                    [np.ones(len(sel), np.float32), np.zeros(pad, np.float32)])
            else:
                valid = np.ones(bs, np.float32)
            return xb, yb, valid

        # double buffer: the next batch is prepared while this one is used
        with ThreadPoolExecutor(max_workers=1) as pipeline:
            fut = pipeline.submit(make_batch, 0)
            for b in range(nb):
                batch = fut.result()
                if b + 1 < nb:
                    fut = pipeline.submit(make_batch, b + 1)
                yield batch
