"""Bounded-window batch streaming (copy of bayesdll_tpu.data.stream).

Passes that visit every batch several times (one per Monte-Carlo sample)
take the loader in windows of stacked batches, so the loader is iterated
once per pass and peak memory is O(window), not O(dataset).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

DEFAULT_BYTES_BUDGET = 256 * 1024 * 1024


def batch_nbytes(batch) -> int:
    return sum(int(np.asarray(a).nbytes) for a in batch)


def window_size(first_batch, bytes_budget: int = DEFAULT_BYTES_BUDGET) -> int:
    return max(1, int(bytes_budget) // max(1, batch_nbytes(first_batch)))


def window_batches(
    loader, bytes_budget: int = DEFAULT_BYTES_BUDGET
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield windows of stacked batches: each item is a tuple of arrays
    shaped [k, ...] (k = window batches; the final window may be shorter).

    Only the current window's batches are ever materialized.
    """
    buf = []
    k = None
    for batch in loader:
        if k is None:
            k = window_size(batch, bytes_budget)
        buf.append(batch)
        if len(buf) == k:
            yield tuple(np.stack([b[i] for b in buf])
                        for i in range(len(buf[0])))
            buf = []
    if buf:
        yield tuple(np.stack([b[i] for b in buf]) for i in range(len(buf[0])))
