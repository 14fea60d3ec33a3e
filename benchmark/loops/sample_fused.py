"""The `sample_fused` loop: the `sample` loop (loops/sample.py) with the
mix's `fused_steps` on, so that every step, the check's first ones too,
goes through the runner's fused entry `run_steps`: on the card a replay
of one captured CUDA graph a step, the host dispatching nothing within a
segment.  The epochs of set-up, the window and the traced run are
`train_one_epoch`'s fused epochs, cut into segments at the runner's
FUSED_BYTES_BUDGET of stacked batches (256 MiB: three batches of 128
images at 224 x 224); their batches come from the host's gather.

The check's first steps are two segments of `run_steps` on the loader's
first batches (step 1 alone, so that v after it gives the first gradient
as the update received it; then the rest), replayed with the reference as
in `sample`.
"""

from __future__ import annotations

import numpy as np

from benchmark.loops import sample


class Loop(sample.Loop):

    def _first_steps(self):
        r = self.runner
        # the runner reads the switch at every epoch; the configuration
        # that build.port_config makes leaves it off
        r.cfg.fused_steps = bool(self.traffic["fused_steps"])
        it = iter(self.loader)
        self.batches = [next(it)[:2] for _ in range(self.traffic["check_steps"])]
        xs = np.stack([x for x, _ in self.batches])
        ys = np.stack([y for _, y in self.batches])
        first, _ = r.run_steps(0, xs[:1], ys[:1], 0)
        snap = {"v1": sample._host(r.state.v)}
        rest, _ = r.run_steps(0, xs[1:], ys[1:], 1)
        st = r.state
        snap.update(theta=sample._host(st.theta),
                    mean=sample._host(st.moments.mean),
                    var=sample._host(st.moments.mean_var()[1]),
                    losses=[float(v) for v in list(first) + list(rest)])
        self.snap = snap
