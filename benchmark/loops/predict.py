"""The `predict` loop: the GMM posterior predictive, one pass of
`runner.evaluate` over an in-memory test set after another (closed loop).

Set-up builds the runner and hands it `components` completed cycles as
the cycle ends leave them (means, variances and likelihoods as host numpy
arrays in `cycle_stats`), made from the seed (build.components); a
ResNet's running batch statistics are those of the reference's
training-mode forward of the first test batch at the base weights.  One
pass over a single batch warms every shape and the pinned uploads.  The
window runs whole passes until `seconds` have passed.  A batch fails where
its predictive is not finite.

The check samples `check_batches` batches from the seed and compares the
last pass's mixture log-probabilities for them with the reference's,
which draws the same parameters from the same generators.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from scipy.special import logsumexp

from benchmark import build, compare, trace
from benchmark.reference import models, precision, predictive


class Loop:
    metric = "predict_img_per_s"
    training = False

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic

    def setup(self, warm: bool = True):
        """Build and, with `warm`, run one batch's pass."""
        c, t, dev = self.config, self.traffic, self.device
        from bayesdll_tpu_torch.data import ArrayLoader
        cfg = build.port_config(c, t, self.seed, dev)
        tgt, ns, self.layout = build.target(cfg, c, t["train_examples"],
                                            self.seed, dev)
        self.x, self.y = build.images(c, t["test_examples"], self.seed, 1, dev)
        base = build.theta(self.layout, self.seed, dev)
        self.stats = None
        if "batch_stats" in ns:
            with precision.fp32_products():
                self.stats = models.batch_stats(
                    self.layout.unravel(base),
                    torch.as_tensor(self.x[:c["batch_size"]], device=dev), c)
            ns = {"batch_stats": build.nested_stats(self.stats)}
        self.comps = build.components(self.layout, base, t, self.seed, dev)
        self.runner = build.runner(cfg, tgt, base, ns)
        del base
        self.runner.cycle_stats = {
            cyc: dict(comp, n=0, theta=None) for cyc, comp in self.comps.items()}
        self.runner.current_cycle = max(self.comps)
        bs = c["batch_size"]
        self.loader = ArrayLoader(self.x, self.y, bs)
        if warm:
            self.runner.evaluate(ArrayLoader(self.x[:bs], self.y[:bs], bs))
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _failed_batches(self, logits) -> int:
        bs = self.config["batch_size"]
        bad = ~np.isfinite(logits).all(axis=1)
        return int(sum(bad[i:i + bs].any() for i in range(0, len(bad), bs)))

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        passes = failed = 0
        while True:
            self.out = self.runner.evaluate(self.loader)
            passes += 1
            failed += self._failed_batches(self.out[3])
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        dt = time.perf_counter() - t0
        return {"seconds": dt, "attempted": passes * len(self.loader),
                "failed": failed, "rate": passes * len(self.x) / dt}

    def traced(self):
        """`trace_passes` whole passes under the device profile; a pass
        over the first `host_trace_batches` batches under the host
        profile, which names the idle gaps."""
        n, bs = self.traffic["trace_passes"], self.config["batch_size"]
        k = self.traffic["host_trace_batches"] * bs
        from bayesdll_tpu_torch.data import ArrayLoader
        part = ArrayLoader(self.x[:k], self.y[:k], bs)
        tr = trace.record(lambda: [self.runner.evaluate(self.loader)
                                   for _ in range(n)],
                          lambda: self.runner.evaluate(part))
        draws = len(self.comps) * max(1, self.traffic["nst"])
        return {"passes": n, "images": n * len(self.x),
                "forwards": n * len(self.loader) * draws}, tr

    def free(self):
        self.runner = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check --------------------------------------------------------

    def check_batches(self):
        n = len(self.loader)
        rng = np.random.default_rng(build.derived_seed(self.seed, build.CHECK))
        return sorted(rng.choice(n, min(n, self.traffic["check_batches"]),
                                 replace=False).tolist())

    def program_logp(self, i: int) -> torch.Tensor:
        """The last pass's log-probabilities of batch i's valid rows."""
        bs = self.config["batch_size"]
        mix = self.out[3][i * bs:(i + 1) * bs].astype(np.float64)
        return torch.from_numpy(mix - logsumexp(mix, axis=-1, keepdims=True))

    def device_components(self):
        """(weight, mean, var, cycle) on the device, the weights the
        reference's own."""
        dev = self.device
        weights = predictive.gmm_weights(
            {cyc: comp["likelihoods"] for cyc, comp in self.comps.items()})
        return [(weights[cyc], torch.as_tensor(comp["mean"], device=dev),
                 torch.as_tensor(comp["var"], device=dev), cyc)
                for cyc, comp in sorted(self.comps.items())]

    def reference_logp(self, comps, i: int, prec: str = "fp32",
                       draw_scale: float = 1.0) -> torch.Tensor:
        """The reference's log-probabilities of batch i, its products in
        `prec`, each draw's deviation times `draw_scale`."""
        c, dev, lay = self.config, self.device, self.layout
        bs = c["batch_size"]
        ops = precision.Products(prec)
        x = torch.as_tensor(self.x[i * bs:(i + 1) * bs], device=dev)
        with precision.fp32_products():
            lp = predictive.mixture_logp(
                lambda th, xb: models.forward(lay.unravel(th), xb, c, ops,
                                              self.stats, train=False),
                comps, x, seed=self.seed, batch_index=i,
                nst=self.traffic["nst"], device=dev, draw_scale=draw_scale)
        return lp.cpu()

    def check(self) -> dict:
        idx = self.check_batches()
        prog = torch.cat([self.program_logp(i) for i in idx])
        comps = self.device_components()
        ref = torch.cat([self.reference_logp(comps, i) for i in idx])
        return {"numbers": compare.logp(prog, ref), "batches": idx}

    # ---- calibration (calibrate.py) -----------------------------------------

    def calibration_outputs(self):
        """One whole pass: the outputs that check() reads."""
        self.window(0.0)

    def stand_ins(self) -> dict:
        """The numbers of the control (the reference with fp8 products),
        of `no_draw` (every component sampled at its mean) and of
        `answer_altered` (one row's best and worst classes swapped), each
        in the program's place against the reference."""
        idx = self.check_batches()
        comps = self.device_components()
        ref = torch.cat([self.reference_logp(comps, i) for i in idx])
        fp8 = torch.cat([self.reference_logp(comps, i, "fp8") for i in idx])
        still = torch.cat([self.reference_logp(comps, i, draw_scale=0.0)
                           for i in idx])
        altered = ref.clone()
        row = altered[0]
        hi, lo = int(row.argmax()), int(row.argmin())
        row[hi], row[lo] = ref[0, lo], ref[0, hi]
        return {"control_fp8": compare.logp(fp8, ref),
                "no_draw": compare.logp(still, ref),
                "answer_altered": compare.logp(altered, ref)}
