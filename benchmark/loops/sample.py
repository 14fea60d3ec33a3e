"""The `sample` loop: closed-loop cSGHMC sampling steps, one after another,
through `Runner.train_one_epoch` on an in-memory training set read by
`ArrayLoader` with shuffling (every step copies its batch from pinned host
memory to the card).

Set-up builds the runner once and drives it from the seed through its
first `check_steps` steps (`step_loop`, which runs each of the loader's
first batches through `_one_step`, as `train_one_epoch` does), keeping
what the check needs on the host; then one whole epoch as warm-up.  The
same runner then runs the window: whole epochs until `seconds` have
passed, the card synchronised at the end.  A step fails where its epoch's loss is not finite.

The check replays those first steps with the reference (reference/) on
the same weights, batches, step sizes and noise, once the window has
closed and the program's state is freed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import build, compare, trace
from benchmark.reference import models, precision, sampler


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy, also of a host tensor that the steps write in place."""
    return t.detach().to("cpu", copy=True)


class Loop:
    metric = "train_img_per_s"
    training = True

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic

    # ---- set-up -----------------------------------------------------------

    def setup(self, warm: bool = True):
        """Build, run the check's first steps and, with `warm`, one epoch."""
        c, t, dev = self.config, self.traffic, self.device
        self.cfg = build.port_config(c, t, self.seed, dev)
        tgt, ns, self.layout = build.target(self.cfg, c, t["train_examples"],
                                            self.seed, dev)
        x, y = build.images(c, t["train_examples"], self.seed, 0, dev)
        from bayesdll_tpu_torch.data import ArrayLoader
        self.loader = ArrayLoader(
            x, y, c["batch_size"], shuffle=True, drop_last=True,
            seed=build.derived_seed(self.seed, build.LOADER) % (2 ** 31))
        self.runner = build.runner(self.cfg, tgt,
                                   build.theta(self.layout, self.seed, dev),
                                   ns)
        self.runner._ensure_sched(len(self.loader))
        self._first_steps()
        self.ep = 0
        if warm:
            self._epoch()
        self._sync()

    def _first_steps(self):
        """The check's steps, through step_loop on the loader's first
        batches: the first gradient as the update received it is read
        from v after step 1, the rest after the last."""
        r = self.runner
        it = iter(self.loader)
        self.batches = [next(it)[:2] for _ in range(self.traffic["check_steps"])]
        losses, snap = [], {}
        for k, (x, y) in enumerate(self.batches):
            loss, _ = r.step_loop(0, [x], [y], k)
            losses.append(loss[0])
            if k == 0:
                snap["v1"] = _host(r.state.v)
        st = r.state
        snap.update(theta=_host(st.theta), mean=_host(st.moments.mean),
                    var=_host(st.moments.mean_var()[1]),
                    losses=[float(v) for v in losses])
        self.snap = snap

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _epoch(self):
        loss, _ = self.runner.train_one_epoch(self.ep, self.loader)
        self.ep += 1
        return loss

    # ---- the window ---------------------------------------------------------

    def window(self, seconds: float) -> dict:
        steps_per_epoch = len(self.loader)
        t0 = time.perf_counter()
        epochs = failed = 0
        while True:
            loss = self._epoch()
            epochs += 1
            failed += 0 if np.isfinite(loss) else steps_per_epoch
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        dt = time.perf_counter() - t0
        steps = epochs * steps_per_epoch
        return {"seconds": dt, "attempted": steps, "failed": failed,
                "rate": steps * self.config["batch_size"] / dt}

    def traced(self):
        """`trace_epochs` whole epochs under the device profile; one more
        under the host profile, which names the idle gaps."""
        n = self.traffic["trace_epochs"]
        tr = trace.record(lambda: [self._epoch() for _ in range(n)],
                          self._epoch)
        steps = n * len(self.loader)
        return {"steps": steps, "images": steps * self.config["batch_size"]}, tr

    def free(self):
        """Drop the program's state, so that the reference has the card."""
        self.runner = self.loader = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check --------------------------------------------------------

    def program_readings(self, theta0) -> compare.StepReadings:
        """The program's readings from its snapshots; the first gradient
        worked out from v after step 1: v1 = -lr (g + prior_sig theta0)
        + gate pref sqrt(lr) z."""
        s, dev = self.snap, self.device
        hp, sched, lr0, gate0 = self._step_args(0)
        v1 = s["v1"].to(dev).double()
        if gate0:
            v1 -= self._noise_term(lr0, 0).double()
        grad = (-v1 / lr0.double() - hp["prior_sig"] * theta0.double()).float()
        return compare.StepReadings(s["losses"], grad, s["theta"].to(dev),
                                    s["mean"].to(dev), s["var"].to(dev))

    def _step_args(self, step):
        c, t = self.config, self.traffic
        hp = {k: float(c["hparams"][k]) for k in
              ("prior_sig", "momentum_decay", "nd", "Ninflate")}
        hp["thin"] = int(c["hparams"]["thin"])
        sched = sampler.Schedule(c["lr"], t["num_cycles"], t["epochs"],
                                 t["train_examples"] // c["batch_size"],
                                 t["proportion_exploration"], hp["thin"])
        lr = sampler.lr_vector(sched.lr(step), 1.0,
                               self.layout.is_head(self.device))
        return hp, sched, lr, sched.gate(step)

    def _noise_term(self, lr, step):
        hp = self._step_args(step)[0]
        n_eff = self.traffic["train_examples"] * hp["Ninflate"]
        z = sampler.normals(self.layout.dim, seed=self.seed, step=step,
                            device=self.device)
        return hp["nd"] * np.sqrt(2.0 * hp["momentum_decay"]) / n_eff \
            * torch.sqrt(lr) * z

    def reference_readings(self, prec: str = "fp32",
                           rows=None) -> compare.StepReadings:
        """The reference's first steps from theta0, its products in `prec`
        (precision.py) and its loss over `rows` of each batch (None: all;
        a planted fault takes half)."""
        c, dev, lay = self.config, self.device, self.layout
        ops = precision.Products(prec)
        th = build.theta(lay, self.seed, dev)
        v = torch.zeros_like(th)
        moments = sampler.Welford(th)
        n_eff = self.traffic["train_examples"] * float(c["hparams"]["Ninflate"])
        losses, grad = [], None
        with precision.fp32_products():
            for k, (x, y) in enumerate(self.batches):
                hp, _, lr, gate = self._step_args(k)
                leaf = th.detach().clone().requires_grad_()
                xd = torch.as_tensor(x, device=dev)
                yd = torch.as_tensor(y, device=dev).long()
                if rows is not None:
                    xd, yd = xd[rows], yd[rows]
                logits = models.forward(lay.unravel(leaf), xd, c, ops,
                                        train=True)
                loss = F.cross_entropy(logits, yd)
                g, = torch.autograd.grad(loss, leaf)
                del leaf, logits
                losses.append(float(loss.detach()))
                z = sampler.normals(lay.dim, seed=self.seed, step=k,
                                    device=dev) if gate else None
                sampler.csghmc_step(th, v, g, lr, prior_sig=hp["prior_sig"],
                                    alpha=hp["momentum_decay"], nd=hp["nd"],
                                    n_eff=n_eff, z=z)
                if gate:
                    moments.update(th)
                if k == 0:
                    grad = g
        return compare.StepReadings(losses, grad, th, moments.mean,
                                    moments.var())

    def check(self) -> dict:
        theta0 = build.theta(self.layout, self.seed, self.device)
        prog = self.program_readings(theta0)
        ref = self.reference_readings()
        return compare.steps(prog, ref, theta0, self.layout.groups())

    # ---- calibration (calibrate.py) -----------------------------------------

    def calibration_outputs(self):
        """Nothing to run: set-up's first steps are what check() reads."""

    def stand_ins(self) -> dict:
        """The numbers of the control (the reference with fp8 products)
        and of a planted half batch (the loss and gradient of half of each
        batch), each in the program's place against the reference."""
        theta0 = build.theta(self.layout, self.seed, self.device)
        ref = self.reference_readings()
        groups = self.layout.groups()
        half = slice(0, self.config["batch_size"] // 2)
        return {
            "control_fp8": compare.steps(self.reference_readings("fp8"), ref,
                                         theta0, groups)["numbers"],
            "half_batch": compare.steps(self.reference_readings(rows=half),
                                        ref, theta0, groups)["numbers"],
        }
