"""The `adam_sample` loop: the `sample` loop (loops/sample.py) with the
mix's `method` (Adam-cSGHMC) in cSGHMC's place: closed-loop steps through
`Runner.train_one_epoch` over the in-memory set, timed, traced and checked
as there.

The mix writes out Adam's `beta1`, `beta2` and `epsilon`, and may carry an
`lr` in place of the configuration's; they reach the program as its
hparams and lr, and the reference through the same view of the
configuration.  The program's moments are its raw running ones (mean and
mean square); the reference's are Welford's, the same quantities.

The check replays the first steps with reference/adam_sampler.py on the
same weights, batches, step sizes and noise (the Adam stream).  The first
gradient is read back from the program's Adam state after step 1: its
first moment is m1 = (1 - b1) u, u = g / T + (theta0 - mu) / sigma^2 / N
(mu the prior mean, 0 here), so g = T (m1 / (1 - b1) - (theta0 - mu) /
sigma^2 / N).  Theta's change and the moments are compared part by part
as in `sample`, but their worst parts are not rounding-tight: Adam's
1 / (sqrt(v) + eps) turns the rounding of a near-zero gradient element
into a step of either side's own size, so those limits sit on the median
parts (limits/vit_l_32.adam_sample.json).

The update itself is held tight by `adam_step_gap`.  The program's Adam
state (theta, m, s, v) is kept after each of the first REPLAY_STEPS
steps; step k's u is read back from m before and after it, u = (m_k -
b1 m_{k-1}) / (1 - b1), and the reference's update (`adam_update`) runs
from the program's own state before the step with that u.  Both then
start from the same numbers, so the forward's rounding drops out, and
what is left is the update's arithmetic: b1, b2, their bias corrections,
eps, the preconditioner, the noise scale, the momentum's decay and lr
applied twice.  Each of theta's change, m, s and v is compared part by
part: the norm of the difference over the larger of the replay's norm of
the part and of the median part; the worst over parts, vectors and steps
is the number.  Its control (`stand_ins`) is the same replay with the
state, u and the noise held in bf16 (theta stays fp32, as the program
holds it): the nearest precision below the update's fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import build, compare
from benchmark.loops import sample
from benchmark.reference import adam_sampler, models, precision, sampler

ADAM_KEYS = ("beta1", "beta2", "epsilon")
REPLAY_STEPS = 2
STATE = (("theta", "theta"), ("m", "m"), ("s", "v2"), ("v", "v_mom"))


class Loop(sample.Loop):

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        t = self.traffic
        hp = dict(self.config["hparams"])
        hp.update({k: repr(float(t[k])) for k in ADAM_KEYS})
        self.config = dict(self.config, hparams=hp,
                           lr=float(t.get("lr", self.config["lr"])))

    def _first_steps(self):
        """The check's steps, through step_loop on the loader's first
        batches: the Adam state after each of the first REPLAY_STEPS, the
        rest after the last."""
        r = self.runner
        it = iter(self.loader)
        self.batches = [next(it)[:2] for _ in range(self.traffic["check_steps"])]
        losses, snap = [], {"states": []}
        for k, (x, y) in enumerate(self.batches):
            loss, _ = r.step_loop(0, [x], [y], k)
            losses.append(loss[0])
            if k < REPLAY_STEPS:
                snap["states"].append({mine: sample._host(getattr(r.state, its))
                                       for mine, its in STATE})
        st = r.state
        mean, var = st.moments.mean_var()
        snap.update(theta=sample._host(st.theta), mean=sample._host(mean),
                    var=sample._host(var),
                    losses=[float(v) for v in losses])
        self.snap = snap

    def _hparams(self):
        hp = self._step_args(0)[0]
        c = self.config["hparams"]
        hp.update({k: float(c[k]) for k in ADAM_KEYS})
        hp["temperature"] = float(c.get("temperature", 1.0))
        hp["n_eff"] = self.traffic["train_examples"] * hp["Ninflate"]
        return hp

    def program_readings(self, theta0) -> compare.StepReadings:
        s, dev, hp = self.snap, self.device, self._hparams()
        grad = adam_sampler.first_gradient(
            s["states"][0]["m"].to(dev), theta0, torch.zeros_like(theta0),
            prior_sig=hp["prior_sig"], n_eff=hp["n_eff"], beta1=hp["beta1"],
            temperature=hp["temperature"])
        return compare.StepReadings(s["losses"], grad, s["theta"].to(dev),
                                    s["mean"].to(dev), s["var"].to(dev))

    def replay(self, dtype=torch.float32):
        """(adam_step_gap, where): the program's first REPLAY_STEPS updates
        against the reference's update from the program's own state and u,
        the state, u and noise held in `dtype`."""
        dev, hp, groups = self.device, self._hparams(), self.layout.groups()
        theta0 = build.theta(self.layout, self.seed, dev)
        zero = torch.zeros_like(theta0)
        worst, where = 0.0, None
        for k, after in enumerate(self.snap["states"]):
            before = self.snap["states"][k - 1] if k else \
                {"theta": theta0, "m": zero, "s": zero, "v": zero}
            st = adam_sampler.AdamState(
                *(before[n].to(dev, dtype, copy=True) for n in "msv"), t=k)
            u = adam_sampler.step_u(before["m"].to(dev), after["m"].to(dev),
                                    hp["beta1"]).to(dtype)
            th = before["theta"].to(dev, copy=True)
            z = adam_sampler.normals(self.layout.dim, seed=self.seed, step=k,
                                     device=dev).to(dtype) \
                if hp["nd"] else None
            adam_sampler.adam_update(
                th, st, u, self._step_args(k)[2], n_eff=hp["n_eff"],
                nd=hp["nd"], alpha=hp["momentum_decay"], beta1=hp["beta1"],
                beta2=hp["beta2"], eps=hp["epsilon"], z=z)
            del u, z
            start = before["theta"].to(dev)
            ref = {"theta": th - start, "m": st.m, "s": st.s, "v": st.v}
            for n, r in ref.items():
                prog = after[n].to(dev) - (start if n == "theta" else 0.0)
                r = r.float()
                norms = compare.part_norms(r, groups)
                gap = compare.part_norms(prog - r, groups) \
                    / torch.maximum(norms, norms.median()).clamp(min=1e-300)
                i = int(torch.argmax(gap))
                if float(gap[i]) >= worst:
                    worst, where = float(gap[i]), \
                        f"step {k + 1} {n} {groups[i][0]}"
            del st, th, ref
        return worst, where

    def check(self) -> dict:
        out = super().check()
        gap, where = self.replay()
        out["numbers"]["adam_step_gap"] = gap
        out["worst_part"]["adam_step_gap"] = where
        return out

    def stand_ins(self) -> dict:
        """`sample`'s stand-ins; on `adam_step_gap` the control is the
        replay in bf16, and the half batch reads 0: its update is the
        reference's own, which the replay gives back."""
        out = super().stand_ins()
        out["control_fp8"]["adam_step_gap"] = self.replay(torch.bfloat16)[0]
        out["half_batch"]["adam_step_gap"] = 0.0
        return out

    def reference_readings(self, prec: str = "fp32",
                           rows=None) -> compare.StepReadings:
        """The reference's first steps from theta0, its products in `prec`
        and its loss over `rows` of each batch (None: all)."""
        c, dev, lay = self.config, self.device, self.layout
        hp = self._hparams()
        ops = precision.Products(prec)
        th = build.theta(lay, self.seed, dev)
        mu = torch.zeros_like(th)
        st = adam_sampler.AdamState.zeros(th)
        moments = sampler.Welford(th)
        losses, grad = [], None
        with precision.fp32_products():
            for k, (x, y) in enumerate(self.batches):
                _, _, lr, gate = self._step_args(k)
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
                z = adam_sampler.normals(lay.dim, seed=self.seed, step=k,
                                         device=dev) if hp["nd"] else None
                adam_sampler.adam_sghmc_step(
                    th, st, g, lr, prior_mean=mu, prior_sig=hp["prior_sig"],
                    n_eff=hp["n_eff"], nd=hp["nd"],
                    alpha=hp["momentum_decay"], beta1=hp["beta1"],
                    beta2=hp["beta2"], eps=hp["epsilon"],
                    temperature=hp["temperature"], z=z)
                del z
                if gate:
                    moments.update(th)
                if k == 0:
                    grad = g
        return compare.StepReadings(losses, grad, th, moments.mean,
                                    moments.var())
