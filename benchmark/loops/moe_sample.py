"""The `moe_sample` loop: the `sample` loop (loops/sample.py) on a routed
mixture of experts (reference/arch/vmoe.py): closed-loop cSGHMC steps
through `Runner.train_one_epoch` over the in-memory set, staged on the
card, timed as there.

The program's routing is discrete: a fp32 reference that routed by its
own top-K would send a token elsewhere wherever its second and third
router logits lie within the bf16 forward's rounding of each other, and
the whole layer's output would move with it.  So the check hands the
program's chosen experts to the reference.  Set-up turns the port's
routing log (`models/vmoe.py::routing_log`) on around the check's first
steps and keeps, for each step and MoE layer, the chosen experts and kept
flags.  The reference replays each step on the program's experts, but
works out which choices its held experts keep itself, by the capacity
rule over the whole group (`reference/arch/vmoe.py::own_kept`), and
computes its gates from its own fp32 logits.  Two numbers check the
routing, each over steps, layers, tokens and the K choices, in choice
order:
  * `route_flip_share`: the share of the program's token-choices whose
    expert differs from the reference's own fp32 top-K on the same path;
  * `kept_flip_share`: the share whose kept flag differs from the
    reference's capacity rule on the program's experts.  The rule is
    integer arithmetic on the experts alone, so its limit is 0: a program
    that kept the wrong choices (second before first, another capacity,
    another order) fails it, however its gaps read.

The stand-ins (calibrate.py): the fp8 control runs on the program's
experts with the capacity rule's flags, so it fails on arithmetic alone
(its `kept_flip_share` reads 0), and its `route_flip_share` is its own
fp8 top-K against the fp32 reference's; the planted half batch routes by
its own top-K at its own capacity (half the group), and its two numbers
are its choices and kept flags against the reference's on the same
tokens.

The reference at the cell's size (D about 1.0B, 128 x 197 tokens) does
not fit its fp32 activations beside its gradient, so it sums the loss and
the gradient over blocks of `check_block_images` images, each block's
mean weighted by its share of the batch: the batch's mean, since with the
routing given every token's path is its own.  Where it routes itself (the
half batch), a forward of the whole group without gradients first finds
its routing, and the blocks then replay it.

The traced run records the program's spans and counters
(benchmark/spans.py::record), which the MoE layer's metrics read.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from benchmark import build, compare, spans
from benchmark.loops import sample
from benchmark.reference import precision, sampler
from benchmark.reference.arch import vmoe as ref_vmoe


def flip_share(ours, theirs) -> float:
    """The share of token-choices where two routings differ: each a list
    over steps of lists over MoE layers of [N, K] experts (or kept flags);
    `theirs` may hold more tokens, of which the first are compared."""
    diff = total = 0
    for a_step, b_step in zip(ours, theirs):
        for a, b in zip(a_step, b_step):
            b = b[:a.shape[0]].to(a.device)
            diff += int((a != b).sum())
            total += a.numel()
    return diff / total


class Loop(sample.Loop):

    def _first_steps(self):
        """`sample`'s first steps with the routing log on: each step's
        routing of every MoE layer, on the host.  Prints the share of the
        choices sent to the held experts that were dropped, and per held
        expert the choices sent to it and kept, over the check's steps
        and MoE layers, beside its slots (steps x layers x capacity)."""
        from bayesdll_tpu_torch.models import vmoe
        with vmoe.routing_log(self.runner.target.module) as log:
            super()._first_steps()
        per = len(self.config["moe_layers"])
        if len(log) != per * len(self.batches):
            raise RuntimeError(f"the routing log holds {len(log)} layers, "
                               f"not {per} for each of "
                               f"{len(self.batches)} steps")
        self.routing = [[(r.experts.cpu(), r.kept.cpu())
                         for r in log[s * per:(s + 1) * per]]
                        for s in range(len(self.batches))]
        c = self.config
        lo, held = c["expert_offset"], c["experts_held"]
        sent, kept = [0] * held, [0] * held
        for step in self.routing:
            for e, k in step:
                for i in range(held):
                    sent[i] += int((e == lo + i).sum())
                    kept[i] += int(((e == lo + i) & k).sum())
        mine, took = sum(sent), sum(kept)
        t = (c["image_size"] // c["patch_size"]) ** 2 + 1
        slots = len(self.routing) * per * ref_vmoe.capacity(
            c, c["batch_size"] * t)
        print(f"routing of the check's steps: {mine} token-choices to the "
              f"held experts, {mine - took} of them dropped "
              f"({(mine - took) / max(mine, 1):.6f}); per held expert "
              f"sent/kept of {slots} slots: "
              + ", ".join(f"{lo + i}: {sent[i]}/{kept[i]}"
                          for i in range(held))
              + f"; slots filled {took / (held * slots):.6f}",
              file=sys.stderr)

    def traced(self):
        n = self.traffic["trace_epochs"]
        tr = spans.record(lambda: [self._epoch() for _ in range(n)],
                          self._epoch)
        steps = n * len(self.loader)
        return {"steps": steps, "images": steps * self.config["batch_size"]}, tr

    # ---- the check --------------------------------------------------------

    def _loss_grad(self, th, x, y, ops, experts):
        """(loss, gradient, own top-K per MoE layer, kept flags per MoE
        layer) of the batch's mean cross-entropy at th, in blocks of
        images.  With `experts` (the program's, per MoE layer) the kept
        flags are the capacity rule's on them over the whole group; with
        `experts` None the reference first routes the whole group
        itself."""
        c, dev = self.config, self.device
        n_img, t = x.shape[0], (c["image_size"] // c["patch_size"]) ** 2 + 1
        if experts is None:
            routing = []
            with torch.no_grad():
                ref_vmoe.forward(self.layout.unravel(th), x, c, ops,
                                 record=routing)
        else:
            routing = [(e, ref_vmoe.own_kept(c, e)) for e in experts]
        routing = [(e.to(dev), k.to(dev)) for e, k in routing]
        leaf = th.detach().requires_grad_()
        p = self.layout.unravel(leaf)
        loss, grad = 0.0, torch.zeros_like(th)
        tops = [[] for _ in routing]
        step = self.traffic["check_block_images"]
        for r0 in range(0, n_img, step):
            r1 = min(n_img, r0 + step)
            part = [(e[r0 * t:r1 * t], k[r0 * t:r1 * t]) for e, k in routing]
            rec = []
            logits = ref_vmoe.forward(p, x[r0:r1], c, ops, routing=part,
                                      record=rec)
            block = F.cross_entropy(logits, y[r0:r1], reduction="sum") / n_img
            g, = torch.autograd.grad(block, leaf)
            grad += g
            loss += float(block.detach())
            del g, logits, block
            for j, (top, _) in enumerate(rec):
                tops[j].append(top)
        return loss, grad, [torch.cat(tj) for tj in tops], \
            [k.cpu() for _, k in routing]

    def _reference(self, prec: str = "fp32", rows=None):
        """(StepReadings, own top-K, kept flags), the last two per step
        and MoE layer, of the reference's first steps from theta0, on the
        program's experts (or, with `rows`, a planted fault's: its own
        routing of those rows)."""
        c, dev, lay = self.config, self.device, self.layout
        ops = precision.Products(prec)
        th = build.theta(lay, self.seed, dev)
        v = torch.zeros_like(th)
        moments = sampler.Welford(th)
        n_eff = self.traffic["train_examples"] * float(c["hparams"]["Ninflate"])
        losses, first, tops, kepts = [], None, [], []
        with precision.fp32_products():
            for k, (x, y) in enumerate(self.batches):
                xd = torch.as_tensor(x, device=dev)
                yd = torch.as_tensor(y, device=dev).long()
                experts = [e for e, _ in self.routing[k]]
                if rows is not None:
                    xd, yd, experts = xd[rows], yd[rows], None
                loss, g, top, kept = self._loss_grad(th, xd, yd, ops,
                                                     experts)
                hp, _, lr, gate = self._step_args(k)
                losses.append(loss)
                tops.append(top)
                kepts.append(kept)
                z = sampler.normals(lay.dim, seed=self.seed, step=k,
                                    device=dev) if gate else None
                sampler.csghmc_step(th, v, g, lr, prior_sig=hp["prior_sig"],
                                    alpha=hp["momentum_decay"], nd=hp["nd"],
                                    n_eff=n_eff, z=z)
                del z, lr
                if gate:
                    moments.update(th)
                if k == 0:
                    first = g
                del g
        return compare.StepReadings(losses, first, th, moments.mean,
                                    moments.var()), tops, kepts

    def reference_readings(self, prec: str = "fp32",
                           rows=None) -> compare.StepReadings:
        return self._reference(prec, rows)[0]

    def check(self) -> dict:
        theta0 = build.theta(self.layout, self.seed, self.device)
        prog = self.program_readings(theta0)
        ref, tops, kepts = self._reference()
        out = compare.steps(prog, ref, theta0, self.layout.groups())
        out["numbers"]["route_flip_share"] = flip_share(
            [[e for e, _ in step] for step in self.routing], tops)
        out["numbers"]["kept_flip_share"] = flip_share(
            [[k for _, k in step] for step in self.routing], kepts)
        return out

    def stand_ins(self) -> dict:
        """`sample`'s stand-ins, each with its `route_flip_share` against
        the fp32 reference's own top-K and its `kept_flip_share` against
        the reference's kept flags."""
        theta0 = build.theta(self.layout, self.seed, self.device)
        groups = self.layout.groups()
        ref, tops, kepts = self._reference()
        out = {}
        half = slice(0, self.config["batch_size"] // 2)
        for who, (prec, rows) in (("control_fp8", ("fp8", None)),
                                  ("half_batch", ("fp32", half))):
            got, own, own_kept = self._reference(prec, rows)
            out[who] = compare.steps(got, ref, theta0, groups)["numbers"]
            out[who]["route_flip_share"] = flip_share(own, tops)
            out[who]["kept_flip_share"] = flip_share(own_kept, kepts)
            del got
        return out
