"""cSGHMC-FS: cyclical SGHMC with full-snapshot Bayesian model averaging
(counterpart of bayesdll_tpu.methods.csghmc_fs).

The cSGHMC sampler (methods/csghmc.py, so its step launches the
csghmc_update kernel on the card), plus:
  * near each cycle end, a whole-θ snapshot after the epoch, kept on the
    host and pickled as `full_samples_net_ep{ep}.pkl`, with
    `collected_models/model_metadata.pkl` listing them (`_near_cycle_end`
    gives the reference's exact window);
  * at each cycle boundary the momentum v is zeroed, and with hparam
    perform_cold_restarts=1 and a re-init function set θ is re-drawn;
  * after training, `evaluate_full_samples`: each snapshot's loss and error
    on train, val and test, and the ensemble's, whose logits are the mean
    of the snapshots' logits; pickled as `bma_evaluation_results.pkl` and
    `logits_test_bma.pkl`, and returned as results["bma"].

In a multi-chain run (parallel/runner.py) `multi_chain_epoch_end` takes
the snapshots of every chain, keyed (chain, epoch), each with its chain's
net_state, and the model average runs over all of them.

hparams: cSGHMC's, and perform_cold_restarts.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from scipy.special import logsumexp

from bayesdll_tpu_torch.data.stream import window_batches
from bayesdll_tpu_torch.methods import base, csghmc


class Runner(csghmc.Runner):
    method_name = "csghmc_fs"

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        super().__init__(target, theta_init, net_state, cfg, **kw)
        self.full_samples = {}  # epoch, or (chain, epoch) -> flat θ on the host
        # (chain, epoch) -> that chain's net_state on the host
        self.full_sample_net_states = {}
        self.all_model_metadata = []
        self.models_dir = None
        if self.workdir:
            self.models_dir = os.path.join(self.workdir, "collected_models")
            os.makedirs(self.models_dir, exist_ok=True)

    def set_reinit_fn(self, fn):
        """fn(cycle[, seed=]) -> a fresh flat θ of length target.dim, for
        cold restarts; a multi-chain run passes each chain's seed
        (cli/demo.py::make_reinit_fn builds it)."""
        self._reinit_fn = fn

    def _near_cycle_end(self, ep: int) -> bool:
        """The snapshot window, the reference's exact arithmetic
        (`methods/csghmc_fs.py:176`): `ep%L > L-4 and ep%L < L-1` with
        L = epochs // num_cycles, i.e. the 3rd- and 2nd-last epochs of each
        cycle; the cycle's final epoch is not in it.  Short cycles follow
        the same formula: L=3 -> epochs {0,1} of each cycle, L=2 -> {0},
        L=1 -> none."""
        epc = max(1, self.cfg.epochs // max(1, self.cfg.num_cycles))
        r = ep % epc
        return (r > epc - 4) and (r < epc - 1)

    def _cycle_reset(self, state, theta):
        """The reference zeroes the momentum at every cycle boundary and
        optionally cold-restarts θ; plain cSGHMC does neither.  Both in
        place, so a captured graph of the step keeps its addresses."""
        if theta is not None:
            state.theta.copy_(theta)
        state.v.zero_()
        self.logger.info("Momentum buffer reset for new cycle.")

    def train_one_epoch(self, ep: int, train_loader):
        out = super().train_one_epoch(ep, train_loader)
        if self._near_cycle_end(ep):
            self.snapshot(ep)
        return out

    def snapshot(self, ep: int):
        """θ at the end of epoch ep, kept on the host and pickled as
        `full_samples_net_ep{ep}.pkl` with the metadata."""
        theta_np = base.to_host(self.state.theta)
        self.full_samples[ep] = theta_np
        if self.workdir:
            path = os.path.join(self.workdir, f"full_samples_net_ep{ep}.pkl")
            with open(path, "wb") as f:
                pickle.dump(theta_np, f)
            self.logger.info("Full snapshot saved at %s", path)
            self.all_model_metadata.append({
                "model_id": len(self.all_model_metadata),
                "epoch": ep,
                "cycle": self.sched.cycle_number_py(self.bi - 1),
                "path": path,
                "num_params": int(theta_np.shape[0]),
            })
            with open(os.path.join(self.models_dir, "model_metadata.pkl"),
                      "wb") as f:
                pickle.dump(self.all_model_metadata, f)

    def multi_chain_epoch_end(self, mc_runner, ep: int):
        """The snapshot hook of a multi-chain run: every chain's θ and
        net_state near each cycle end, as `full_samples_net_chain{c}_ep{ep}
        .pkl` with the metadata."""
        if not self._near_cycle_end(ep):
            return
        tr = mc_runner.trainer
        cycle = self.sched.cycle_number_py(tr.bi - 1)
        # every chain's, whole, on every rank
        snaps = tr.gather_chains([
            (base.to_host(tr.full_state(i).theta), base.to_host(ns))
            for i, ns in enumerate(tr.net_states)])
        for c, (theta_np, ns_np) in enumerate(snaps):
            self.full_samples[(c, ep)] = theta_np
            self.full_sample_net_states[(c, ep)] = ns_np
            if self.workdir:
                path = os.path.join(self.workdir,
                                    f"full_samples_net_chain{c}_ep{ep}.pkl")
                with open(path, "wb") as f:
                    pickle.dump(theta_np, f)
                self.all_model_metadata.append({
                    "model_id": len(self.all_model_metadata), "chain": c,
                    "epoch": ep, "cycle": cycle, "path": path,
                    "num_params": int(theta_np.shape[0]),
                })
        if self.workdir:
            self.logger.info("Full snapshots saved for %d chains at epoch %d",
                             tr.n_chain, ep)
            with open(os.path.join(self.models_dir, "model_metadata.pkl"),
                      "wb") as f:
                pickle.dump(self.all_model_metadata, f)

    def train(self, train_loader, val_loader, test_loader, start_epoch=0):
        results = super().train(train_loader, val_loader, test_loader,
                                start_epoch=start_epoch)
        if self.full_samples:
            results["bma"] = self.evaluate_full_samples(
                train_loader, val_loader, test_loader)
        return results

    @torch.no_grad()
    def _eval_split(self, loader, eps_sorted):
        """Per-snapshot sums on the device, the ensemble on the host: its
        logits are the mean of the snapshots' logits."""
        per_model = {ep: {"loss": 0.0, "err": 0.0} for ep in eps_sorted}
        ens_loss, ens_err, n = 0.0, 0.0, 0.0
        ens_chunks, target_chunks = [], []
        for xs, ys, vs in window_batches(loader):
            xs_d = self._to_device(xs)
            ys_d = self._to_device(ys).long()
            vs_d = self._to_device(vs)
            acc = None
            for ep in eps_sorted:
                theta = self._to_device(self.full_samples[ep])
                ns = self.net_state if ep not in self.full_sample_net_states \
                    else base.from_host(self.net_state,
                                        self.full_sample_net_states[ep],
                                        self.device)
                ls = torch.zeros((), device=self.device)
                es = torch.zeros((), device=self.device)
                logits_nb = []
                for b in range(xs_d.shape[0]):
                    logits, _ = self.target.forward(theta, ns, xs_d[b],
                                                    train=False)
                    picked = torch.log_softmax(logits, -1).gather(
                        1, ys_d[b][:, None])[:, 0]
                    ls += torch.sum(-picked * vs_d[b])
                    es += torch.sum((torch.argmax(logits, -1) != ys_d[b])
                                    .float() * vs_d[b])
                    logits_nb.append(logits)
                per_model[ep]["loss"] += float(ls)
                per_model[ep]["err"] += float(es)
                logits_nb = torch.stack(logits_nb)
                acc = logits_nb if acc is None else acc + logits_nb
            ens_nb = acc.cpu().numpy() / float(len(eps_sorted))
            for i in range(xs.shape[0]):
                y, valid, ens = ys[i], vs[i], ens_nb[i]
                logp = ens - logsumexp(ens, axis=-1, keepdims=True)
                picked = logp[np.arange(len(y)), y]
                ens_loss += float(np.sum(-picked * valid))
                ens_err += float(np.sum((np.argmax(ens, -1) != y) * valid))
                nv = int(valid.sum())
                n += nv
                ens_chunks.append(ens[:nv])
                target_chunks.append(y[:nv])
        for r in per_model.values():
            r["loss"] /= n
            r["err"] /= n
        return {"per_model": per_model, "ensemble_loss": ens_loss / n,
                "ensemble_err": ens_err / n,
                "_logits": np.concatenate(ens_chunks),
                "_targets": np.concatenate(target_chunks)}

    def evaluate_full_samples(self, train_loader, val_loader, test_loader):
        """Bayesian model averaging over the snapshots (reference
        `methods/csghmc_fs.py:260-418`).  Returns {"{split}_ensemble_loss",
        "{split}_ensemble_err"}."""
        self.logger.info("Evaluating %d full snapshots (BMA)...",
                         len(self.full_samples))
        eps_sorted = sorted(self.full_samples)
        splits = {"train": train_loader, "val": val_loader, "test": test_loader}
        out = {s: self._eval_split(ld, eps_sorted)
               for s, ld in splits.items() if ld is not None}
        for split, r in out.items():
            self.logger.info("[BMA %s] ensemble loss = %.4f, err = %.4f",
                             split, r["ensemble_loss"], r["ensemble_err"])
        if self.workdir:
            with open(os.path.join(self.workdir, "bma_evaluation_results.pkl"),
                      "wb") as f:
                pickle.dump({s: {k: v for k, v in r.items()
                                 if not k.startswith("_")}
                             for s, r in out.items()}, f)
            with open(os.path.join(self.workdir, "logits_test_bma.pkl"),
                      "wb") as f:
                pickle.dump({"targets": out["test"]["_targets"],
                             "logits": out["test"]["_logits"]}, f)
        flat = {f"{s}_ensemble_loss": r["ensemble_loss"] for s, r in out.items()}
        flat.update({f"{s}_ensemble_err": r["ensemble_err"]
                     for s, r in out.items()})
        return flat
