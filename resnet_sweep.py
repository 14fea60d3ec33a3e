#!/usr/bin/env python3
"""ResNet-101 cSGHMC on the synthetic 224x224x3 set, at a few settings of lr,
prior_sig and epochs: does the run fit its training set, and does it beat
chance on the test set?  Needs one CUDA card.

    python3 resnet_sweep.py                      # the settings below
    python3 resnet_sweep.py 1e-2:5e-4:40 1e-3:1.0:20   # lr:prior_sig:epochs

Each setting builds chip_smoke.py's ResNet-101 run (37 classes, batch 256,
bf16 forward, 2 cycles) with that lr, prior_sig and epoch count, trains it
through `Runner.train`, and prints one line: the training loss and error of
every 10th epoch and of the last, and the test error and NLL of the best
evaluation.
"""

from __future__ import annotations

import gc
import sys

import torch

import chip_smoke as cs

SETTINGS = ("1e-3:1.0:40", "1e-2:1.0:20", "3e-3:5e-4:40", "1e-2:5e-4:40",
            "1e-2:5e-4:100")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("resnet_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    for setting in argv or SETTINGS:
        lr, prior_sig, epochs = setting.split(":")
        cs.RESNET_LR = float(lr)
        cs.RESNET_HP["prior_sig"] = prior_sig
        cs.RESNET["epochs"] = int(epochs)
        runner, loaders = cs.resnet_runner()
        runner.cfg.test_eval_freq = 5
        res = runner.train(*loaders)
        losses, errs = res["train_losses"], res["train_errors"]
        print(f"[{smi}] resnet101 csghmc lr={lr} prior_sig={prior_sig} "
              f"epochs={epochs}: train loss {[round(x, 3) for x in losses[::10]]}"
              f" -> {losses[-1]:.4f}, train error "
              f"{[round(x, 3) for x in errs[::10]]} -> {errs[-1]:.4f}; best "
              f"eval at epoch {res.get('best_epoch')}: test error "
              f"{res['test_err']:.4f} (chance {1 - 1 / 37:.4f}), test NLL "
              f"{res['nll']:.4f}", flush=True)
        del runner, loaders, res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
