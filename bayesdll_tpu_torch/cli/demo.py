"""CLI driver: train one chain of a ported method (counterpart of
bayesdll_tpu.cli.demo).

  python -m bayesdll_tpu_torch.cli.demo --method csghmc --backbone mlp_mnist \\
      --dataset synthetic --epochs 4 --num_cycles 2 --lr 1e-2 \\
      --hparams prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,bias=informative,nst=2 \\
      --device cuda
  python -m bayesdll_tpu_torch.cli.demo --method sghmc --dataset synthetic \\
      --epochs 4 --lr 1e-3 --momentum 0.5 \\
      --hparams prior_sig=1.0,nd=1.0,burnin=1,thin=2,nst=2 --device cuda

Artifacts (logs, logits, checkpoints, reliability plots) go to
`<log_dir>/<run name>/`; the plots need matplotlib.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="bayesdll-tpu PyTorch demo driver")
    p.add_argument("--method", type=str, default="csghmc")
    p.add_argument("--hparams", type=str, default="",
                   help="comma-separated key=val string")
    p.add_argument("--dataset", type=str, default="mnist",
                   help="mnist|synthetic")
    p.add_argument("--backbone", type=str, default="mlp_mnist")
    p.add_argument("--val_heldout", type=float, default=0.1)
    p.add_argument("--ece_num_bins", type=int, default=15)
    p.add_argument("--num_cycles", type=int, default=4)
    p.add_argument("--proportion_exploration", type=float, default=0.5)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--lr_head", type=float, default=None)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", type=str, default="results")
    p.add_argument("--test_eval_freq", type=int, default=1)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path to resume training from")
    return p.parse_args(argv)


def build_all(cfg, logger, workdir=None):
    """Data + backbone + prior + runner."""
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.data import prepare
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models import create_backbone

    train, val, test, nd = prepare(cfg)
    logger.info("dataset %s prepared: ND=%d, num_classes=%d",
                cfg.dataset, nd, cfg.num_classes)
    model, _input_shape, _meta = create_backbone(
        cfg.backbone, num_classes=cfg.num_classes)
    target, theta_init, net_state = make_flat_target(
        model, nd_size=nd, num_classes=cfg.num_classes,
        rng=torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    logger.info("backbone %s: %d parameters", cfg.backbone, target.n_params)
    runner = get_runner_cls(cfg.method)(target, theta_init, net_state, cfg,
                                        logger=logger, workdir=workdir)
    return runner, (train, val, test)


def main(argv=None):
    args = parse_args(argv)
    from bayesdll_tpu_torch.config import Config

    cfg = Config(
        method=args.method, hparams=args.hparams, dataset=args.dataset,
        backbone=args.backbone, val_heldout=args.val_heldout,
        ece_num_bins=args.ece_num_bins, num_cycles=args.num_cycles,
        proportion_exploration=args.proportion_exploration,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        lr_head=args.lr_head, momentum=args.momentum, seed=args.seed,
        log_dir=args.log_dir, test_eval_freq=args.test_eval_freq, data_root=args.data_root,
        device=args.device)

    workdir = os.path.join(cfg.log_dir, cfg.run_name())
    os.makedirs(workdir, exist_ok=True)
    logger = logging.getLogger("bayesdll_tpu_torch")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s] %(message)s")
    for h in (logging.FileHandler(os.path.join(workdir, "logs.txt")),
              logging.StreamHandler(sys.stdout)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.info("Args: %s", vars(args))

    runner, loaders = build_all(cfg, logger, workdir=workdir)
    start_epoch = 0
    if args.resume is not None:
        start_epoch = runner.load_ckpt(args.resume) + 1
        logger.info("Resumed from %s at epoch %d", args.resume, start_epoch)
    results = runner.train(*loaders, start_epoch=start_epoch)
    logger.info("Final results: %s", results)
    return results


if __name__ == "__main__":
    main()
