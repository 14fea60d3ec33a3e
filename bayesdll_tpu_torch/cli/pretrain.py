"""CLI driver: from-scratch Bayesian pre-training with a zero prior mean
(counterpart of bayesdll_tpu.cli.pretrain).

The reference's `pretrain_resnet101.py` as a library-style entry: a
per-method default-hparams table (reference `pretrain_resnet101.py:122-134`),
an explicit all-zeros prior (reference `:203-208`), and the runners of
`cli/demo.py`.  `--device` (cuda by default) and `--fused_steps` pass
through to `cli/demo.py`, as on the port's other entry points.

  python -m bayesdll_tpu_torch.cli.pretrain --method csghmc \\
      --dataset cifar100 --backbone resnet101 --epochs 200 \\
      --batch_size 256 --lr 0.1 [--fused_steps]
"""

from __future__ import annotations

import argparse

DEFAULT_HPARAMS = {
    # reference `pretrain_resnet101.py:122-134`
    "vanilla": "wd=5e-4,bias=penalty",
    "vi": "prior_sig=1.0,kld=1e-3,bias=informative,nst=5",
    "mc_dropout": "prior_sig=1.0,p_drop=0.1,kld=1e-3,bias=gaussian,nst=5",
    "sgld": "prior_sig=1.0,Ninflate=1e3,nd=1.0,burnin=5,thin=10,"
            "bias=informative,nst=5",
    "sghmc": "prior_sig=1.0,Ninflate=1e3,nd=1.0,burnin=5,thin=10,"
             "bias=informative,nst=5,momentum_decay=0.05",
    "adam_sghmc": "prior_sig=1.0,Ninflate=1e3,nd=1.0,burnin=5,thin=10,"
                  "bias=informative,nst=5,momentum_decay=0.05,beta1=0.9,"
                  "beta2=0.999,epsilon=1e-8",
    "csgld": "prior_sig=1.0,Ninflate=1e3,nd=1.0,thin=10,bias=informative,"
             "nst=5",
    "csghmc": "prior_sig=1.0,Ninflate=1e3,nd=1.0,thin=10,bias=informative,"
              "nst=5,momentum_decay=0.05",
    "adam_csghmc": "prior_sig=1.0,Ninflate=1e3,nd=1.0,thin=10,"
                   "bias=informative,nst=5,momentum_decay=0.05,beta1=0.9,"
                   "beta2=0.999,epsilon=1e-8,temperature=1.0,"
                   "perform_cold_restarts=0",
    "csghmc_fs": "prior_sig=1.0,Ninflate=1e3,nd=1.0,thin=10,"
                 "bias=informative,nst=5,momentum_decay=0.05",
    "la": "prior_sig=1.0,Ninflate=1e3,bias=informative,nst=5",
}


def main(argv=None):
    from bayesdll_tpu_torch.cli import demo

    p = argparse.ArgumentParser(description="bayesdll-tpu PyTorch "
                                            "pretraining driver")
    p.add_argument("--method", type=str, default="csghmc")
    p.add_argument("--hparams", type=str, default=None,
                   help="override the per-method defaults")
    p.add_argument("--dataset", type=str, default="cifar100")
    p.add_argument("--backbone", type=str, default="resnet101")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lr_head", type=float, default=None)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--num_cycles", type=int, default=4)
    p.add_argument("--proportion_exploration", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", type=str, default="results_pretrain")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--val_heldout", type=float, default=0.02)
    p.add_argument("--test_eval_freq", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--fused_steps", action="store_true",
                   help="run each segment of steps as replays of a captured "
                        "CUDA graph of the step")
    args = p.parse_args(argv)

    hparams = args.hparams if args.hparams is not None \
        else DEFAULT_HPARAMS[args.method]

    # from scratch: no --pretrained, so the prior mean is zero (reference
    # `pretrain_resnet101.py:203-208` builds a zeroed net0; make_flat_target
    # does the same when theta0_params is None)
    return demo.main([
        "--method", args.method,
        "--hparams", hparams,
        "--dataset", args.dataset,
        "--backbone", args.backbone,
        "--epochs", str(args.epochs),
        "--batch_size", str(args.batch_size),
        "--lr", str(args.lr),
        *(["--lr_head", str(args.lr_head)] if args.lr_head is not None else []),
        "--momentum", str(args.momentum),
        "--num_cycles", str(args.num_cycles),
        "--proportion_exploration", str(args.proportion_exploration),
        "--seed", str(args.seed),
        "--log_dir", str(args.log_dir),
        "--data_root", str(args.data_root),
        "--val_heldout", str(args.val_heldout),
        "--test_eval_freq", str(args.test_eval_freq),
        "--device", args.device,
        *(["--fused_steps"] if args.fused_steps else []),
    ])


if __name__ == "__main__":
    main()
