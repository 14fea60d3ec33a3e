"""Alias driver matching the reference's `demo_mnist.py` entry point
(counterpart of bayesdll_tpu.cli.demo_mnist): enforces the MNIST MLP setup
(reference `demo_mnist.py:16-54` defaults: dataset=mnist,
backbone=mlp_mnist, val_heldout=0.1).

  python -m bayesdll_tpu_torch.cli.demo_mnist --method sgld ...
"""

import sys

from bayesdll_tpu_torch.cli import demo


def _has_flag(argv, flag):
    # both "--flag value" and "--flag=value" forms count as user-provided
    return any(a == flag or a.startswith(flag + "=") for a in argv)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    if not _has_flag(argv, "--dataset"):
        argv += ["--dataset", "mnist"]
    if not _has_flag(argv, "--backbone"):
        argv += ["--backbone", "mlp_mnist"]
    return demo.main(argv)


if __name__ == "__main__":
    main()
