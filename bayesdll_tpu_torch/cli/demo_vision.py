"""Alias driver matching the reference's `demo_vision.py` entry point
(counterpart of bayesdll_tpu.cli.demo_vision): defaults to the
Pets/ResNet-101 setup (reference `demo_vision.py:16-54`).

  python -m bayesdll_tpu_torch.cli.demo_vision --method sghmc \\
      --pretrained /path/to/resnet101_imagenet.pth ...
"""

import sys

from bayesdll_tpu_torch.cli import demo


def _has_flag(argv, flag):
    # both "--flag value" and "--flag=value" forms count as user-provided
    return any(a == flag or a.startswith(flag + "=") for a in argv)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    if not _has_flag(argv, "--dataset"):
        argv += ["--dataset", "pets"]
    if not _has_flag(argv, "--backbone"):
        argv += ["--backbone", "resnet101"]
    return demo.main(argv)


if __name__ == "__main__":
    main()
