"""The benchmark of the PyTorch/CUDA port (`bayesdll_tpu_torch`): run one
cell with `python benchmark/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` from the repository's root."""
