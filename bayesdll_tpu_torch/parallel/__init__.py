"""Multi-chain runs on one card (counterpart of bayesdll_tpu.parallel,
without its mesh, tensor parallelism and multi-host setup)."""

from bayesdll_tpu_torch.parallel.chains import MultiChainTrainer
from bayesdll_tpu_torch.parallel.runner import MultiChainRunner

__all__ = ["MultiChainTrainer", "MultiChainRunner"]
