"""Multi-chain and multi-device runs (counterpart of bayesdll_tpu.parallel):
chains on one card or over the ranks of a ('chain', 'data') mesh, data
parallelism and fsdp within a chain, Megatron tensor parallelism of the ViT,
and the process group that spans them."""

from bayesdll_tpu_torch.parallel.chains import MultiChainTrainer
from bayesdll_tpu_torch.parallel.mesh import init_distributed, make_mesh
from bayesdll_tpu_torch.parallel.runner import MultiChainRunner
from bayesdll_tpu_torch.parallel.tp import (make_tp_constraints, make_tp_mesh,
                                            shard_runner_for_tp)

__all__ = ["MultiChainTrainer", "MultiChainRunner", "init_distributed",
           "make_mesh", "make_tp_mesh", "make_tp_constraints",
           "shard_runner_for_tp"]
