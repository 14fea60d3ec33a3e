"""Configuration surface (counterpart of bayesdll_tpu.config).

The reference CLI's flags and its ``--hparams`` 'k1=v1,k2=v2' string as a
dataclass, plus `compute_dtype` (the forward's dtype), the ViT knobs of the
JAX package's config, `fused_steps`, the multi-device layout (`mesh_shape`,
`fsdp`, `tensor_parallel`), and `device`: every run goes to the CUDA card
unless the caller asks for "cpu".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional


def parse_hparams(hparams_str: str) -> Dict[str, str]:
    """Parse 'k1=v1,k2=v2' into a dict of strings; each method casts what it
    needs."""
    out: Dict[str, str] = {}
    if not hparams_str:
        return out
    for item in hparams_str.split(","):
        item = item.strip()
        if not item:
            continue
        k, _, v = item.partition("=")
        out[k.strip()] = v.strip()
    return out


@dataclasses.dataclass
class Config:
    method: str = "csghmc"
    hparams: Dict[str, str] = dataclasses.field(default_factory=dict)
    pretrained: Optional[str] = None  # torchvision state_dict: prior mean
    dataset: str = "mnist"
    backbone: str = "mlp_mnist"
    val_heldout: float = 0.1
    ece_num_bins: int = 15
    num_cycles: int = 4
    proportion_exploration: float = 0.5
    full_sample: bool = False  # cyclical methods: keep every collected θ
    epochs: int = 100
    batch_size: int = 128
    lr: float = 1e-2
    lr_head: Optional[float] = None
    momentum: float = 0.0  # torch-SGD momentum of SGLD, SGHMC and cSGLD
    seed: int = 0
    log_dir: str = "results"
    test_eval_freq: int = 1
    data_root: str = "data"
    num_classes: int = 10
    num_chains: int = 1  # independent chains, run one after another per step
    # the ('chain', 'data') layout over ranks, e.g. {'chain': 2, 'data': 2}
    # (parallel/mesh.py); None or 'data' 1: no batch split
    mesh_shape: Optional[Dict[str, int]] = None
    fsdp: bool = False  # shard each chain's flat vectors over its 'data' ranks
    # Megatron tensor parallelism of the ViT over a ('data', 'model') mesh
    # (parallel/tp.py), single chain only
    tensor_parallel: int = 1
    # segments of steps as replays of a captured CUDA graph (methods/graphed.py)
    fused_steps: bool = False
    compute_dtype: str = "float32"  # "bfloat16" for the big backbones
    # ViT knobs (models/vit.py); the other backbones ignore them
    remat: bool = False        # recompute each encoder block in backward
    remat_policy: str = ""     # '' (full) | 'dots' | 'names'
    fused_attention: bool = True  # F.scaled_dot_product_attention core
    gelu_approx: bool = False  # tanh GELU; exact erf by default
    device: str = "cuda"
    # multi-chain checkpoint backend: 'auto' = the DCP directory ('orbax',
    # utils/checkpoint.py) when a process group spans processes, pickle
    # otherwise
    ckpt_backend: str = "auto"  # auto | pickle | orbax

    def backbone_kw(self) -> dict:
        """The keyword arguments of `create_backbone` this config sets."""
        return dict(dtype=self.compute_dtype, remat=self.remat,
                    remat_policy=self.remat_policy,
                    fused_attention=self.fused_attention,
                    gelu_approx=self.gelu_approx)

    def __post_init__(self):
        if isinstance(self.hparams, str):
            self.hparams = parse_hparams(self.hparams)
        if self.lr_head is None:
            self.lr_head = self.lr

    def hp(self, key: str, default=None, cast=str):
        """Typed hparam lookup; a missing key with no default raises."""
        if key in self.hparams:
            return cast(self.hparams[key])
        if default is None:
            raise KeyError(f"missing required hparam '{key}' for method {self.method}")
        return default

    def run_name(self) -> str:
        """Results-dir name encoding the config; fixed at first call."""
        if getattr(self, "_run_name", None) is not None:
            return self._run_name
        hp = "_".join(f"{k}{v}" for k, v in sorted(self.hparams.items()))
        pretr = 0 if self.pretrained is None else 1
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self._run_name = (
            f"{self.dataset}_val_heldout{self.val_heldout}/{self.backbone}/"
            f"{self.method}_{hp}_pretr{pretr}/"
            f"ep{self.epochs}_bs{self.batch_size}_lr{self.lr}_lrh{self.lr_head}"
            f"_mo{self.momentum}/seed{self.seed}_{stamp}"
        )
        return self._run_name
