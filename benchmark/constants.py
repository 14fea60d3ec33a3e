"""The yardstick's fixed numbers, frozen here so that no change to the
program moves them.  Each carries its source.
"""

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity) at the 700 W
# power limit: bf16 on the tensor cores; float32 outside them; HBM3 bytes
# per second.  (Copied from bayesdll_tpu_torch/utils/profiling.py, PR 4.)
BF16_PEAK_FLOPS = 989e12
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# Analytic forward FLOPs per 224x224 example, 2 per multiply-accumulate,
# convolutions and matrix products only; a training step counts 3 x forward
# and nothing recomputed.  (Copied from bayesdll_tpu_torch/utils/
# profiling.py::FWD_FLOPS_PER_EXAMPLE: ResNet-101 7.85 GMACs by
# torchvision's profile; ViT-L/32 2 x 305M parameters x 50 tokens.)
FWD_FLOPS_PER_EXAMPLE = {
    "resnet101": 15.7e9,
    "resnet50": 8.2e9,
    "vit_l_32": 30.5e9,
    "vit_b_16": 33.8e9,
}

# The cSGHMC update's own traffic per element of the flat vector: g, theta
# and v read once (12 B), theta and v written once (8 B).  The step size is
# a (body, head) pair of scalars, so it adds no bytes per element; a kernel
# that also reads a per-element lr vector moves 24 B and so reads below
# 100% of this bound.
CSGHMC_UPDATE_BYTES_PER_ELEMENT = 20

# Kernel families of a profile: the first whose substring is in the
# kernel's lower-cased name.  (Copied from chip_smoke.py::KERNEL_FAMILIES,
# PR 4.)
KERNEL_FAMILIES = (
    ("sampler", ("_update_kernel",)),
    ("attention", ("flash", "fmha", "sdpa", "attention", "attn")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("batch norm", ("batch_norm",)),
    ("conv and gemm", ("conv", "gemm", "xmma", "cutlass", "cudnn", "wgrad",
                       "dgrad", "fprop", "sm90_", "nvjet")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
    ("pooling", ("pool",)),
    ("copy and cat", ("cat", "copy", "stack")),
)

# The families that are the backbone's own work.
BACKBONE_FAMILIES = ("conv and gemm", "attention", "layer norm", "batch norm")


def family(kernel_name: str) -> str:
    low = kernel_name.lower()
    return next((f for f, keys in KERNEL_FAMILIES
                 if any(k in low for k in keys)), "other")
