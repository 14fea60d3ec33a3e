"""Device milliseconds per Adam-cSGHMC sampling step in the float32
elementwise kernels: the passes over the flat vector that the eager
update makes (the Adam-SGHMC momentum, the SGD step, the step-size vector,
the moments) and the gradient's cast back to float32.  The backbone runs
in bf16, so its elementwise kernels name BFloat16 and are left out; so is
the forward's cast to bf16 (`bfloat16_copy_kernel_cuda`).  None where no such kernel ran, or in a cell
whose backbone runs in float32."""


def _fp32_elementwise(k):
    def keep(name, cat):
        low = name.lower()
        return cat == "kernel" and k.family(name) == "elementwise" \
            and "float" in low and "bfloat16" not in low \
            and "half" not in low
    return keep


def read(ctx):
    units = ctx["traced"]
    if ctx["traffic"]["loop"] != "adam_sample" or not units.get("steps") \
            or ctx["config"].get("compute_dtype") == "float32":
        return None
    sec = sum(ctx["trace"].time_by_name(
        _fp32_elementwise(ctx["constants"])).values())
    return 1e3 * sec / units["steps"] if sec > 0 else None
