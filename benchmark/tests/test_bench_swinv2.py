"""The SwinV2 cell's counts and readers, the Adam cell's loop and readers,
and both cells found from files alone.

  * swinv2_counts.py at the configuration: 115.38 GMACs a forward, the
    attention cores' roofline work, and the per-image count against the
    FLOPs that torch's counter reads off the reference's forward at a tiny
    size (the CPB MLP, once a forward, cancels between two batch sizes);
  * the readers on hand-built traces, None without attention kernels or
    outside their loop; the Adam cell's three readers are the accepted
    `*.sample` readers;
  * the `adam_sample` loop's check on a tiny fp32 ViT on the CPU: the
    reference's Adam-SGHMC steps against the program's Adam-cSGHMC.
"""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import constants, spans, spec, swinv2_counts, trace
from benchmark.loops import adam_sample
from benchmark.reference import layout, models, precision

from conftest import DATA, ROOT
from test_bench_spans import ev, traced

CONFIG = json.loads((ROOT / "benchmark" / "configs"
                     / "swinv2_l_w24_384.json").read_text())
TINY = json.loads((DATA / "configs" / "tiny_swinv2.json").read_text())
NEW = ("device_idle_pct.adam_sample", "device_ms_per_step.adam_sample",
       "mfu.adam_sample", "backbone_ms_per_step.adam_sample",
       "update_ms_per_step.adam_sample", "swinv2_mfu.sample",
       "window_attn_ms_per_step.sample", "window_attn_roofline",
       "window_prep_ms_per_step.sample")
READERS = {name: spec.load_reader(ROOT / "benchmark" / "metrics"
                                  / f"{name}.py")
           for name in NEW + ("device_idle_pct.sample",
                              "device_ms_per_step.sample", "mfu.sample",
                              "backbone_ms_per_step.sample")}


def test_counts_at_the_configuration():
    assert swinv2_counts.forward_macs(CONFIG) == 115_383_787_008
    assert swinv2_counts.forward_flops(CONFIG) == pytest.approx(230.8e9,
                                                                rel=1e-3)
    assert swinv2_counts.attention_core_macs(CONFIG) == 15_415_640_064
    flops, nbytes = swinv2_counts.attention_step(CONFIG, 64)
    # per image: 12 x the cores' 7.708e9 multiply-adds of one product pair
    # over two; 24 B x the 13.71M (window, head, token, channel) elements
    assert flops == 64 * 6 * 15_415_640_064
    assert nbytes == 64 * 24 * 13_713_408
    bound = swinv2_counts.attention_bound_s(CONFIG, 64,
                                            constants.BF16_PEAK_FLOPS,
                                            constants.HBM_BYTES_PER_S)
    assert bound == pytest.approx(nbytes / 3.35e12)   # traffic-bound
    assert bound == pytest.approx(6.2877e-3, rel=1e-4)


def _reference_flops(batch):
    lay = layout.Layout(TINY)
    p = lay.unravel(torch.zeros(lay.dim))
    x = torch.zeros(batch, TINY["image_size"], TINY["image_size"], 3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        models.forward(p, x, TINY, precision.Products("fp32"))
    return fc.get_total_flops()


def test_counts_are_the_reference_forwards_products():
    assert _reference_flops(2) - _reference_flops(1) \
        == swinv2_counts.forward_flops(TINY)


def _sample_ctx(events, images=128, steps=2, loop="sample", config=CONFIG):
    return {"config": config, "constants": constants,
            "trace": trace.Trace(events, span_s=1e-3),
            "traced": {"steps": steps, "images": images},
            "traffic": {"loop": loop}}


def test_swinv2_readers():
    events = [ev("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", "kernel", 0, 100),
              ev("fmha_cutlassB_bf16_aligned_64x64_k32_sm80", "kernel", 100,
                 300),
              ev("nvjet_tst_128x256_64x4_4x1_v_bz_coopA_NNN", "kernel", 400,
                 400)]
    ctx = _sample_ctx(events)
    # busy 800 us, 128 images
    assert READERS["swinv2_mfu.sample"](ctx) == pytest.approx(
        100 * 3 * 2 * 115_383_787_008 * 128 / 800e-6 / 989e12)
    # the cores 400 us over 2 steps
    assert READERS["window_attn_ms_per_step.sample"](ctx) == pytest.approx(
        0.2)
    bound = swinv2_counts.attention_bound_s(CONFIG, 128, 989e12, 3.35e12)
    assert READERS["window_attn_roofline"](ctx) == pytest.approx(
        100 * bound / 400e-6)
    no_attention = _sample_ctx(events[2:])
    for name in ("window_attn_ms_per_step.sample", "window_attn_roofline"):
        assert READERS[name](no_attention) is None
        assert READERS[name](_sample_ctx(events, loop="predict")) is None
    vit = json.loads((ROOT / "benchmark" / "configs"
                      / "vit_l_32.json").read_text())
    for name in ("swinv2_mfu.sample", "window_attn_roofline"):
        assert READERS[name](_sample_ctx(events, config=vit)) is None


def test_adam_readers_are_the_sample_readers():
    events = [ev("gemm", "kernel", 0, 300), ev("philox_draw_kernel", "kernel",
                                               500, 100)]
    vit = json.loads((ROOT / "benchmark" / "configs"
                      / "vit_l_32.json").read_text())
    ctx = _sample_ctx(events, config=vit, loop="adam_sample")
    as_sample = _sample_ctx(events, config=vit)
    for base in ("device_idle_pct", "device_ms_per_step", "mfu",
                 "backbone_ms_per_step"):
        got = READERS[f"{base}.adam_sample"](ctx)
        assert got is not None
        assert got == READERS[f"{base}.sample"](as_sample)
        assert READERS[f"{base}.adam_sample"](as_sample) is None
        assert READERS[f"{base}.sample"](ctx) is None


def test_update_reader_reads_the_fp32_elementwise_kernels():
    events = [
        ev("void at::native::vectorized_elementwise_kernel<4, at::native::"
           "CUDAFunctor_add<float>, std::array<char*, 3ul> >", "kernel", 0,
           300),
        ev("void at::native::vectorized_elementwise_kernel<4, at::native::"
           "sqrt_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}>",
           "kernel", 300, 100),
        ev("void at::native::vectorized_elementwise_kernel<4, at::native::"
           "GeluCUDAKernelImpl::{lambda(c10::BFloat16)#1}>", "kernel", 400,
           200),
        ev("void at::native::vectorized_elementwise_kernel<4, at::native::"
           "BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16>>",
           "kernel", 600, 50),
        ev("void at::native::unrolled_elementwise_kernel<at::native::"
           "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::"
           "{lambda(float)#1}>", "kernel", 650, 40),
        ev("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<"
           "float, at::native::func_wrapper_t<float> > >", "kernel", 700,
           50),
        ev("nvjet_tst_128x256_64x4_4x1_v_bz_coopA_TNN", "kernel", 800, 100)]
    vit = json.loads((ROOT / "benchmark" / "configs"
                      / "vit_l_32.json").read_text())
    read = READERS["update_ms_per_step.adam_sample"]
    # the two float32 elementwise kernels, 400 us over 2 steps
    assert read(_sample_ctx(events, config=vit, loop="adam_sample")) \
        == pytest.approx(0.2)
    assert read(_sample_ctx(events, config=vit)) is None
    assert read(_sample_ctx(events[2:], config=vit,
                            loop="adam_sample")) is None
    fp32 = dict(vit, compute_dtype="float32")
    assert read(_sample_ctx(events, config=fp32, loop="adam_sample")) is None


def test_window_prep_reads_the_forward_spans():
    rows = [("epoch", 0, 3000, None, 0), ("step", 100, 2900, 0, 1),
            ("forward", 100, 1000, 1, None),
            ("swin.stage", 100, 900, 2, 0),
            ("swin.window", 100, 200, 3, None),
            ("swin.bias", 200, 300, 3, None),
            ("swin.attn", 300, 400, 3, None)]
    events = [ev("roll_kernel", "kernel", 150, 40, 1),
              ev("cudaLaunchKernel", "cuda_runtime", 110, 5, 1),
              ev("sigmoid_kernel", "kernel", 250, 20, 2),
              ev("cudaLaunchKernel", "cuda_runtime", 210, 5, 2),
              ev("fmha_cutlassF", "kernel", 400, 300, 3),
              ev("cudaLaunchKernel", "cuda_runtime", 310, 5, 3),
              ev("roll_backward", "kernel", 2000, 50, 4),
              ev("cudaLaunchKernel", "cuda_runtime", 1900, 5, 4)]
    ctx = {"trace": traced(events, rows, span_s=3e-3),
           "traffic": {"loop": "sample"}, "traced": {"steps": 2}}
    # 40 + 20 us launched in the two spans over 2 steps; the backward's
    # kernel was launched after they closed
    assert READERS["window_prep_ms_per_step.sample"](ctx) == pytest.approx(
        0.03)
    bare = {"trace": trace.Trace(events, span_s=3e-3),
            "traffic": {"loop": "sample"}, "traced": {"steps": 2}}
    assert spans.program_of(bare["trace"]) is None
    assert READERS["window_prep_ms_per_step.sample"](bare) is None


@pytest.mark.parametrize("cell,loop,arch", [
    ("swinv2_l_w24_384.sample", "sample", "swinv2"),
    ("vit_l_32.adam_sample", "adam_sample", "vit")])
def test_new_cells_are_found_from_files(cell, loop, arch):
    c = spec.load_cell(cell)
    assert c.traffic["loop"] == loop and c.config["architecture"] == arch
    assert (ROOT / "benchmark" / "loops" / f"{loop}.py").exists()
    assert {"loss_gap", "grad_gap"} & set(c.limits)
    assert all(v["limit"] > 0 for v in c.limits.values())
    assert [m["name"] for m in c.end_to_end] == ["train_img_per_s",
                                                 "setup_s"]
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    if loop == "adam_sample":
        assert {k: c.traffic[k] for k in adam_sample.ADAM_KEYS} == {
            "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
        assert c.traffic["method"] == "adam_csghmc"


def test_swinv2_layout_is_the_configurations():
    lay = layout.Layout(CONFIG)
    assert lay.n_params == 195_259_801 and lay.dim % 1024 == 0


def _adam_cell(seed_config=None):
    conf = json.loads((DATA / "configs" / "tiny_vit.json").read_text())
    conf["compute_dtype"] = "float32"
    mix = json.loads((ROOT / "benchmark" / "traffic"
                      / "adam_sample.json").read_text())
    mix.update(train_examples=32, trace_epochs=1)
    return spec.Cell("tiny_vit.adam_sample", 1, conf, mix, {}, [], [], {})


def test_adam_loop_replays_the_programs_steps():
    """fp32 on the CPU: the loss, the first gradient read back from Adam's
    first moment, the update replayed from the program's own state, and
    the typical part of theta's change and moments match to fp32
    rounding.  The worst part does not: a qkv bias holds the key
    biases, whose gradient is zero up to rounding, and Adam's
    preconditioner 1 / (|u| + eps) turns that rounding into steps of either
    side's own size."""
    loop = adam_sample.Loop(_adam_cell(), 2 ** 31 + 77, "cpu")
    loop.setup(warm=True)
    w = loop.window(0.2)
    assert w["failed"] == 0 and w["attempted"] > 0
    loop.free()
    got = loop.check()["numbers"]
    assert got["loss_gap"] < 1e-4 and got["grad_gap"] < 1e-5
    for name in ("change_median_gap", "welford_mean_median_gap"):
        assert got[name] < 1e-3, (name, got)
    assert got["welford_var_median_gap"] < 1e-2
    # the update replayed from the program's own state and u: v's last-bit
    # differences flip the rounding of theta (an LN scale's ulp at 1.0 is
    # a tenth of a step of 1e-6), which puts the floor near 3e-5
    assert got["adam_step_gap"] < 1e-4, got
    stand = loop.stand_ins()
    for who in ("control_fp8", "half_batch"):
        assert stand[who]["grad_gap"] > 100 * got["grad_gap"]
        assert stand[who]["change_median_gap"] \
            > 10 * got["change_median_gap"]
    assert stand["control_fp8"]["adam_step_gap"] > 30 * got["adam_step_gap"]
    assert stand["half_batch"]["adam_step_gap"] == 0.0
    # an update with a wrong constant in it reads far above the program
    right = loop._hparams
    for key, wrong in (("beta2", 0.99), ("epsilon", 1e-6),
                       ("momentum_decay", 0.06)):
        loop._hparams = lambda: dict(right(), **{key: wrong})
        assert loop.replay()[0] > 0.01, key
