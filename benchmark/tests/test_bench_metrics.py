"""The trace reading and the per-layer readers on hand-built event lists."""

from __future__ import annotations

import json

import pytest

from benchmark import constants, spec, trace

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
READERS = {m["name"]: spec.load_reader(spec.ROOT / "benchmark" / "metrics"
                                       / f"{m['name']}.py")
           for m in BENCH["per_layer"]}


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def window(*events, start=1000.0, span=1000.0):
    """A trace whose window is [start, start + span] microseconds."""
    return trace.Trace([ev(trace.WINDOW, "user_annotation", start, span),
                        *events])


def test_busy_is_the_union_not_the_sum():
    tr = window(ev("gemm_a", "kernel", 1100, 200),      # 100-300
                ev("gemm_b", "kernel", 1200, 200),      # overlaps: 200-400
                ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1500,
                   100),                                # 500-600
                ev("aten::mm", "cpu_op", 1000, 900),    # host: not busy
                ev("late", "kernel", 1950, 200))        # clipped: 950-1000
    assert tr.span_s == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx((300 + 100 + 50) * 1e-6)
    idle = READERS["device_idle_pct.predict"]({"trace": tr,
                                               "traffic": {"loop": "predict"}})
    assert idle == pytest.approx(55.0)
    assert READERS["device_idle_pct.sample"](
        {"trace": tr, "traffic": {"loop": "predict"}}) is None


def test_a_device_profile_takes_its_span_from_the_events_timing():
    """A device profile has no host annotation: its window starts at the
    first device event and lasts as long as the CUDA events timed it; the
    host profile's gaps name the breakdown's idle gaps."""
    tr = trace.Trace([ev("gemm_a", "kernel", 5000, 200),
                      ev("gemm_b", "kernel", 5100, 300),
                      ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy",
                         5600, 100)], span_s=1e-3)
    assert tr.span_s == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx(500e-6)
    tr.host_gaps = {"aten::copy_": 4e-4, "host outside any aten op": 1e-4}
    assert tr.breakdown()["idle_gaps"] == [["aten::copy_", 4e-4],
                                           ["host outside any aten op",
                                            1e-4]]


def test_idle_gaps_are_named_by_the_innermost_host_op():
    tr = window(ev("k", "kernel", 1000, 100),
                ev("aten::to", "cpu_op", 1050, 600),
                ev("aten::copy_", "cpu_op", 1100, 300),
                ev("k2", "kernel", 1500, 500))
    gaps = tr.idle_by_host_op()
    # the gap 100-500 has its middle at 300, inside copy_ (100-400)
    assert gaps == {"aten::copy_": pytest.approx(400e-6)}
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k2", pytest.approx(500e-6)]
    assert bd["idle_gaps"] == [["aten::copy_", pytest.approx(400e-6)]]


def test_update_roofline_counts_20_bytes_an_element():
    dim = 305_549_312
    bound = 20 * dim / 3.35e12          # 1.824 ms
    tr = window(ev("void csghmc_update_kernel<false>", "kernel", 1000, 400),
                ev("void csghmc_update_kernel<false>", "kernel", 1500, 400),
                span=1000.0)
    ctx = {"trace": tr, "dim": dim, "constants": constants,
           "traffic": {"loop": "sample"}}
    # each launch 400 us against the 1824 us bound
    got = READERS["csghmc_update_roofline"](ctx)
    assert got == pytest.approx(100 * bound / 400e-6)
    # a kernel that reads a 4 B lr vector as well and runs at the bytes
    # bound of its 24 B reads 20/24 of this count
    at_24 = 24 * dim / 3.35e12
    tr = window(ev("csghmc_update_kernel", "kernel", 1000, at_24 * 1e6),
                span=at_24 * 1e6 + 1)
    ctx["trace"] = tr
    assert READERS["csghmc_update_roofline"](ctx) == pytest.approx(
        100 * 20 / 24)
    ctx["trace"] = window(ev("gemm", "kernel", 1000, 10))
    assert READERS["csghmc_update_roofline"](ctx) is None


def test_mfu_counts():
    config = {"backbone": "vit_l_32", "compute_dtype": "bfloat16"}
    # busy 300 us of a 1000 us window: 100-300 and 500-600
    tr = window(ev("gemm_a", "kernel", 1100, 200),
                ev("gemm_b", "kernel", 1500, 100))
    ctx = {"config": config, "constants": constants, "trace": tr,
           "traced": {"images": 1280, "steps": 10, "passes": 1},
           "traffic": {"loop": "sample"}}
    got = READERS["mfu.sample"](ctx)
    assert got == pytest.approx(100 * 3 * 30.5e9 * 1280 / 300e-6 / 989e12)
    ctx["traffic"] = {"loop": "predict", "components": 4, "nst": 5}
    assert READERS["mfu.predict"](ctx) == pytest.approx(
        100 * 30.5e9 * 1280 * 20 / 300e-6 / 989e12)
    assert READERS["mfu.sample"](ctx) is None
    config["backbone"] = "vit_tiny"
    assert READERS["mfu.predict"](ctx) is None


def test_device_time_per_unit_is_the_busy_union():
    tr = window(ev("gemm_a", "kernel", 1100, 200),
                ev("gemm_b", "kernel", 1200, 200),
                ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1500,
                   100))
    ctx = {"trace": tr, "traced": {"steps": 2, "passes": 4},
           "traffic": {"loop": "sample"}}
    assert READERS["device_ms_per_step.sample"](ctx) == pytest.approx(0.2)
    assert READERS["device_ms_per_pass.predict"](ctx) is None
    ctx["traffic"] = {"loop": "predict"}
    assert READERS["device_ms_per_pass.predict"](ctx) == pytest.approx(0.1)
    ctx["trace"] = window()
    assert READERS["device_ms_per_pass.predict"](ctx) is None


def test_backbone_and_copy_times():
    tr = window(ev("sm90_xmma_gemm_bf16", "kernel", 1000, 100),
                ev("flash_fwd_kernel", "kernel", 1100, 50),
                ev("vectorized_layer_norm_kernel", "kernel", 1150, 10),
                ev("elementwise_kernel", "kernel", 1160, 40),
                ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1200, 300),
                ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1500,
                   100))
    ctx = {"trace": tr, "constants": constants, "traffic": {"loop": "sample"},
           "traced": {"steps": 2}}
    assert READERS["backbone_ms_per_step.sample"](ctx) == pytest.approx(0.08)
    ctx.update(traffic={"loop": "predict"},
               traced={"forwards": 4, "passes": 2})
    assert READERS["backbone_ms_per_fwd.predict"](ctx) == pytest.approx(0.04)
    assert READERS["h2d_ms_per_pass.predict"](ctx) == pytest.approx(0.15)


def test_families_are_the_frozen_copy():
    assert constants.family("sm90_xmma_gemm_bf16bf16") == "conv and gemm"
    assert constants.family("void csghmc_update_kernel<false>") == "sampler"
    assert constants.family("cudnn::bn_fw_tr_1C11_kernel") == "conv and gemm"
    assert constants.family("batch_norm_collect_statistics") == "batch norm"
