"""The V-MoE cell's counts, reference, loop and readers, and the fused
cell's loop and readers; both cells found from files alone.

  * vmoe_counts.py at the configuration against a hand count, and per
    image against the FLOPs that torch's counter reads off the reference's
    forward at a tiny size;
  * the reference's leaves against the program's flat layout at the tiny
    configuration;
  * the `moe_sample` loop's check on a tiny fp32 V-MoE on the CPU: the
    program's steps against the reference's on the program's experts,
    `route_flip_share` 0 where the reference is handed its own routing,
    `kept_flip_share` 0 on the program's kept flags and above 0 on kept
    flags that break the capacity rule, and the stand-ins far above the
    program;
  * the `sample_fused` loop's check on a tiny fp32 ViT, its steps through
    the fused entry;
  * the twelve readers on hand-built traces, with and without the
    program's spans, None outside their loop.
"""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import build, constants, spans, spec, trace, vmoe_counts
from benchmark.loops import moe_sample, sample_fused
from benchmark.reference import layout, precision
from benchmark.reference.arch import vmoe as ref

from conftest import DATA, ROOT
from test_bench_spans import ev, traced

CONFIG = json.loads((ROOT / "benchmark" / "configs"
                     / "vmoe_l_16.json").read_text())
TINY = json.loads((DATA / "configs" / "tiny_vmoe.json").read_text())
NEW = ("moe_ms_per_step.moe_sample", "moe_experts_roofline",
       "vmoe_mfu.moe_sample", "device_ms_per_step.moe_sample",
       "device_idle_pct.moe_sample", "csghmc_update_roofline.moe_sample",
       "device_ms_per_step.sample_fused", "device_idle_pct.sample_fused",
       "csghmc_update_roofline.sample_fused", "mfu.sample_fused",
       "backbone_ms_per_step.sample_fused",
       "backbone_ms_per_step.moe_sample")
READERS = {name: spec.load_reader(ROOT / "benchmark" / "metrics"
                                  / f"{name}.py")
           for name in NEW + ("device_idle_pct.sample",
                              "device_ms_per_step.sample",
                              "csghmc_update_roofline", "mfu.sample",
                              "backbone_ms_per_step.sample")}


def test_counts_at_the_configuration():
    """By hand at 224^2, patch 16 (T = 197), d 1024, m 4096, 24 blocks of
    which 12 MoE, 8 of 32 experts held, batch 128: capacity round(2 x
    25,216 x 1.05 / 32) = round(1,654.68) = 1,655."""
    assert vmoe_counts.capacity(CONFIG, 128) == 1655
    flops, nbytes = vmoe_counts.experts_forward(CONFIG, 128)
    assert flops == 12 * 2 * 8 * 1655 * 2 * 1024 * 4096
    assert nbytes == 12 * 2 * (8 * 1655 * 1024 * 2 + 2 * 8 * 1024 * 4096
                               + 2 * 8 * 1655 * 4096)
    macs = (196 * 16 * 16 * 3 * 1024 + 24 * (4 * 197 * 1024 ** 2
                                             + 2 * 197 ** 2 * 1024)
            + 12 * 2 * 197 * 1024 * 4096 + 12 * 197 * 1024 * 32
            + 1024 * 37)
    assert vmoe_counts.forward_flops(CONFIG) == pytest.approx(
        2 * macs + flops / 128, rel=1e-12)
    # per image: about 80 GFLOP dense, 3.8 in the cores, 20.8 experts
    assert 104e9 < vmoe_counts.forward_flops(CONFIG) < 105e9
    bound = vmoe_counts.experts_bound_s(CONFIG, 3, 989e12, 3.35e12)
    assert bound == pytest.approx(3 * flops / 989e12)


def test_counts_are_the_reference_forwards_products():
    """torch's FLOP counter on the reference's forward of a group of the
    configuration's batch: its products at the held experts' filled slots
    (the reference computes only the kept choices) plus what every image
    runs; the count takes every slot, so it reads the capacity's share
    above."""
    lay = layout.Layout(TINY)
    th = build.theta(lay, 3, "cpu")
    x = torch.randn(TINY["batch_size"], 32, 32, 3)
    rec = []
    with FlopCounterMode(display=False) as fc:
        ref.forward(lay.unravel(th), x, TINY, precision.Products("fp32"),
                    record=rec)
    kept = sum(int(k.sum()) for _, k in rec)
    d, m = TINY["hidden_size"], TINY["intermediate_size"]
    filled = kept * 2 * d * m * 2
    per_image = vmoe_counts.forward_flops(TINY)
    slots, _ = vmoe_counts.experts_forward(TINY, TINY["batch_size"])
    dense = per_image * TINY["batch_size"] - slots
    assert fc.get_total_flops() == pytest.approx(dense + filled, rel=1e-9)
    assert filled <= slots


def test_reference_leaves_are_the_programs_layout():
    from bayesdll_tpu_torch.core import flat
    from bayesdll_tpu_torch.models import create_backbone
    lay = layout.Layout(TINY)
    model, _, _ = create_backbone("vmoe_tiny", num_classes=10)
    got = flat.leaf_spans(model.init_params(torch.Generator().manual_seed(0)))
    assert [(n, s) for n, _, s in got] == [(leaf.name, leaf.size)
                                          for leaf in lay.leaves]
    assert layout.Layout(CONFIG).n_params == 1_008_805_925


def _cell(conf, traffic, name):
    mix = json.loads((ROOT / "benchmark" / "traffic"
                      / f"{traffic}.json").read_text())
    mix.update(train_examples=32, trace_epochs=1)
    if "check_block_images" in mix:
        mix["check_block_images"] = 3
    return spec.Cell(name, 1, conf, mix, {}, [], [], {})


def test_moe_loop_checks_the_programs_steps_on_its_routing():
    loop = moe_sample.Loop(_cell(TINY, "moe_sample", "tiny_vmoe.moe_sample"),
                           2 ** 31 + 91, "cpu")
    loop.setup(warm=True)
    w = loop.window(0.2)
    assert w["failed"] == 0 and w["attempted"] > 0
    loop.free()
    assert len(loop.routing) == 3 and len(loop.routing[0]) == 2
    got = loop.check()["numbers"]
    for name in ("loss_gap", "grad_gap", "change_gap", "welford_mean_gap"):
        assert got[name] < 1e-4, (name, got)
    assert got["welford_var_gap"] < 1e-2, got
    assert got["route_flip_share"] == 0.0
    assert got["kept_flip_share"] == 0.0
    # some held choices dropped, so the capacity rule decides the output
    assert any((~k & (e < TINY["experts_held"])).any()
               for step in loop.routing for e, k in step)
    stand = loop.stand_ins()
    for who in ("control_fp8", "half_batch"):
        assert stand[who]["grad_gap"] > 100 * max(got["grad_gap"], 1e-7)
    assert stand["control_fp8"]["route_flip_share"] > 0.01
    assert stand["control_fp8"]["kept_flip_share"] == 0.0
    assert stand["half_batch"]["kept_flip_share"] > 0.0
    # a program that kept the second choices before the first: the
    # reference keeps its own flags, and the share counts the difference
    program = loop.routing
    loop.routing = [[(e, ref.own_kept(TINY, e.flip(1)).flip(1))
                     for e, _ in step] for step in program]
    wrong = loop.check()["numbers"]["kept_flip_share"]
    assert wrong == moe_sample.flip_share(
        [[k for _, k in step] for step in loop.routing],
        [[k for _, k in step] for step in program]) > 0
    # the reference handed its own routing reads its own top-2 back
    own = []
    with torch.no_grad():
        th = build.theta(loop.layout, loop.seed, "cpu")
        x = torch.as_tensor(loop.batches[0][0])
        ref.forward(loop.layout.unravel(th), x, TINY,
                    precision.Products("fp32"), record=own)
    loop.routing[0] = own
    _, tops, kepts = loop._reference()
    assert moe_sample.flip_share([[e for e, _ in own]], tops[:1]) == 0.0
    assert moe_sample.flip_share([[k for _, k in own]], kepts[:1]) == 0.0


def test_flip_share_counts_choices_in_order():
    a = [[torch.tensor([[0, 1], [2, 3]])]]
    b = [[torch.tensor([[1, 0], [2, 3], [5, 5]])]]
    assert moe_sample.flip_share(a, b) == 0.5


def test_fused_loop_checks_steps_through_the_fused_entry(monkeypatch):
    """The check's steps and the epochs after them all go through
    `run_steps`, from global steps 0 (step 1 alone), 1 and 3."""
    from bayesdll_tpu_torch.methods.base import BaseRunner
    vit = json.loads((DATA / "configs" / "tiny_vit.json").read_text())
    vit["compute_dtype"] = "float32"
    loop = sample_fused.Loop(_cell(vit, "sample_fused",
                                   "tiny_vit.sample_fused"), 2 ** 31 + 13,
                             "cpu")
    calls, orig = [], BaseRunner.run_steps

    def run_steps(self, ep, xs, ys, bi0):
        calls.append((bi0, len(xs)))
        return orig(self, ep, xs, ys, bi0)
    monkeypatch.setattr(BaseRunner, "run_steps", run_steps)
    monkeypatch.setattr(BaseRunner, "_one_step", None)
    loop.setup(warm=True)
    n = len(loop.loader)
    assert calls == [(0, 1), (1, 2), (3, n)]
    assert loop.runner.bi == 3 + n
    loop.free()
    got = loop.check()["numbers"]
    for name in ("loss_gap", "grad_gap", "change_gap", "welford_mean_gap"):
        assert got[name] < 1e-4, (name, got)
    assert got["welford_var_gap"] < 1e-2, got


def _ctx(events, loop="moe_sample", steps=2, config=CONFIG, rows=None,
         span_s=1e-3):
    tr = trace.Trace(events, span_s=span_s) if rows is None \
        else traced(events, rows, span_s=span_s)
    return {"config": config, "constants": constants, "trace": tr,
            "traced": {"steps": steps, "images": 128 * steps},
            "traffic": {"loop": loop}, "dim": 1_008_806_912}


# a step's forward spans under `step`, and a backward span opened on the
# autograd thread (no parent) while the step waits in the backward
ROWS = [("epoch", 0, 3000, None, 0), ("step", 100, 2900, 0, 1),
        ("forward", 100, 1000, 1, None),
        ("moe.route", 100, 200, 2, 0), ("moe.dispatch", 200, 300, 2, 0),
        ("moe.experts", 300, 500, 2, 0), ("moe.combine", 500, 600, 2, 0),
        ("moe.combine.bwd", 1050, 1150, None, None)]
EVENTS = [ev("softmax_kernel", "kernel", 150, 10, 1),
          ev("cudaLaunchKernel", "cuda_runtime", 110, 5, 1),
          ev("index_select_kernel", "kernel", 250, 20, 2),
          ev("cudaLaunchKernel", "cuda_runtime", 210, 5, 2),
          ev("nvjet_bmm", "kernel", 320, 300, 3),
          ev("cudaLaunchKernel", "cuda_runtime", 310, 5, 3),
          ev("gather_kernel", "kernel", 650, 30, 4),
          ev("cudaLaunchKernel", "cuda_runtime", 510, 5, 4),
          ev("index_select_bwd", "kernel", 1160, 40, 7),
          ev("cudaLaunchKernel", "cuda_runtime", 1060, 5, 7),
          ev("nvjet_bmm_bwd", "kernel", 1200, 400, 5),
          ev("cudaLaunchKernel", "cuda_runtime", 1160, 5, 5),
          ev("void csghmc_update_kernel<true>", "kernel", 2000, 500, 6),
          ev("cudaLaunchKernel", "cuda_runtime", 1900, 5, 6)]


def test_moe_readers_read_the_layers_spans():
    ctx = _ctx(EVENTS, rows=ROWS, span_s=3e-3)
    # 10 + 20 + 300 + 30 us launched in the four forward spans and 40 in
    # the combine's backward span, over 2 steps; the expert products'
    # backward was launched outside them
    assert READERS["moe_ms_per_step.moe_sample"](ctx) == pytest.approx(0.2)
    bound = vmoe_counts.experts_bound_s(CONFIG, 2, 989e12, 3.35e12)
    assert READERS["moe_experts_roofline"](ctx) == pytest.approx(
        100 * bound / 300e-6)
    busy = 1.3e-3
    assert READERS["vmoe_mfu.moe_sample"](ctx) == pytest.approx(
        100 * 3 * vmoe_counts.forward_flops(CONFIG) * 256 / busy / 989e12)
    bare = _ctx(EVENTS, span_s=3e-3)
    assert spans.program_of(bare["trace"]) is None
    for name in ("moe_ms_per_step.moe_sample", "moe_experts_roofline"):
        assert READERS[name](bare) is None
        assert READERS[name](_ctx(EVENTS, loop="sample", rows=ROWS)) is None
    assert READERS["vmoe_mfu.moe_sample"](bare) is not None
    vit = json.loads((ROOT / "benchmark" / "configs"
                      / "vit_l_32.json").read_text())
    for name in ("moe_experts_roofline", "vmoe_mfu.moe_sample"):
        assert READERS[name](_ctx(EVENTS, rows=ROWS, config=vit)) is None


@pytest.mark.parametrize("loop,names", [
    ("moe_sample", ("device_ms_per_step", "device_idle_pct",
                    "csghmc_update_roofline", "backbone_ms_per_step")),
    ("sample_fused", ("device_ms_per_step", "device_idle_pct",
                      "csghmc_update_roofline", "mfu",
                      "backbone_ms_per_step"))])
def test_wrapped_readers_are_the_sample_readers(loop, names):
    """With and without program spans: the device readers read the
    device profile alone."""
    vit = json.loads((ROOT / "benchmark" / "configs"
                      / "vit_l_32.json").read_text())
    conf = CONFIG if loop == "moe_sample" else vit
    for rows in (None, ROWS):
        ctx = _ctx(EVENTS, loop=loop, rows=rows, span_s=3e-3, config=conf)
        as_sample = _ctx(EVENTS, loop="sample", rows=rows, span_s=3e-3,
                         config=conf)
        for base in names:
            sample_name = base if base == "csghmc_update_roofline" \
                else f"{base}.sample"
            got = READERS[f"{base}.{loop}"](ctx)
            assert got is not None
            assert got == READERS[sample_name](as_sample)
            assert READERS[f"{base}.{loop}"](as_sample) is None
            assert READERS[sample_name](ctx) is None


@pytest.mark.parametrize("cell,loop,arch", [
    ("vmoe_l_16.moe_sample", "moe_sample", "vmoe"),
    ("vit_l_32.sample_fused", "sample_fused", "vit")])
def test_new_cells_are_found_from_files(cell, loop, arch):
    c = spec.load_cell(cell)
    assert c.traffic["loop"] == loop and c.config["architecture"] == arch
    assert (ROOT / "benchmark" / "loops" / f"{loop}.py").exists()
    assert {"loss_gap", "grad_gap"} & set(c.limits)
    assert all(v["limit"] > 0 for k, v in c.limits.items()
               if k != "kept_flip_share")
    assert all("from" in v for v in c.limits.values())
    assert [m["name"] for m in c.end_to_end] == ["train_img_per_s",
                                                 "setup_s"]
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    mine = {n for n in NEW if n.endswith("." + loop)}
    if loop == "moe_sample":
        mine.add("moe_experts_roofline")
    assert mine <= set(c.readers)
    if loop == "moe_sample":
        assert "route_flip_share" in c.limits
        assert c.limits["kept_flip_share"]["limit"] == 0
