#!/usr/bin/env python3
"""philox_draw's launch shapes, timed against each other on one card.

    python3 draw_sweep.py          # from the repository root

Builds bayesdll_tpu_torch/csrc/philox_draw.cu once for each launch shape
(element quads per thread and iteration, BDL_DRAW_QUADS), the same for
both kinds and every length, and as it stands (its shape chosen by kind
and length) and, where build/parent_csrc holds
the sources of the commit before, that kernel too, all nvcc processes
started together.  Every shape
must write the same bits as the built-in one (the kernel's function does
not depend on its shape), and the built-in one is held against the plain
version on a window (uniforms bitwise, normals within chip_smoke.py's
DRAW_TOL; the commit before's normals within DRAW_TOL too).  Then each
draws a normal and a uniform vector at each of DIMS, L2 flushed before each launch, the shapes in turns and then in
the reverse order, beside torch.randn and torch.rand.  Prints ptxas's
registers for each build, a line per D and kind, and a JSON record last.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from chip_smoke import (DRAW_BYTES_PER_ELEM, DRAW_TOL, PARENT_CSRC, SCRATCH,
                        VIT_DIM, check, cuda_ms_cold, peak_bytes_per_s)

# name -> the shape's -D flags, for both kinds at every D; the last is the
# kernel as it stands
SHAPES = {
    "1 quad a thread (the earlier shape)": ("QUADS=1",),
    "2 quads a thread": ("QUADS=2",),
    "4 quads a thread": ("QUADS=4",),
    "8 quads a thread": ("QUADS=8",),
    "built in": (),
}
# the full-width MLP, four times it, ResNet-101 and ViT-L/32
DIMS = (2_797_568, 11_190_272, 42_576_896, VIT_DIM)
PARENT = "the commit before's kernel"
ITERS = 100


def build(kernels) -> dict:
    out_dir = SCRATCH / "draw_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    builds = {n: (kernels.CSRC / "philox_draw.cu",
                  [f"-DBDL_DRAW_{d}" for d in defs])
              for n, defs in SHAPES.items()}
    if (PARENT_CSRC / "philox_draw.cu").exists():
        builds[PARENT] = (PARENT_CSRC / "philox_draw.cu", [])
    for i, (name, (src, defs)) in enumerate(builds.items()):
        lib = out_dir / f"libphilox_draw_{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, *defs, "-Xptxas", "-v",
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"nvcc {name}:\n{log}")
        regs = [int(line.split("Used")[1].split()[0])
                for line in log.splitlines() if "registers" in line]
        print(f"draw_sweep: {name}: ptxas registers per instantiation {regs}",
              flush=True)
        lib = ctypes.CDLL(str(path))
        argtypes = list(kernels._ARGTYPES["philox_draw"])
        # a source from before the global element offset takes no elem0
        lib.elem0 = b"elem0" in builds[name][0].read_bytes()
        if not lib.elem0:
            del argtypes[2]
        lib.philox_draw.argtypes = argtypes
        lib.philox_draw.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("draw_sweep: no CUDA device", file=sys.stderr)
        return 1
    from bayesdll_tpu_torch.ops import fused, kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build(kernels)
    sid, stream = kernels.STREAM_VI, torch.cuda.current_stream().cuda_stream
    flush = torch.zeros(64 * 2**20, device="cuda")
    built_in = list(SHAPES)[-1]
    record = {"card": smi, "iters": ITERS, "ms": {}}
    for dim in DIMS:
        out = torch.empty(dim, device="cuda")
        step = [0]

        def draw(lib, kind, out=out, step=step):
            step[0] += 1
            offset = (0,) if lib.elem0 else ()
            err = lib.philox_draw(out.data_ptr(), dim, *offset, kind, sid, 7,
                                  step[0], stream)
            check(err == 0, f"philox_draw launch failed: {err}")

        for kind, kname in ((0, "normal"), (1, "uniform")):
            want = {}
            for name, lib in libs.items():
                step[0] = 10
                draw(lib, kind)
                want[name] = out.clone()
            n = min(dim, 1 << 20)
            plain = fused.philox_draw_plain(n, kind=kname, stream=sid, seed=7,
                                            step=11, device="cuda")
            for name, got in want.items():
                e = float((got[:n] - plain).abs().max())
                if name == PARENT or name == built_in:
                    check(e <= DRAW_TOL if kind == 0 else e == 0.0,
                          f"{name} {kname} vs plain at D={dim}: {e}")
                if name != PARENT:
                    check(torch.equal(got, want[built_in]),
                          f"{name} {kname} differs from {built_in} at D={dim}")
            del want, plain
            runs = {name: [] for name in [*libs, "torch"]}
            library = (torch.randn if kind == 0 else torch.rand)
            gen = torch.Generator(device="cuda").manual_seed(0)
            order = [*libs, "torch"]
            for turn in (order, order[::-1]):
                for name in turn:
                    fn = ((lambda: library(dim, generator=gen, device="cuda"))
                          if name == "torch" else
                          (lambda lib=libs[name]: draw(lib, kind)))
                    runs[name].append(cuda_ms_cold(fn, ITERS, flush))
            bound_ms = DRAW_BYTES_PER_ELEM * dim / peak_bytes_per_s(
                torch.cuda.get_device_name(0)) * 1e3
            text = "; ".join(
                f"{name} {'/'.join(f'{t * 1e3:.2f}' for t in v)} us "
                f"({bound_ms / (sum(v) / 2):.1%} of bound)"
                for name, v in runs.items())
            print(f"draw_sweep: [{smi}] D={dim} {kname}, L2 flushed, two runs "
                  f"in turns, bound {bound_ms * 1e3:.2f} us: {text}",
                  flush=True)
            record["ms"][f"{dim} {kname}"] = runs
        del out
        torch.cuda.empty_cache()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
