#!/usr/bin/env python3
"""The port's multi-device runs across the cards of one host, over NCCL:
one CLI process per card (`--multihost`), W = min(cards, 4).

    python3 multi_card.py          # from the repository root, 2-4 cards

Runs, each through `bayesdll_tpu_torch.cli.demo` with its launches counted
and its steps timed (host clock to a synchronize, each step of a rank):
  * the full-width MLP cSGHMC (batch 128, nd 1, 1 epoch of 28 steps) with
    --data_parallel W, replicated and with --fsdp, per step and fused
    (the fused graphs hold NCCL's collectives): the three runs' states
    bitwise equal;
  * the same MLP with --num_chains W over the W cards against the
    single-process run of W chains on one card: every chain bitwise equal;
  * ViT-L/32 cSGHMC (37 classes, batch 128, bf16, 4 steps on 640
    synthetic examples, nst 1) on one card, with --data_parallel W
    --fsdp, and with --tensor_parallel 2 --data_parallel W/2: ms/step
    (the median over the steps after each run's first of the slowest
    rank's) and each run's first loss against the one-card run's (the
    fsdp run against one jittered chain on one card);
  * the DCP directory that the MLP's --data_parallel W --fsdp run saves
    after its epoch, and the pickle written beside it, each resumed to a
    second epoch on 2 cards (--data_parallel 2 --fsdp) and on 1 card (a
    world of one rank over NCCL): at each layout the directory's resume
    bitwise equal to the pickle's.
Prints the card's name and power limit, a line per run, and a JSON record
as its last line.  Exits non-zero when a run fails or a check does not
hold, and without a result when fewer than two cards are visible.
"""

from __future__ import annotations

import json
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# a rank (or the single process): the CLI's main with its steps timed, its
# launches counted from 0, its whole states (every chain's) and first-step
# losses written to a pickle
RANK_RUN = r'''
import json, pickle, sys, time
import torch
import bayesdll_tpu_torch.data as data
from bayesdll_tpu_torch.cli import demo
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.ops import kernels
from bayesdll_tpu_torch.parallel import chains, runner as mcr
out_path, opts, argv = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3:]
cut = opts["cut"]
if cut:
    prepare = data.prepare
    def cut_prepare(cfg):
        cfg.synthetic_n_train, cfg.synthetic_n_test = cut
        return prepare(cfg)
    data.prepare = cut_prepare
seen, ms, losses = {}, [], []
def timed(fn):
    def step(self, *a, **k):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = fn(self, *a, **k)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - tic) * 1e3)
        losses.append(float(out[0].float().mean()))
        return out
    return step
chains.MultiChainTrainer._step_local = timed(
    chains.MultiChainTrainer._step_local)
base.BaseRunner._one_step = timed(base.BaseRunner._one_step)
train = mcr.MultiChainRunner.train
def keep(self, *a, **k):
    seen["mc"] = self
    return train(self, *a, **k)
mcr.MultiChainRunner.train = keep
for name in kernels.KERNELS:
    getattr(kernels, name).launches = 0
res = demo.main(argv)
torch.cuda.synchronize()
out = {"counts": kernels.launch_counts(), "nll": res["nll"], "ms": ms,
       "losses": losses}
if "mc" in seen:
    mc = seen["mc"]
    out["states"] = [base.to_host(s) for s in mc.trainer.all_chains()[0]]
    out["workdir"] = mc.workdir
    if opts.get("pickle"):  # the pickle beside the run's DCP directory
        mc.cfg.ckpt_backend = "pickle"
        out["pickle"] = mc.save_ckpt(mc.cfg.epochs - 1)
with open(out_path, "wb") as f:
    pickle.dump(out, f)
'''
HP = "prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,bias=informative,nst=2"
MLP = ["--method", "csghmc", "--backbone", "mlp_mnist", "--dataset",
       "synthetic", "--lr", "1e-3", "--epochs", "1", "--num_cycles", "1",
       "--device", "cuda", "--hparams", HP]
VIT = ["--method", "csghmc", "--backbone", "vit_l_32", "--num_classes", "37",
       "--dataset", "synthetic", "--batch_size", "128", "--compute_dtype",
       "bfloat16", "--epochs", "1", "--num_cycles", "1", "--lr", "1e-3",
       "--device", "cuda", "--hparams",
       "prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,bias=informative,nst=1"]
VIT_CUT = (640, 128)  # 4 training batches of 128 after the val split
# bf16 forward: the batch's mean gradient (data parallel) and the
# row-parallel products (TP) are summed in another order than on one card
VIT_LOSS_RTOL = 2e-2


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(argv, root: Path, name: str, world: int, cut=None,
        pickle_too=False) -> list:
    """The CLI on `world` processes over NCCL (one per card), or one
    process without a group at world 0; each process's pickle.  With
    pickle_too a multi-chain run also writes its checkpoint's pickle."""
    d = root / name.replace(" ", "_")
    d.mkdir(parents=True)
    n = max(world, 1)
    port = free_port()
    procs, outs = [], [d / f"rank{r}.pkl" for r in range(n)]
    try:
        for r in range(n):
            group = ["--multihost", "--coordinator", f"127.0.0.1:{port}",
                     "--num_processes", str(world), "--process_id",
                     str(r)] if world else []
            with open(d / f"rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", RANK_RUN, str(outs[r]),
                     json.dumps({"cut": list(cut) if cut else None,
                                 "pickle": pickle_too}), *argv,
                     "--log_dir", str(d), *group], cwd=REPO, stdout=log,
                     stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in bad:
        print(f"{name} rank {r}:\n{(d / f'rank{r}.log').read_text()[-5000:]}",
              flush=True)
    check(not bad, f"{name}: ranks {bad} failed")
    out = []
    for path in outs:
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


def equal(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(equal, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def step_ms(ranks) -> float:
    """The median over the steps after the first of the slowest rank's
    step times."""
    per_step = np.max([r["ms"][1:] for r in ranks], axis=0)
    return float(np.median(per_step))


def resume_elsewhere(saved, root: Path) -> dict:
    """The directory and the pickle of the run `saved` (rank 0's output)
    resumed to 2 epochs on 2 cards with --data_parallel 2 --fsdp and on 1
    card (a world of one rank, --fsdp with nothing to shard, so that the
    multi-chain runner reads the directory); at each layout the two
    resumes bitwise equal.  Each run's ranks' outputs."""
    directory = str(Path(saved["workdir"]) / "chains_ckpt_orbax")
    two = MLP + ["--epochs", "2", "--num_cycles", "2"]  # the last wins
    out = {}
    for world, layout in ((2, ["--data_parallel", "2", "--fsdp"]),
                          (1, ["--fsdp"])):
        for kind, path in (("dcp", directory), ("pickle", saved["pickle"])):
            out[f"{kind} {world} card"] = run(
                two + layout + ["--resume", path], root,
                f"resume {kind} {world}", world)
        dcp, pkl = out[f"dcp {world} card"], out[f"pickle {world} card"]
        check(equal(dcp[0]["states"], pkl[0]["states"])
              and dcp[0]["nll"] == pkl[0]["nll"],
              f"the directory's resume on {world} cards against the "
              f"pickle's")
        launches = [r["counts"]["csghmc_update"] for r in dcp + pkl]
        check(len(set(launches)) == 1 and launches[0] > 0,
              f"the resumes on {world} cards: csghmc_update launches "
              f"{launches}, once a step on every rank")
        check(not equal(dcp[0]["states"], saved["states"]),
              f"the resume on {world} cards moved the chain")
    return out


def main() -> int:
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        print("multi_card: needs at least two CUDA cards", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(f"nvidia-smi: {smi}", flush=True)
    card = smi[0]
    from bayesdll_tpu_torch.ops import kernels
    kernels.build()
    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="multi_card_", dir=REPO / "build"))
    record = {"cards": smi, "world": world}
    tic = time.perf_counter()
    try:
        dp = ["--data_parallel", str(world)]
        runs = {"dp": run(MLP + dp, root, "dp", world),
                "fsdp": run(MLP + dp + ["--fsdp"], root, "fsdp", world,
                            pickle_too=True),
                "fsdp fused": run(MLP + dp + ["--fsdp", "--fused_steps"],
                                  root, "fsdp fused", world)}
        steps = runs["dp"][0]["counts"]["csghmc_update"]
        for name, ranks in runs.items():
            check(all(equal(r["states"], ranks[0]["states"]) for r in ranks),
                  f"{name}: the ranks' whole states")
            check(all(r["counts"]["csghmc_update"] == steps for r in ranks),
                  f"{name}: launches {[r['counts'] for r in ranks]}")
        check(equal(runs["fsdp"][0]["states"], runs["dp"][0]["states"])
              and equal(runs["fsdp fused"][0]["states"],
                        runs["dp"][0]["states"]),
              "fsdp and fsdp fused against replicated data parallel")
        record["mlp_dp_ms"] = {k: step_ms(v) for k, v in runs.items()
                               if k != "fsdp fused"}
        print(f"multi_card: [{card}] csghmc mlp_mnist --data_parallel "
              f"{world}: replicated, --fsdp and --fsdp --fused_steps "
              f"bitwise equal ({steps} steps, csghmc_update once a step on "
              f"each rank); ms/step {record['mlp_dp_ms']}", flush=True)

        chains = run(MLP + ["--num_chains", str(world)], root, "chains",
                     world)
        single = run(MLP + ["--num_chains", str(world)], root,
                     "chains single", 0)
        check(equal(chains[0]["states"], single[0]["states"]),
              f"{world} chains over {world} cards against one card")
        record["mlp_chains_ms"] = {"cards": step_ms(chains),
                                   "one card": step_ms(single)}
        print(f"multi_card: [{card}] csghmc mlp_mnist --num_chains {world} "
              f"over {world} cards bitwise equal to the single-process run; "
              f"ms/step {record['mlp_chains_ms']}", flush=True)

        # the fsdp run's directory and pickle resumed on 2 cards and on 1
        resumed = resume_elsewhere(runs["fsdp"][0], root)
        record["resume_ms"] = {k: step_ms(v) for k, v in resumed.items()}
        record["resume_launches"] = {
            k: v[0]["counts"]["csghmc_update"] for k, v in resumed.items()}
        print(f"multi_card: [{card}] csghmc mlp_mnist: the DCP directory "
              f"of --data_parallel {world} --fsdp resumed on 2 cards "
              f"(--data_parallel 2 --fsdp) and on 1 card, each bitwise "
              f"equal to the pickle's resume at its layout; csghmc_update "
              f"launches {record['resume_launches']}; ms/step "
              f"{record['resume_ms']}", flush=True)

        # one card: the single runner (TP's reference) and, with --fsdp
        # and no group, the one-chain multi-chain runner whose jittered
        # start the fsdp run shares
        vit = {"one card": run(VIT, root, "vit single", 0, VIT_CUT),
               "one card chain": run(VIT + ["--fsdp"], root,
                                     "vit single chain", 0, VIT_CUT),
               "fsdp": run(VIT + dp + ["--fsdp"], root, "vit fsdp", world,
                           VIT_CUT),
               "tp": run(VIT + ["--tensor_parallel", "2", "--data_parallel",
                                str(world // 2)], root, "vit tp", world,
                         VIT_CUT)}
        for name, ref in (("fsdp", "one card chain"), ("tp", "one card")):
            first = vit[name][0]["losses"][0]
            want = vit[ref][0]["losses"][0]
            check(abs(first - want) <= VIT_LOSS_RTOL * abs(want),
                  f"vit {name}: first loss {first} against {ref} {want}")
        record["vit_ms"] = {k: step_ms(v) for k, v in vit.items()}
        record["vit_first_loss"] = {k: v[0]["losses"][0]
                                    for k, v in vit.items()}
        print(f"multi_card: [{card}] csghmc vit_l_32 bf16 batch 128: "
              f"ms/step {record['vit_ms']}; first loss "
              f"{record['vit_first_loss']}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record["seconds"] = time.perf_counter() - tic
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
