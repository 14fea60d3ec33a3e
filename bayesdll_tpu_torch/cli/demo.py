"""The command line: train a ported method on one chain or, with
--num_chains C, on C chains one after another on the card, or over the
ranks of a multi-process run (counterpart of bayesdll_tpu.cli.demo).

  python -m bayesdll_tpu_torch.cli.demo --method csghmc --backbone mlp_mnist \\
      --dataset synthetic --epochs 4 --num_cycles 2 --lr 1e-2 \\
      --hparams prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,bias=informative,nst=2 \\
      --device cuda
  python -m bayesdll_tpu_torch.cli.demo --method sghmc --dataset synthetic \\
      --epochs 4 --lr 1e-3 --momentum 0.5 \\
      --hparams prior_sig=1.0,nd=1.0,burnin=1,thin=2,nst=2 --device cuda
  python -m bayesdll_tpu_torch.cli.demo --method csghmc --backbone resnet101 \\
      --dataset synthetic --batch_size 256 \\
      --compute_dtype bfloat16 --epochs 4 --num_cycles 2 --lr 1e-3 \\
      --hparams prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,bias=informative,nst=2 \\
      [--pretrained resnet101.pth]
  python -m bayesdll_tpu_torch.cli.demo --method csghmc --backbone vit_l_32 \\
      --dataset synthetic --num_classes 37 --batch_size 128 \\
      --compute_dtype bfloat16 --epochs 16 --num_cycles 2 --lr LR \\
      --hparams prior_sig=SIG,Ninflate=1.0,nd=1.0,thin=2,bias=informative,nst=2 \\
      [--remat --remat_policy names]
  python -m bayesdll_tpu_torch.cli.demo --method adam_csghmc --dataset synthetic \\
      --epochs 2 --num_cycles 2 --batch_size 64 --lr 1e-3 \\
      --hparams prior_sig=1.0,nd=0.01,thin=2,nst=2,perform_cold_restarts=1
  python -m bayesdll_tpu_torch.cli.demo --method la --backbone resnet50 \\
      --dataset synthetic --batch_size 32 --compute_dtype bfloat16 \\
      --epochs 1 --lr 2e-2 \\
      --hparams prior_sig=0.1,Ninflate=1.0,bias=informative,nst=2,fisher_microbatch=8

  python -m bayesdll_tpu_torch.cli.demo --method csghmc --backbone resnet50 \\
      --num_chains 2 --dataset synthetic --batch_size 32 \\
      --compute_dtype bfloat16 --epochs 2 --num_cycles 1 --lr 2e-2 \\
      --hparams prior_sig=1.0,Ninflate=1.0,nd=0.01,thin=2,bias=informative,nst=2

  python -m bayesdll_tpu_torch.cli.demo --method csghmc --backbone mlp_mnist \\
      --dataset synthetic --epochs 4 --num_cycles 2 --lr 1e-3 --fused_steps \\
      --hparams prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,bias=informative,nst=2

--fused_steps runs each segment of steps between host hooks (cycle ends,
the 256 MiB batch window) as replays of one captured CUDA graph of the
step (methods/graphed.py), with the same results as without it; on the
CPU the same step body runs eagerly.  It serves all eleven methods (la in
its stage 1), on one chain or with --num_chains; the step draws of vi,
mc_dropout, adam_sghmc and adam_csghmc come from the philox_draw kernel,
which reads the step from the card.

--num_chains C > 1 wraps the runner in parallel/runner.py::MultiChainRunner:
C chains with their own jitter, data order and seed, a chain-mixture
predictive, and `chains_ckpt.pkl`, which --resume takes; with
--ckpt_backend orbax the checkpoint is the torch.distributed.checkpoint
directory `chains_ckpt_orbax` (the JAX package's name; not orbax's format),
and --resume takes that directory.

Multi-process runs (parallel/mesh.py): every process runs this command
with --multihost --coordinator HOST:PORT --num_processes N --process_id R
(rank 0 listens at HOST:PORT); one process per card over NCCL, or with
--dist_backend gloo several processes sharing one card.  The chains go
over the 'chain' axis of a ('chain', 'data') mesh (its size the largest
divisor of --num_chains up to N / --data_parallel); --data_parallel D
splits each chain's batch over D ranks, its gradient averaged over them;
--fsdp also slices each chain's flat vectors over them.  With
--data_parallel, --fsdp or more than one process the chains go through
MultiChainRunner even at --num_chains 1.  --tensor_parallel M runs the ViT
Megatron-style over a (D data x M model) mesh, single chain only
(parallel/tp.py), for every method; --remat and --remat_policy checkpoint
its tensor-parallel blocks as they do the single card's.  Every rank
trains; rank 0 logs to the terminal and writes the artifacts, the others
log to logs.rank<R>.txt.

--resume takes a chains_ckpt_orbax directory at any layout with the same
--num_chains and --seed: a run saved with --data_parallel 2 --fsdp on two
processes resumes in one process without --fsdp, on four, or the other
way round (each rank reads its own chains and slices).  The flat vectors
are padded to lcm(1024, 4 x processes) elements, so a world whose size is
not a power of two pads otherwise, and its directory resumes only at a
world that pads the same (the load says so before it reads a tensor).

  python -m bayesdll_tpu_torch.cli.demo --method csghmc --dataset synthetic \\
      --epochs 2 --num_cycles 1 --lr 1e-3 --data_parallel 2 --fsdp \\
      --multihost --coordinator 127.0.0.1:29500 --num_processes 2 \\
      --process_id R --device cuda \\
      --hparams prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,bias=informative,nst=2

--profile_dir writes a torch.profiler trace of `train` (the card's kernels
included) that TensorBoard and Perfetto load, and beside it
(`<same stem>.program.json`) the program's spans (epoch, step, forward,
update, batch gather and copy, predictive pass, draw, host read, cycle end)
and counters (bytes to the card, bytes pinned, host reads) on the trace's
clock; --use_wandb logs the run's
config and its final results to wandb where the package is installed, and
does nothing where it is not.

With perform_cold_restarts=1, Adam-cSGHMC and cSGHMC-FS re-draw θ at each
cycle boundary from the backbone's own initialisers (`make_reinit_fn`).
--full_sample keeps every θ a cyclical method collects, in
`all_samples.pkl`.

--pretrained takes a local torchvision state_dict: its body with a zeroed
head is the prior mean, and its body with the random head is the starting
θ.  Its BatchNorm running statistics are not loaded, as in the JAX
package's CLI.

Artifacts (logs, logits, checkpoints, reliability plots) go to
`<log_dir>/<run name>/`; the plots need matplotlib.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys

import torch
import torch.distributed as dist


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="bayesdll-tpu PyTorch demo driver")
    p.add_argument("--method", type=str, default="csghmc",
                   help="vanilla|vi|mc_dropout|sgld|sghmc|adam_sghmc|csgld|"
                        "csghmc|adam_csghmc|csghmc_fs|la")
    p.add_argument("--hparams", type=str, default="",
                   help="comma-separated key=val string")
    p.add_argument("--pretrained", type=str, default=None,
                   help="path to a torchvision state_dict (.pth) used as "
                        "the prior mean")
    p.add_argument("--dataset", type=str, default="mnist",
                   help="mnist|cifar10|cifar100|pets|imagenet|synthetic")
    p.add_argument("--backbone", type=str, default="mlp_mnist",
                   help="mlp_mnist|cnn_mnist|resnet50|resnet101|vit_l_32|"
                        "vit_b_16|vit_tiny")
    p.add_argument("--val_heldout", type=float, default=0.1)
    p.add_argument("--ece_num_bins", type=int, default=15)
    p.add_argument("--num_cycles", type=int, default=4)
    p.add_argument("--proportion_exploration", type=float, default=0.5)
    p.add_argument("--full_sample", action="store_true",
                   help="cyclical methods: archive every collected θ")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--lr_head", type=float, default=None)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", type=str, default="results")
    p.add_argument("--test_eval_freq", type=int, default=1)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--num_classes", type=int, default=10,
                   help="classes of the synthetic set (MNIST has 10)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="forward-pass dtype (bfloat16 for big backbones)")
    p.add_argument("--remat", action="store_true",
                   help="recompute ViT encoder blocks in the backward pass "
                        "(memory for FLOPs), tensor-parallel blocks too")
    p.add_argument("--remat_policy", type=str, default="",
                   choices=["", "dots", "names"],
                   help="remat policy: '' full, 'dots' save matmul outputs, "
                        "'names' save qkv, attn_out and mlp_hidden")
    p.add_argument("--fused_attention", type=int, default=1,
                   help="1 = F.scaled_dot_product_attention core (default)")
    p.add_argument("--gelu_approx", type=int, default=0,
                   help="1 = tanh GELU in the ViT MLP; 0 = exact erf")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--num_chains", type=int, default=1,
                   help="independent chains, one after another on the card")
    p.add_argument("--fused_steps", action="store_true",
                   help="run each segment of steps as replays of a captured "
                        "CUDA graph of the step")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="within-chain batch sharding over the 'data' ranks")
    p.add_argument("--fsdp", action="store_true",
                   help="also shard each chain's flat vectors over the "
                        "'data' ranks")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="Megatron tensor parallelism of the ViT over the "
                        "'model' ranks (with --data_parallel on a ('data', "
                        "'model') mesh; single chain only; with --remat)")
    p.add_argument("--multihost", action="store_true",
                   help="join a process group of --num_processes ranks at "
                        "--coordinator before anything is built")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0's TCP store")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="the process group's backend: nccl on cuda, gloo "
                        "on cpu by default; gloo on cuda lets several "
                        "ranks share one card")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path to resume training from (ckpt.pkl, "
                        "or with --num_chains chains_ckpt.pkl or the "
                        "chains_ckpt_orbax directory, which resumes at any "
                        "--data_parallel, --fsdp and process count with "
                        "the same chains)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of training here, "
                        "and beside it the program's spans and counters "
                        "(<stem>.program.json, category 'program') on the "
                        "same clock")
    p.add_argument("--ckpt_backend", type=str, default="auto",
                   choices=["auto", "pickle", "orbax"],
                   help="multi-chain checkpoint backend: orbax = the "
                        "torch.distributed.checkpoint directory; auto = "
                        "that directory when a process group spans "
                        "processes, pickle otherwise")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", type=str, default="bayesdll-tpu")
    p.add_argument("--wandb_name", type=str, default=None)
    return p.parse_args(argv)


def build_all(cfg, logger, workdir=None):
    """Data + backbone + prior + runner; over the process group (when one
    exists) the TP or ('chain', 'data') layout of the JAX package's
    build_all."""
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.data import prepare
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models import convert, create_backbone
    from bayesdll_tpu_torch.parallel import mesh as mesh_util

    train, val, test, nd = prepare(cfg)
    logger.info("dataset %s prepared: ND=%d, num_classes=%d",
                cfg.dataset, nd, cfg.num_classes)
    world = mesh_util.world_size()
    data_parallel = (cfg.mesh_shape or {}).get("data", 1)
    backbone_kw = cfg.backbone_kw()
    tp_mesh = None
    if cfg.tensor_parallel > 1:
        # Megatron TP over a ('data', 'model') mesh, single chain only
        if cfg.num_chains > 1:
            raise ValueError(
                "--tensor_parallel requires --num_chains 1 (chains over TP "
                "groups are a multi-host layout, one process group per "
                "chain)")
        from bayesdll_tpu_torch.parallel import (make_tp_constraints,
                                                 make_tp_mesh)
        tp_mesh = make_tp_mesh(data_parallel, cfg.tensor_parallel)
        backbone_kw["tp"] = make_tp_constraints(tp_mesh)
        logger.info("tensor-parallel mesh: %s", dict(zip(
            tp_mesh.mesh_dim_names, tp_mesh.mesh.shape)))
    model, _input_shape, meta = create_backbone(
        cfg.backbone, num_classes=cfg.num_classes, **backbone_kw)

    theta0_params = None
    if cfg.pretrained is not None:
        # the pretrained body with a ZEROED head is the prior mean
        theta0_params = convert.load_pretrained_params(
            cfg.pretrained, cfg.backbone, num_classes=cfg.num_classes,
            zero_head=True)
    target, theta_init, net_state = make_flat_target(
        model, nd_size=nd, num_classes=cfg.num_classes,
        rng=torch.Generator().manual_seed(cfg.seed),
        theta0_params=theta0_params,
        has_batch_stats=meta["has_batch_stats"], device=cfg.device,
        # every rank's slice of a flat vector whole element quads
        pad_to=math.lcm(1024, 4 * world))
    if cfg.pretrained is not None:
        # the workhorse starts from the pretrained body and a random head
        theta_init = convert.pretrained_workhorse_theta(
            cfg.pretrained, cfg.backbone, target, theta_init,
            num_classes=cfg.num_classes)
    logger.info("backbone %s: %d parameters", cfg.backbone, target.n_params)
    runner = get_runner_cls(cfg.method)(target, theta_init, net_state, cfg,
                                        logger=logger, workdir=workdir)
    if hasattr(runner, "set_reinit_fn"):
        runner.set_reinit_fn(make_reinit_fn(model, target, cfg.seed))
    if tp_mesh is not None:
        from bayesdll_tpu_torch.parallel import shard_runner_for_tp
        if dist.get_rank() != 0:
            runner.workdir = None  # rank 0 writes the artifacts
        return shard_runner_for_tp(runner, tp_mesh), (train, val, test)
    if cfg.num_chains > 1 or data_parallel > 1 or cfg.fsdp or world > 1:
        from bayesdll_tpu_torch.parallel import MultiChainRunner
        mesh = None
        if dist.is_initialized():
            # the chain axis: the largest divisor of num_chains that fits
            avail = max(1, world // data_parallel)
            axis = max(d for d in range(1, min(avail, cfg.num_chains) + 1)
                       if cfg.num_chains % d == 0)
            mesh = mesh_util.make_mesh(axis, data_parallel)
        elif data_parallel > 1:
            raise ValueError(f"--data_parallel {data_parallel} needs that "
                             f"many ranks: launch with --multihost")
        runner = MultiChainRunner(runner, cfg.num_chains, logger=logger,
                                  workdir=workdir, fsdp=cfg.fsdp, mesh=mesh)
    return runner, (train, val, test)


def make_reinit_fn(model, target, seed: int):
    """The cold restart's fresh θ: fn(cycle, seed=seed) draws the backbone's
    own initialisers from the generator keyed (seed, REINIT, cycle) on the
    host, zero-padded to target.dim, on the target's device.  A multi-chain
    run passes each chain's seed."""
    from bayesdll_tpu_torch.core import flat as flat_util
    from bayesdll_tpu_torch.core import rng

    def reinit_fn(cycle: int, seed: int = seed) -> torch.Tensor:
        gen = rng.generator("cpu", seed, rng.REINIT, cycle)
        theta, _ = flat_util.flatten_params(model.init_params(gen))
        theta = torch.cat([theta, torch.zeros(target.dim - theta.shape[0])])
        return theta.to(target.device)

    return reinit_fn


def main(argv=None):
    args = parse_args(argv)
    if args.multihost:
        # before anything is built: the mesh spans the process group
        from bayesdll_tpu_torch.parallel import init_distributed
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, backend=args.dist_backend,
                         device=args.device)
    from bayesdll_tpu_torch.config import Config

    cfg = Config(
        method=args.method, hparams=args.hparams, pretrained=args.pretrained,
        dataset=args.dataset, backbone=args.backbone,
        val_heldout=args.val_heldout,
        ece_num_bins=args.ece_num_bins, num_cycles=args.num_cycles,
        proportion_exploration=args.proportion_exploration,
        full_sample=args.full_sample, epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        lr_head=args.lr_head, momentum=args.momentum, seed=args.seed,
        log_dir=args.log_dir, test_eval_freq=args.test_eval_freq, data_root=args.data_root,
        num_classes=args.num_classes, num_chains=args.num_chains,
        fused_steps=args.fused_steps,
        compute_dtype=args.compute_dtype, remat=args.remat,
        remat_policy=args.remat_policy,
        fused_attention=bool(args.fused_attention),
        gelu_approx=bool(args.gelu_approx), device=args.device,
        ckpt_backend=args.ckpt_backend,
        mesh_shape={"chain": args.num_chains, "data": args.data_parallel},
        fsdp=args.fsdp, tensor_parallel=args.tensor_parallel)

    rank = 0
    if dist.is_initialized():
        # one run directory for every rank: rank 0's time stamp
        name = [cfg.run_name()]
        dist.broadcast_object_list(name, src=0)
        cfg._run_name = name[0]
        rank = dist.get_rank()
    workdir = os.path.join(cfg.log_dir, cfg.run_name())
    os.makedirs(workdir, exist_ok=True)
    logger = logging.getLogger("bayesdll_tpu_torch")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s] %(message)s")
    handlers = (logging.FileHandler(os.path.join(workdir, "logs.txt")),
                logging.StreamHandler(sys.stdout)) if rank == 0 else \
        (logging.FileHandler(os.path.join(workdir, f"logs.rank{rank}.txt")),)
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.info("Args: %s", vars(args))

    from bayesdll_tpu_torch.utils import profiling, wandb_compat

    if args.use_wandb and rank == 0:
        wandb_compat.init(project=args.wandb_project,
                          name=args.wandb_name or cfg.run_name(),
                          config=vars(args))

    runner, loaders = build_all(cfg, logger, workdir=workdir)
    start_epoch = 0
    if args.resume is not None:
        start_epoch = runner.load_ckpt(args.resume) + 1
        logger.info("Resumed from %s at epoch %d", args.resume, start_epoch)
    try:
        with profiling.trace(args.profile_dir):
            results = runner.train(*loaders, start_epoch=start_epoch)
        logger.info("Final results: %s", results)
        wandb_compat.summary(results)
        return results
    finally:
        wandb_compat.finish()


if __name__ == "__main__":
    main()
