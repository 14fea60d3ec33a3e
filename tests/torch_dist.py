"""Spawned gloo worlds for the port's multi-device tests.

`run_world(fn, world, *args)` starts `world` processes (`python -m
tests.torch_dist`), each joining a gloo process group on a free local port
with a 60 s timeout and one thread, runs the module-level function
`fn(rank, world, *args)` of this module in each, and returns their results.
The children import torch, numpy and the port only, never JAX: the tests
compute the JAX side in their own process and pass arrays in `args`.

`shared(name, compute)` runs compute() once per test session when pytest
runs under xdist: the first worker to ask computes and stores the result,
the others wait on a lock and read it, so each file's world is spawned once
however its tests are spread over the workers.

The rest are the worlds' bodies, one per test file.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    """The environment of a spawned rank: the repository importable, one
    thread, no JAX settings."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(REPO) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_world(fn, world: int, *args, timeout: float = 120.0):
    """fn(rank, world, *args) on each rank of a spawned gloo world; the
    ranks' results, in rank order.  A rank that fails or outlives
    `timeout` fails the call with every rank's traceback."""
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "args.pkl"), "wb") as f:
            pickle.dump((fn.__name__, args), f)
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist", d, str(r), str(world),
             port], cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        deadline = time.monotonic() + timeout
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                out += "\n(killed at the time limit)"
            logs.append(out)
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError("ranks %s failed:\n%s" % (failed, "\n".join(
                f"--- rank {r}\n{logs[r][-4000:]}" for r in failed)))
        out = []
        for r in range(world):
            with open(os.path.join(d, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _child(d: str, rank: int, world: int, port: str):
    import datetime
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(d, "args.pkl"), "rb") as f:
        name, args = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = globals()[name](rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(d, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def shared(name: str, compute):
    """compute(), once per session across xdist workers (see module
    docstring); in a run without xdist, compute()."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return compute()
    root = Path(tempfile.gettempdir()) / f"bdl-torch-dist-{run}"
    root.mkdir(exist_ok=True)
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        path = root / f"{name}.pkl"
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = compute()
        with open(path, "wb") as f:
            pickle.dump(out, f)
        return out


# ---- helpers of the worlds ---------------------------------------------------

def host(tree):
    """A state, net_state or tensor as numpy (dataclasses as dicts)."""
    from bayesdll_tpu_torch.methods import base
    return base.to_host(tree)


def mlp_runner(method, hparams, arrays, *, lr=1e-2, batch_size=16,
               momentum=0.0, num_cycles=1, epochs=1):
    """A port runner of the width-32, depth-2 MLP on the CPU from the JAX
    package's flat arrays (theta, theta0, is_head, is_bias, nd_size)."""
    from bayesdll_tpu_torch import interop
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models import create_backbone
    model, _, _ = create_backbone("mlp_mnist", num_classes=10, width=32,
                                  depth=2)
    target, theta, ns = interop.target_from_arrays(
        arrays["theta"], arrays["theta0"], arrays["is_head"],
        arrays["is_bias"], model=model, nd_size=int(arrays["nd_size"]),
        num_classes=10, device="cpu")
    cfg = Config(method=method, hparams=dict(hparams), dataset="synthetic",
                 backbone="mlp_mnist", epochs=epochs, batch_size=batch_size,
                 lr=lr, momentum=momentum, num_cycles=num_cycles, seed=0,
                 device="cpu")
    runner = get_runner_cls(method)(target, theta, ns, cfg)
    if hasattr(runner, "_ensure_sched"):
        runner._ensure_sched(4)
    return runner


def trainer_from(runner, n_chain, mesh=None, fsdp=False, theta=None):
    """A MultiChainTrainer; with `theta`, every chain's state starts at it
    (no jitter), as the JAX tests force theirs."""
    from bayesdll_tpu_torch.parallel import MultiChainTrainer
    tr = MultiChainTrainer(runner, n_chain, mesh=mesh, fsdp=fsdp)
    if theta is not None:
        tr.states = [tr.local_state(runner.init_state(
            torch.as_tensor(theta).clone())) for _ in tr.chains]
    return tr


def run_trainer(tr, xs, ys, fused_xs=None, fused_ys=None):
    """Per-step steps on xs [K, C, B, ...], then (with fused_xs) a fused
    segment; returns every chain's whole states and the losses."""
    losses = [host(tr.step(xs[k], ys[k], 0)[0]) for k in range(len(xs))]
    if fused_xs is not None:
        losses.append(host(tr.run_steps(0, fused_xs, fused_ys, tr.bi)[0]))
    states = tr.all_chains()[0]
    return {"states": [host(s) for s in states], "losses": losses,
            "local_sizes": [int(s.theta.shape[0]) if hasattr(s, "theta")
                            else int(s.m.shape[0]) for s in tr.states]}


# ---- test_torch_mesh.py --------------------------------------------------------

def mesh_world(rank, world, shapes):
    """Each of `shapes` as make_mesh builds it on this rank: its dims, its
    coordinate and the ranks of its groups; then whether make_mesh refuses
    a mesh larger than the world."""
    import torch.distributed as dist
    from bayesdll_tpu_torch.parallel import make_mesh
    out = {}
    for shape in shapes:
        m = make_mesh(*shape)
        coord = m.get_coordinate()
        out[shape] = {
            "names": m.mesh_dim_names, "shape": tuple(m.mesh.shape),
            "mesh": m.mesh.tolist(), "coord": coord,
            "groups": None if coord is None else {
                d: dist.get_process_group_ranks(m.get_group(d))
                for d in ("chain", "data")}}
    try:
        make_mesh(world, 2)
        out["too_big"] = None
    except ValueError as e:
        out["too_big"] = str(e)
    return out


# ---- test_torch_data_parallel.py ---------------------------------------------

def dp_world(rank, world, inp):
    """The API cases of test_torch_data_parallel.py on 2 gloo ranks."""
    from bayesdll_tpu_torch.parallel import make_mesh
    mesh_data = make_mesh(1, 2)    # 1 chain x 2 data ranks
    mesh_chain = make_mesh(2, 1)   # 2 chains x 1 data rank
    out = {}

    # SGLD at nd = 0 on 1 chain x 2 data ranks, and on one process
    hp = inp["sgld_nd0"]
    r = mlp_runner("sgld", hp, inp["mlp"])
    tr = trainer_from(r, 1, mesh=mesh_data, theta=inp["mlp"]["theta"])
    out["dp_nd0"] = run_trainer(tr, inp["xs"][:, :1], inp["ys"][:, :1])
    if rank == 0:
        r = mlp_runner("sgld", hp, inp["mlp"])
        tr = trainer_from(r, 1, theta=inp["mlp"]["theta"])
        out["single_nd0"] = run_trainer(tr, inp["xs"][:, :1],
                                        inp["ys"][:, :1])

    # 2 chains over 2 ranks (cSGHMC, noise on), per step and fused, and
    # the same 2 chains in one process
    for where, mesh in (("ranks", mesh_chain), ("single", None)):
        if mesh is None and rank != 0:
            continue
        r = mlp_runner("csghmc", inp["csghmc"], inp["mlp"],
                       lr=inp["csghmc_lr"])
        tr = trainer_from(r, 2, mesh=mesh)
        out[f"chains_{where}"] = run_trainer(
            tr, inp["xs"], inp["ys"], inp["fused_xs"], inp["fused_ys"])

    # fsdp against replicated data parallel at nd > 0
    for method in ("sgld", "csghmc", "vi"):
        for fsdp in (False, True):
            r = mlp_runner(method, inp[method], inp["mlp"],
                           lr=inp["csghmc_lr"] if method == "csghmc" else 1e-2,
                           momentum=0.5 if method != "csghmc" else 0.0)
            tr = trainer_from(r, 1, mesh=mesh_data, fsdp=fsdp)
            out[f"{method}_fsdp{int(fsdp)}"] = run_trainer(
                tr, inp["xs"][:, :1], inp["ys"][:, :1],
                inp["fused_xs"][:, :1], inp["fused_ys"][:, :1])

    # the JAX trainer's stacked states handed to each rank (interop):
    # 2 cSGHMC chains over the ranks, and 1 SGLD chain's fsdp shards, nd 0
    from bayesdll_tpu_torch import interop
    for name, method, n_chain, mesh, fsdp in (
            ("jax_chains", "csghmc", 2, mesh_chain, False),
            ("jax_fsdp", "sgld", 1, mesh_data, True)):
        j = inp[name]
        r = mlp_runner(method, j["hp"], inp["mlp"], lr=j["lr"])
        tr = trainer_from(r, n_chain, mesh=mesh, fsdp=fsdp)
        tr.states, tr.net_states = interop.rank_chain_states(
            tr, j["states"], {}, device="cpu")
        out[name] = run_trainer(tr, inp["xs"][:, :n_chain],
                                inp["ys"][:, :n_chain])

    # the mini ResNet with BatchNorm on 2 data ranks, cSGHMC at nd = 0
    out["resnet"] = resnet_dp(mesh_data, inp["resnet"])
    return out


def resnet_dp(mesh, res):
    from bayesdll_tpu_torch import interop
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models.resnet import ResNet
    from bayesdll_tpu_torch.parallel import MultiChainTrainer
    from bayesdll_tpu_torch.parallel.chains import clone_tree
    target, theta, ns = interop.target_from_arrays(
        res["theta"], res["theta0"], res["is_head"], res["is_bias"],
        model=ResNet(res["stages"], res["k"], dtype="float32"), nd_size=64,
        num_classes=res["k"], batch_stats=res["stats"], device="cpu")
    cfg = Config(method="csghmc", hparams=dict(res["hp"]),
                 dataset="synthetic", backbone="resnet_mini", epochs=1,
                 batch_size=res["batch"], lr=1e-3, num_cycles=1, seed=0,
                 device="cpu")
    r = get_runner_cls("csghmc")(target, theta, ns, cfg)
    r._ensure_sched(3)
    tr = MultiChainTrainer(r, 1, mesh=mesh)
    tr.states = [r.init_state(theta.clone())]
    tr.net_states = [clone_tree(ns)]
    losses = [float(tr.step(x[None], y[None], 0)[0][0])
              for x, y in zip(res["xs"], res["ys"])]
    return {"theta": host(tr.states[0].theta), "v": host(tr.states[0].v),
            "stats": host(tr.net_states[0]["batch_stats"]), "losses": losses}


# ---- test_torch_tp.py ----------------------------------------------------------

def vit_runner(arrays, tp=None, **vit_kw):
    """The port's csghmc runner of the tiny ViT from the JAX package's flat
    arrays, with tensor parallelism `tp` when given and the ViT's other
    options (remat, remat_policy) in vit_kw."""
    from bayesdll_tpu_torch import interop
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models.vit import ViT
    model = ViT(patch=16, dim=32, depth=2, heads=4, mlp_dim=64,
                image_size=32, num_classes=5, tp=tp, **vit_kw)
    target, theta, ns = interop.target_from_arrays(
        arrays["theta"], arrays["theta0"], arrays["is_head"],
        arrays["is_bias"], model=model, nd_size=64, num_classes=5,
        device="cpu")
    cfg = Config(method="csghmc", hparams=dict(arrays["hp"]),
                 dataset="synthetic", backbone="vit_b_16", epochs=2,
                 batch_size=8, lr=1e-2, seed=0, num_cycles=1, device="cpu")
    runner = get_runner_cls("csghmc")(target, theta, ns, cfg)
    runner._ensure_sched(4)
    return runner


def vit_steps(runner, x, y, sample: bool, n: int = 3):
    """n steps of `_step` at fixed scalars (the JAX test's), noise on or
    off; returns (loss of the last, θ)."""
    sc = {"lr": 0.01, "should_sample": sample, "collect": True}
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    for i in range(n):
        runner.state, runner.net_state, (loss, _) = runner._step(
            runner.state, runner.net_state, x, y, i, sc)
    return float(loss), runner.state


def all_reduces(fn):
    """(fn(), the all-reduces that ran in it): the collectives the process
    group ran, read from a CPU profile (a recompute that reads a saved sum
    runs none)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name in ("gloo:all_reduce", "nccl:all_reduce")
                    for e in prof.events())


REMAT_POLICIES = ("", "dots", "names")


def tp_world(rank, world, arrays, x, y, n_data):
    """The tiny ViT's 3 cSGHMC steps at (n_data data x world / n_data model),
    noise off and on, and with each remat policy noise off; whole θ,
    losses, the all-reduces of the steps, and the shapes that show each
    rank's share of the wide hidden and of the flat state.  At (1, 2) also
    the CLI with --remat --tensor_parallel 2: the checkpointed blocks."""
    from bayesdll_tpu_torch.parallel import (make_tp_constraints,
                                             make_tp_mesh,
                                             shard_runner_for_tp)
    mesh = make_tp_mesh(n_data, world // n_data)
    out = {}
    runs = [(s, None) for s in (False, True)] + \
        [(False, p) for p in REMAT_POLICIES]
    for sample, policy in runs:
        tp = make_tp_constraints(mesh)
        kw = {} if policy is None else dict(remat=True, remat_policy=policy)
        runner = shard_runner_for_tp(vit_runner(arrays, tp, **kw), mesh)
        (loss, state), n_reduce = all_reduces(
            lambda: vit_steps(runner, x, y, sample))
        out[sample if policy is None else f"remat {policy}"] = {
            "loss": loss, "theta": host(runner.shard.gather(state.theta)),
            "v": host(runner.shard.gather(state.v)),
            "local": int(state.theta.shape[0]), "all_reduces": n_reduce}
    if n_data == 1:
        out["cli"] = tp_remat_cli(rank)
    # the wide hidden of an eval forward: qkv's width on this rank
    model = runner.target.module
    seen = {}
    orig = model._attend

    def watch(qkv, d=None, h=None):
        seen["qkv"] = tuple(qkv.shape)
        return orig(qkv, d, h)
    model._attend = watch
    runner.evaluate([(torch.as_tensor(x), torch.as_tensor(y),
                      torch.ones(len(y)))])
    out["qkv_width"] = seen["qkv"][-1]
    out["model_size"] = tp.size
    return out


def tp_remat_cli(rank):
    """The CLI with --remat --remat_policy names --tensor_parallel 2 on the
    tiny ViT for one epoch: (whether the model is tensor-parallel with that
    remat, the checkpointed blocks of the run, its train losses)."""
    import tempfile
    import bayesdll_tpu_torch.data as data
    from bayesdll_tpu_torch.cli import demo
    from bayesdll_tpu_torch.models import vit
    calls = []
    checkpoint = vit.ckpt.checkpoint

    def counted(fn, *a, **k):
        calls.append(fn.__name__)
        return checkpoint(fn, *a, **k)
    built = {}
    build_all = demo.build_all

    def keep(*a, **k):
        runner, loaders = build_all(*a, **k)
        built["model"] = runner.target.module
        return runner, loaders
    prepare = data.prepare

    def cut(cfg):  # 64 training and 32 test examples
        cfg.synthetic_n_train, cfg.synthetic_n_test = 64, 32
        return prepare(cfg)
    vit.ckpt.checkpoint, demo.build_all, data.prepare = counted, keep, cut
    try:
        with tempfile.TemporaryDirectory() as d:
            res = demo.main([
                "--method", "csghmc", "--backbone", "vit_tiny",
                "--num_classes", "5", "--dataset", "synthetic",
                "--batch_size", "16", "--epochs", "1", "--num_cycles", "1",
                "--lr", "1e-3", "--device", "cpu", "--remat",
                "--remat_policy", "names", "--tensor_parallel", "2",
                "--log_dir", d, "--hparams",
                "prior_sig=1.0,nd=0.0,thin=2,nst=1"])
    finally:
        vit.ckpt.checkpoint, demo.build_all = checkpoint, build_all
        data.prepare = prepare
    m = built["model"]
    return {"tp_remat": (m.tp is not None and m.remat, m.remat_policy),
            "checkpointed": sorted(set(calls)), "n_checkpointed": len(calls),
            "train_losses": res["train_losses"]}


# ---- test_torch_reshard.py -------------------------------------------------------

def reshard_chains(hparams, workdir, *, epochs=1, mesh=None, fsdp=False,
                   fused=False, pad_to=1024, arrays=None, start=None):
    """2 cSGHMC chains on the width-16 MLP (192 synthetic training examples,
    batch 16, cycles of one epoch) on the CPU, checkpointing to the
    directory backend: (the MultiChainRunner, its loaders).  With `arrays`
    (the JAX package's flat theta, theta0, is_head, is_bias) the target is
    the JAX package's, and with `start` (the JAX trainer's stacked states)
    the chains start from its states; else the port's own, from seed 0,
    padded to `pad_to`."""
    from bayesdll_tpu_torch import interop
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.data import prepare
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models import create_backbone
    from bayesdll_tpu_torch.parallel import MultiChainRunner
    cfg = Config(method="csghmc", hparams=dict(hparams), dataset="synthetic",
                 backbone="mlp_mnist", epochs=epochs, batch_size=16, lr=1e-3,
                 num_cycles=epochs, seed=0, val_heldout=0.15,
                 ckpt_backend="orbax", fused_steps=fused, device="cpu")
    cfg.synthetic_n_train, cfg.synthetic_n_test = 192, 256
    *loaders, nd = prepare(cfg)
    model, _, _ = create_backbone("mlp_mnist", width=16, depth=2)
    if arrays is None:
        target, theta, ns = make_flat_target(
            model, nd_size=nd, num_classes=10, pad_to=pad_to,
            rng=torch.Generator().manual_seed(0), device="cpu")
    else:
        target, theta, ns = interop.target_from_arrays(
            arrays["theta"], arrays["theta0"], arrays["is_head"],
            arrays["is_bias"], model=model, nd_size=nd, num_classes=10,
            device="cpu")
    runner = get_runner_cls("csghmc")(target, theta, ns, cfg)
    mc = MultiChainRunner(runner, 2, workdir=workdir, fsdp=fsdp, mesh=mesh)
    if start is not None:
        tr = mc.trainer
        tr.states, tr.net_states = interop.rank_chain_states(
            tr, start, {}, device="cpu")
    return mc, loaders


def chains_host(mc):
    """Every chain's whole state, as numpy."""
    return [host(s) for s in mc.trainer.all_chains()[0]]


def interrupted(hparams, workdir, **kw):
    """The first epoch of a 2-epoch run (reshard_chains at 1 epoch, its
    cycle ended), saved as the DCP directory (by `train`) and as the
    pickle: (the chains' whole states, the directory, the pickle)."""
    mc, loaders = reshard_chains(hparams, workdir, **kw)
    mc.train(loaders[0], None, None)
    directory = os.path.join(workdir, "chains_ckpt_orbax")
    mc.cfg.ckpt_backend = "pickle"
    pkl = mc.save_ckpt(0)
    return chains_host(mc), directory, pkl


def resumed(hparams, path, workdir, **kw):
    """A fresh 2-epoch runner (reshard_chains) loaded from `path` and
    trained on: (the chains' whole states just after the load, after the
    second epoch, its train losses)."""
    mc, loaders = reshard_chains(hparams, workdir, epochs=2, **kw)
    start = mc.load_ckpt(path) + 1
    loaded = chains_host(mc)
    res = mc.train(loaders[0], None, None, start_epoch=start)
    return {"loaded": loaded, "end": chains_host(mc),
            "losses": res["train_losses"], "layout":
            (len(mc.trainer.chains), int(mc.trainer.states[0].theta.shape[0]))}


def reshard_world(rank, world, inp, root):
    """The 2-rank side of test_torch_reshard.py: 2 chains with
    --data_parallel 2 --fsdp (noise on; and at nd = 0 from the JAX
    trainer's states) and 2 chains over the 2 ranks, each saved after an
    epoch; and the world-1 run's checkpoints resumed under fsdp."""
    from bayesdll_tpu_torch.parallel import make_mesh
    fsdp = dict(mesh=make_mesh(1, 2), fsdp=True)
    out = {"fsdp": interrupted(inp["hp"], f"{root}/fsdp", **fsdp),
           "chains": interrupted(inp["hp"], f"{root}/chains",
                                 mesh=make_mesh(2, 1)),
           "jax": interrupted(inp["hp0"], f"{root}/jax", arrays=inp["arrays"],
                              start=inp["start"], **fsdp)}
    _, directory, pkl = inp["world1"]
    for name, path in (("from world1 dcp", directory),
                       ("from world1 pkl", pkl)):
        out[name] = resumed(inp["hp"], path, f"{root}/{name}", **fsdp)
    return out


# ---- test_torch_tp_methods.py --------------------------------------------------

def tiny_vit_loaders(seed: int = 0):
    """The tiny ViT's sets from a seed: 32 training, 16 validation and 16
    test images of 32x32x3 in 5 classes, batches of 8, unshuffled (a
    resumed run then sees the uninterrupted run's batches)."""
    from bayesdll_tpu_torch.data.loader import ArrayLoader
    rng = np.random.RandomState(seed)

    def part(n):
        return ArrayLoader(rng.randn(n, 32, 32, 3).astype(np.float32),
                           rng.randint(0, 5, n).astype(np.int32), 8)
    return part(32), part(16), part(16)


def tiny_vit_method(method, hparams, *, mesh=None, epochs=1, num_cycles=1,
                    fused=False, full_sample=False, workdir=None):
    """A port runner of `method` on the tiny ViT (dim 32, depth 2, 4 heads,
    mlp 64, patch 16) from seed 0 on the CPU, with the CLI's re-init
    function; sharded over the tensor-parallel `mesh` when one is given."""
    from bayesdll_tpu_torch.cli.demo import make_reinit_fn
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models.vit import ViT
    from bayesdll_tpu_torch.parallel import (make_tp_constraints,
                                             shard_runner_for_tp)
    tp = None if mesh is None else make_tp_constraints(mesh)
    model = ViT(patch=16, dim=32, depth=2, heads=4, mlp_dim=64,
                image_size=32, num_classes=5, tp=tp)
    target, theta, ns = make_flat_target(
        model, nd_size=32, num_classes=5,
        rng=torch.Generator().manual_seed(0), device="cpu")
    cfg = Config(method=method, hparams=dict(hparams), dataset="synthetic",
                 backbone="vit_tiny", epochs=epochs, batch_size=8, lr=2e-2,
                 num_cycles=num_cycles, seed=0, fused_steps=fused,
                 full_sample=full_sample, device="cpu")
    runner = get_runner_cls(method)(target, theta, ns, cfg, workdir=workdir)
    if hasattr(runner, "set_reinit_fn"):
        runner.set_reinit_fn(make_reinit_fn(model, target, 0))
    return runner if mesh is None else shard_runner_for_tp(runner, mesh)


def whole_state(runner):
    """The runner's whole state (gathered on a tensor-parallel rank)."""
    return runner.state if runner.shard is None else \
        runner.shard.full_state(runner.state)


def method_run(method, hparams, mesh=None, **kw):
    """`method` trained on the tiny ViT: its train losses, NLL, whole
    iterate, and Laplace's variances."""
    runner = tiny_vit_method(method, hparams, mesh=mesh, **kw)
    res = runner.train(*tiny_vit_loaders())
    out = {"losses": list(res["train_losses"]), "nll": res.get("nll"),
           "iterate": host(runner.iterate(whole_state(runner)))}
    if method == "la":
        out["vars"] = host(runner.post_vars)
    if getattr(runner, "all_samples", None):  # --full_sample's archive
        out["samples"] = dict(runner.all_samples)
    if runner.shard is not None:
        out["local"] = int(runner.iterate(runner.state).shape[0])
    return out


def tp_resume_run(hparams, mesh, workdir, rank):
    """cSGHMC on the tiny ViT at 2 epochs of one cycle each under tensor
    parallelism: uninterrupted, and stopped after the first epoch, saved
    (rank 0 writes the checkpoint), loaded into a fresh runner and
    resumed; each run's whole state and its second epoch's loss."""
    import torch.distributed as dist
    kw = dict(mesh=mesh, epochs=2, num_cycles=2)
    full = tiny_vit_method("csghmc", hparams, **kw)
    res = full.train(*tiny_vit_loaders())
    train = tiny_vit_loaders()[0]
    part = tiny_vit_method("csghmc", hparams,
                           workdir=workdir if rank == 0 else None, **kw)
    part._ensure_sched(len(train))
    part._train_loader = train
    part.epoch_begin(0)
    part.train_one_epoch(0, train)
    part.save_ckpt(0)
    dist.barrier()
    resumed = tiny_vit_method("csghmc", hparams, **kw)
    start = resumed.load_ckpt(os.path.join(workdir, "ckpt.pkl")) + 1
    res2 = resumed.train(*tiny_vit_loaders(), start_epoch=start)
    return {"full": host(whole_state(full)), "resumed":
            host(whole_state(resumed)), "start": start,
            "loss": (res["train_losses"][1], res2["train_losses"][1])}


def tp_methods_world(rank, world, cases, workdir):
    """Each (name, method, hparams, options) of `cases` trained on the tiny
    ViT at (1 data x 2 model ranks), and the resume of tp_resume_run."""
    from bayesdll_tpu_torch.parallel import make_tp_mesh
    mesh = make_tp_mesh(1, world)
    out = {name: method_run(method, hp, mesh, **kw)
           for name, method, hp, kw in cases}
    out["resume"] = tp_resume_run(dict(cases[0][2]), mesh, workdir, rank)
    return out


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
