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

def vit_runner(arrays, tp=None):
    """The port's csghmc runner of the tiny ViT from the JAX package's flat
    arrays, with tensor parallelism `tp` when given."""
    from bayesdll_tpu_torch import interop
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models.vit import ViT
    model = ViT(patch=16, dim=32, depth=2, heads=4, mlp_dim=64,
                image_size=32, num_classes=5, tp=tp)
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


def tp_world(rank, world, arrays, x, y, n_data):
    """The tiny ViT's 3 cSGHMC steps at (n_data data x world / n_data model),
    noise off and on; whole θ, losses, and the shapes that show each rank's
    share of the wide hidden and of the flat state."""
    from bayesdll_tpu_torch.parallel import (make_tp_constraints,
                                             make_tp_mesh,
                                             shard_runner_for_tp)
    mesh = make_tp_mesh(n_data, world // n_data)
    out = {}
    for sample in (False, True):
        tp = make_tp_constraints(mesh)
        runner = shard_runner_for_tp(vit_runner(arrays, tp), mesh)
        loss, state = vit_steps(runner, x, y, sample)
        out[sample] = {"loss": loss,
                       "theta": host(runner.shard.gather(state.theta)),
                       "v": host(runner.shard.gather(state.v)),
                       "local": int(state.theta.shape[0])}
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


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
