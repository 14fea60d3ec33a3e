"""Process groups and the ('chain', 'data') device mesh (counterpart of
bayesdll_tpu.parallel.mesh).

The JAX package runs one program over every device of a mesh; the port runs
one process per rank, each on its own card (or, for a check on one card,
two gloo ranks sharing it), joined in a torch.distributed process group.
The mesh names the ranks' layout:

  * 'chain': independent chains, each rank holding n_chain / axis of them;
  * 'data':  a chain's batch split over ranks, its gradient averaged over
    them (parallel/chains.py; with fsdp the chain's flat vectors sharded
    over them too).

A rank's place in the mesh is rank = chain_index * data_parallel +
data_index, the row-major order of the JAX package's reshape of its device
list.  Nothing here reads the environment for a cluster: the caller names
the coordinator's address, the world size and its rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, backend: Optional[str] = None,
                     timeout_s: float = 600.0, device: str = "cuda") -> str:
    """Join the process group of `num_processes` ranks as rank `process_id`,
    through the TCP store at `coordinator_address` ("host:port", rank 0
    listens there).  The backend is NCCL when the run's `device` is "cuda"
    and gloo when it is "cpu"; `backend="gloo"` with CUDA tensors is the
    form for several ranks on one card, which NCCL refuses.  On CUDA the
    rank's card is its local rank (LOCAL_RANK, else `process_id`) modulo
    the cards the host has.  No fall-back: a missing card or a refused
    backend raises.  Returns the backend."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device: 'cuda' or 'cpu', got {device!r}")
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if backend == "nccl" and device != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device='cuda' but no CUDA "
                               "device is available")
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def world_size() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(num_chains: int, data_parallel: int = 1) -> DeviceMesh:
    """The ('chain', 'data') mesh over the first num_chains * data_parallel
    ranks of the process group; a rank outside it has no coordinate
    (`mesh.get_coordinate()` is None).  Every rank of the group calls it."""
    need = num_chains * data_parallel
    have = world_size()
    if have < need:
        raise ValueError(
            f"need {need} devices for mesh ({num_chains} chains x "
            f"{data_parallel} data shards), have {have}")
    return DeviceMesh(_device_type(),
                      torch.arange(need).view(num_chains, data_parallel),
                      mesh_dim_names=("chain", "data"))
