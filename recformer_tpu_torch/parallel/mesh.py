"""Process groups for data and tensor parallelism.

Counterpart of ``recformer_tpu/parallel/mesh.py``. JAX lays its devices out
as a ``('data', 'model')`` mesh in one process; here every rank is its own
process, started by ``python -m torch.distributed.run`` (torchrun), and the
mesh is a pair of process groups per rank:

- rank ``r`` sits at ``(data_rank, model_rank) = divmod(r, n_model)``, the
  row-major order of JAX's ``reshape(n_data, n_model)``;
- ``model_group`` holds the ``n_model`` ranks of one data rank (tensor
  parallelism, the row-sharded catalog), ``data_group`` the ``n_data`` ranks
  of one model rank (batch sharding, gradient reduction, ZeRO).

:func:`init_distributed` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and gives each rank
its device: ``cuda:(LOCAL_RANK % device_count)``, or the CPU when asked.
The backend is ``nccl`` when every rank of the host has a card of its own,
and ``gloo`` when ranks share a card (NCCL refuses two ranks on one device)
or run on the CPU; gloo then stages CUDA tensors through host memory. The
choice is printed and kept on the mesh. An ``nccl`` failure raises: nothing
retries on ``gloo``. Every group has a timeout, so a rank that dies ends
its peers' collectives with an error instead of a hang.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

# optimizer-state placement (``shard_optimizer_state`` in the JAX package): a
# leaf is sharded over 'data' when its leading dim divides by the data size
# and it holds at least this many elements
ZERO_MIN_ELEMENTS = 1024

DEFAULT_TIMEOUT_S = 600


def world_size() -> int:
    """torchrun's ``WORLD_SIZE``; 1 when the process was not started by it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def choose_backend(device: torch.device, local_world_size: int, device_count: int) -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``."""
    if device.type == "cuda" and local_world_size <= device_count:
        return "nccl"
    return "gloo"


@dataclass
class Mesh:
    """One rank's view of the ``data`` x ``model`` layout."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    backend: str
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    host_group: Optional[dist.ProcessGroup] = None  # gloo over the world, for CPU tensors
    owns_world: bool = False  # whether making it set up the default process group

    @property
    def world_size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    def describe(self) -> dict:
        return dict(backend=self.backend, world=self.world_size, data=self.n_data,
                    model=self.n_model, rank=self.rank, device=str(self.device))


def init_distributed(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group torchrun describes (once per process) and
    return this rank's device."""
    dev = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size())))
        count = torch.cuda.device_count() if dev.type == "cuda" else 0
        backend = choose_backend(dev, local_world, count)
        dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(n_model: int = 1, device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The mesh of the current torchrun world: ``n_model`` ranks per model
    group, the rest on ``data``. Every rank must call it (groups are made
    collectively, in the same order)."""
    owns_world = not dist.is_initialized()
    dev = init_distributed(device, timeout_s)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"world size {world} not divisible by model size {n_model}")
    n_data = world // n_model
    timeout = datetime.timedelta(seconds=timeout_s)
    data_group = model_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)], timeout=timeout)
        if rank // n_model == d:
            model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)], timeout=timeout)
        if rank % n_model == m:
            data_group = g
    # host-side flags (the preemption signal) are reduced as CPU tensors over
    # gloo, which never waits on the card's stream
    host_group = dist.new_group(backend="gloo", timeout=timeout)
    mesh = Mesh(n_data, n_model, rank, dev, dist.get_backend(), data_group, model_group,
                host_group, owns_world)
    if rank == 0:
        print(f"[mesh] {mesh.describe()}", flush=True)
    return mesh


def destroy(mesh: Optional[Mesh] = None) -> None:
    """Tear down the default process group, unless ``mesh`` joined one that
    its caller had set up (an entry point run inside a caller's world
    leaves the world to the caller)."""
    if dist.is_initialized() and (mesh is None or mesh.owns_world):
        dist.destroy_process_group()


def zero_shardable(tensor: torch.Tensor, n: int) -> bool:
    """The JAX package's ZeRO rule: leading dim divisible by the data size,
    at least ``ZERO_MIN_ELEMENTS`` elements."""
    return tensor.dim() >= 1 and tensor.shape[0] % n == 0 and tensor.numel() >= ZERO_MIN_ELEMENTS


def pad_rows_to_multiple(x: np.ndarray, multiple: int, fill=0):
    """Pad dim-0 so it divides evenly across a mesh axis; returns (padded,
    original_len)."""
    n = x.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    pad_width = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad_width, constant_values=fill), n
