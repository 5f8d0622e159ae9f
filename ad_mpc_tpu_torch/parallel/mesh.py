"""Rank layouts and process groups: the port's scaling axis (the
counterpart of ``ad_mpc_tpu/parallel/mesh.py``).

The JAX package splits the scenario batch over a device mesh inside one
program. The port splits it over processes: each rank owns a contiguous
block of the global batch, steps it on its own device, and only
diagnostics reductions cross ranks (``torch.distributed``). A layout is 1-D
(ranks) or 2-D (hosts x GPUs per host, the host axis outermost), and the
blocks are ordered host-major, as ``batch_sharding`` orders the batch over
a 2-D mesh.

The caller names the backend: ``nccl`` where each rank has a GPU of its
own, ``gloo`` on the CPU and where several ranks share one card. A
``nccl`` group with more ranks than GPUs is refused, never switched.
"""

from __future__ import annotations

import socket
from typing import NamedTuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


class RankLayout(NamedTuple):
    """``n_hosts`` x ``per_host`` ranks; rank r is (r // per_host,
    r % per_host) in (host, local) coordinates."""

    n_hosts: int
    per_host: int

    @property
    def world(self) -> int:
        return self.n_hosts * self.per_host

    def coords(self, rank: int) -> tuple:
        return divmod(rank, self.per_host)


def make_layout(world: int) -> RankLayout:
    """1-D layout of ``world`` ranks on one host."""
    return RankLayout(1, world)


def make_layout_2d(n_hosts: int, per_host: int) -> RankLayout:
    """2-D (host x GPU) layout, the host axis outermost."""
    return RankLayout(n_hosts, per_host)


def shard_slice(batch: int, rank: int, layout: RankLayout) -> slice:
    """The rows of a global batch that ``rank`` owns: equal contiguous
    blocks, host-major (rank = host * per_host + local)."""
    world = layout.world
    if batch % world:
        raise ValueError(f"batch {batch} does not split over {world} ranks")
    n = batch // world
    return slice(rank * n, (rank + 1) * n)


def free_port() -> int:
    """A free TCP port of localhost, for a group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(backend: str, device: str, local_rank: int) -> torch.device:
    """The device a rank steps its shard on: the CPU, or GPU
    ``local_rank`` under ``nccl``, or GPU ``local_rank`` modulo the GPUs
    under ``gloo`` (ranks share a card)."""
    if device == "cpu":
        return torch.device("cpu")
    n_gpus = torch.cuda.device_count()
    if n_gpus == 0:
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' for the plain path")
    if backend == "nccl" and local_rank >= n_gpus:
        raise RuntimeError(f"backend 'nccl' needs a GPU per rank: local rank "
                           f"{local_rank} of a host with {n_gpus} GPU(s); "
                           "name 'gloo' for ranks that share a card")
    return torch.device("cuda", local_rank % n_gpus)


GROUP_TIMEOUT_S = 300.0  # a rank that does not join by then fails the group


def init_group(backend: str, world: int, rank: int, port: int,
               host: str = "127.0.0.1") -> None:
    """Join the default process group at ``tcp://host:port``. ``nccl``
    with more ranks than this host's GPUs raises."""
    import datetime

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise RuntimeError(f"backend 'nccl' needs a GPU per rank: {world} ranks, "
                           f"{torch.cuda.device_count()} GPU(s); name 'gloo' for "
                           "ranks that share a card")
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))

