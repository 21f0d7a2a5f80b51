"""Process-group setup (port of `paddle_tpu/distributed/env.py`:
`init_parallel_env` :116, `get_rank` :150, `get_world_size` :156,
`ParallelEnv`).

The reference joins JAX's coordination service; the port joins a
`torch.distributed` process group. The launcher contract is the
reference's: `PADDLE_MASTER` (host:port of rank 0's store),
`PADDLE_TRAINERS_NUM` (the world size) and `PADDLE_TRAINER_ID` (this
rank), as `extras.spawn` sets them.

Backend and device, visible as `ParallelEnv().backend` / `.device`:
  * a rank on the CPU uses gloo;
  * on the card, NCCL when there is a card per rank (rank r on cuda:r);
    with fewer cards than ranks every rank runs on cuda:0 and the group
    is gloo (gloo reduces CUDA tensors; NCCL cannot put two ranks on one
    card). Either way the compute stays on the card.
The group has a finite timeout, so a rank that dies or issues a
different collective fails its peers' next collective instead of
hanging them.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "current_device", "ParallelEnv",
           "DEFAULT_TIMEOUT_S"]

# seconds a collective waits for its peers before the group fails it
DEFAULT_TIMEOUT_S = 300.0

_device: list = [None]


def _rank_device(device, rank: int, world: int) -> torch.device:
    """This rank's device: the CPU as asked, else cuda:rank when the
    host has a card per rank, else cuda:0."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return resolve_device(device)
    resolve_device("cuda")             # raises without a card
    count = torch.cuda.device_count()
    return torch.device("cuda", rank if count >= world else 0)


def init_parallel_env(strategy=None, *, device=None,
                      timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the process group the environment describes and pick this
    rank's device (`device="cpu"` for a CPU rank; the card otherwise).
    Without `PADDLE_MASTER` or with a world of one, no group is formed
    and the rank runs alone. Idempotent. Returns a `ParallelEnv`."""
    if _device[0] is not None:
        return ParallelEnv()
    master = os.environ.get("PADDLE_MASTER")
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    dev = _rank_device(device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if master and world > 1:
        backend = ("nccl" if dev.type == "cuda"
                   and torch.cuda.device_count() >= world else "gloo")
        dist.init_process_group(
            backend, init_method=f"tcp://{master}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=float(timeout_s)))
    _device[0] = dev
    return ParallelEnv()


def is_initialized() -> bool:
    return _device[0] is not None


def current_device() -> Optional[torch.device]:
    """The device `init_parallel_env` chose for this rank (None before
    it ran)."""
    return _device[0]


def get_rank(group=None) -> int:
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def get_world_size(group=None) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


class ParallelEnv:
    """Parity: paddle.distributed.ParallelEnv, plus the group's backend
    and the rank's device."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def device(self) -> Optional[torch.device]:
        return current_device()

    @property
    def device_id(self) -> int:
        dev = current_device()
        return (dev.index or 0) if dev is not None else 0

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if dist.is_initialized() else None
