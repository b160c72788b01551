"""This process's place in the job: rank, size, local and cross coordinates.

Resolution order:
1. the ``HOROVOD_*`` identity envelope that the launcher exports
   (``HOROVOD_RANK``/``HOROVOD_SIZE``/``HOROVOD_LOCAL_RANK``/...);
2. torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE``;
3. a world of one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Topology:
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int   # which host this rank is on
    cross_size: int   # number of hosts

    def validate(self) -> None:
        if not (0 <= self.rank < self.size):
            raise ValueError(f"rank {self.rank} out of range for size {self.size}")
        if not (0 <= self.local_rank < self.local_size):
            raise ValueError(
                f"local_rank {self.local_rank} out of range for local_size "
                f"{self.local_size}")
        if self.size % self.local_size != 0:
            raise ValueError(
                "homogeneous topology requires size to be a multiple of "
                f"local_size (got size={self.size}, local_size={self.local_size})")


def _topology(rank, size, local_rank, local_size, cross_rank=None,
              cross_size=None) -> Topology:
    local_size = max(local_size, 1)
    if cross_rank is None:
        cross_rank = rank // local_size
    if cross_size is None:
        cross_size = max(size // local_size, 1)
    return Topology(rank, size, local_rank, local_size, cross_rank, cross_size)


def _from_horovod_env() -> Topology | None:
    env = os.environ
    if "HOROVOD_RANK" not in env or "HOROVOD_SIZE" not in env:
        return None
    cross_rank = env.get("HOROVOD_CROSS_RANK")
    cross_size = env.get("HOROVOD_CROSS_SIZE")
    return _topology(
        int(env["HOROVOD_RANK"]), int(env["HOROVOD_SIZE"]),
        int(env.get("HOROVOD_LOCAL_RANK", 0)),
        int(env.get("HOROVOD_LOCAL_SIZE", 1)),
        None if cross_rank is None else int(cross_rank),
        None if cross_size is None else int(cross_size))


def _from_torchrun_env() -> Topology | None:
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    size = int(env["WORLD_SIZE"])
    return _topology(int(env["RANK"]), size, int(env.get("LOCAL_RANK", 0)),
                     int(env.get("LOCAL_WORLD_SIZE", size)))


def detect() -> Topology:
    topo = _from_horovod_env() or _from_torchrun_env() or Topology(0, 1, 0, 1, 0, 1)
    topo.validate()
    return topo
