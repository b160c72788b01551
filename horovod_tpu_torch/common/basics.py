"""Lifecycle: ``init``/``shutdown`` and the rank queries.

``init()`` forms the ``torch.distributed`` world that every collective of
the port runs over: NCCL when the job runs on the card, gloo when the
caller asks for the CPU. The device defaults to ``cuda``; asking for it on
a machine without one raises instead of falling back.

The rendezvous address is, in order: torchrun's ``MASTER_ADDR`` and
``MASTER_PORT``; the launcher's ``HOROVOD_COORD_ADDR``; and, for a world of
one, a store of its own on ``127.0.0.1`` that binds a port the kernel picks
(port 0), so no other socket can take the port between its choice and the
bind.

``init(comm=[...])`` forms a sub-world of the launched ranks, as the
reference's ``horovod_init`` with a ranks list does: the members are
re-indexed (rank ``ranks.index(rank)``, size ``len(ranks)``), the member at
``ranks[0]`` becomes rank 0 and hosts the rendezvous, and each member sees
the one-rank-per-host view (local rank 0, local size 1). The GPU is still
chosen by the launched local rank, before the re-indexing: two members on
one host would otherwise both take ``cuda:0``, which NCCL refuses.
"""

from __future__ import annotations

import os
import threading
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.logging import log
from .config import Config
from .topology import Topology, detect


class NotInitializedError(RuntimeError):
    def __init__(self) -> None:
        super().__init__("Horovod has not been initialized; use hvd.init().")


class HorovodInternalError(RuntimeError):
    """A collective contract was broken: ranks disagree, or a peer did not
    take part in time."""


class _State:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.topology: Optional[Topology] = None
        self.config: Optional[Config] = None
        self.device: Optional[torch.device] = None


_state = _State()


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, defaulting to ``cuda``. Raises when
    CUDA is asked for, explicitly or by default, and none is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


# How long a rank waits for the others at rendezvous and in a collective.
_TIMEOUT = timedelta(minutes=10)


def _rendezvous(topo: Topology) -> dict:
    """``init_process_group``'s rendezvous arguments: ``init_method`` for a
    launched world, ``store`` for a world of one."""
    env = os.environ
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        return {"init_method":
                f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"}
    if env.get("HOROVOD_COORD_ADDR"):
        return {"init_method": f"tcp://{env['HOROVOD_COORD_ADDR']}"}
    if topo.size == 1:
        return {"store": dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                                       timeout=_TIMEOUT)}
    raise RuntimeError(
        f"rank {topo.rank} of a world of {topo.size} has no rendezvous "
        "address: launch with torchrun (MASTER_ADDR/MASTER_PORT) or the "
        "horovod launcher (HOROVOD_COORD_ADDR)")


def _subworld(topo: Topology, comm) -> Topology:
    """``topo`` re-indexed to the sub-world of the launched ranks ``comm``,
    with the reference's checks and words (``horovod_tpu.common.basics``
    ``init``). A ``comm`` naming the whole world is plain ``init``."""
    if not isinstance(comm, (list, tuple)):
        raise ValueError(
            "comm must be a list of ranks on TPU (MPI communicators do not exist here)"
        )
    ranks = sorted(set(comm))
    if any(not (0 <= r < topo.size) for r in ranks):
        raise ValueError(
            f"comm {ranks} contains ranks outside the launched world "
            f"of size {topo.size}")
    if topo.rank not in ranks and topo.size > 1:
        raise ValueError(
            f"rank {topo.rank} is not a member of comm {ranks}: this "
            "process cannot participate in the sub-world's "
            "collectives. Only member processes may call "
            "init(comm=...); non-members should skip Horovod work "
            "(or exit) — they must NOT fall back to init(), which "
            "would target the same coordinator address.")
    if topo.size == 1 or len(ranks) == topo.size:
        return topo
    if ranks[0] != 0:
        # The sub-world's rank 0 hosts the rendezvous at the launcher's
        # address, which names the original rank 0's host.
        log("warning",
            f"init(comm={ranks}): member rank {ranks[0]} will "
            "bind the coordinator at HOROVOD_COORD_ADDR. If it "
            "is not on the same host as the original rank 0, "
            "re-export HOROVOD_COORD_ADDR on every member to an "
            "address local to that member before init.")
    me = ranks.index(topo.rank)
    return Topology(rank=me, size=len(ranks), local_rank=0, local_size=1,
                    cross_rank=me, cross_size=len(ranks))


def init(device=None, comm: Optional[Sequence[int]] = None) -> None:
    """Join the job. ``device`` is ``"cuda"`` (default) or ``"cpu"``; the
    backend follows it (NCCL or gloo). ``comm``, a list of launched ranks,
    forms a sub-world of them (see the module docstring); only its members
    may call. Idempotent until ``shutdown()``."""
    with _state.lock:
        if _state.topology is not None:
            return
        device = resolve_device(device)
        launched = detect()
        topo = launched if comm is None else _subworld(launched, comm)
        if device.type == "cuda":
            if launched.local_rank >= torch.cuda.device_count():
                raise RuntimeError(
                    f"local rank {launched.local_rank} has no GPU: "
                    f"{torch.cuda.device_count()} visible")
            torch.cuda.set_device(launched.local_rank)
            device = torch.device("cuda", launched.local_rank)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            **_rendezvous(topo), rank=topo.rank,
            world_size=topo.size, timeout=_TIMEOUT)
        _state.topology = topo
        _state.config = Config.from_env()
        _state.device = device


def shutdown() -> None:
    """Leave the job; ``init()`` may be called again afterwards."""
    with _state.lock:
        if _state.topology is None:
            return
        dist.destroy_process_group()
        _state.topology = None
        _state.config = None
        _state.device = None


def is_initialized() -> bool:
    return _state.topology is not None


def _topo() -> Topology:
    if _state.topology is None:
        raise NotInitializedError()
    return _state.topology


def rank() -> int:
    return _topo().rank


def size() -> int:
    return _topo().size


def local_rank() -> int:
    return _topo().local_rank


def local_size() -> int:
    return _topo().local_size


def cross_rank() -> int:
    return _topo().cross_rank


def cross_size() -> int:
    return _topo().cross_size


def device() -> torch.device:
    """The device this rank's collectives and training run on."""
    _topo()
    return _state.device


def config() -> Config:
    _topo()
    return _state.config


def store() -> dist.Store:
    """The rendezvous store of the world's process group: a key-value store
    every rank reaches over TCP, whose ``wait`` takes a timeout of its own
    (a collective on the device does not)."""
    _topo()
    return dist.distributed_c10d._get_default_store()
