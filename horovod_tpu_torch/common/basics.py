"""Lifecycle: ``init``/``shutdown`` and the rank queries.

``init()`` forms the ``torch.distributed`` world that every collective of
the port runs over: NCCL when the job runs on the card, gloo when the
caller asks for the CPU. The device defaults to ``cuda``; asking for it on
a machine without one raises instead of falling back.

The rendezvous address is, in order: torchrun's ``MASTER_ADDR`` and
``MASTER_PORT``; the launcher's ``HOROVOD_COORD_ADDR``; and, for a world of
one, ``127.0.0.1`` on a free port.
"""

from __future__ import annotations

import os
import socket
import threading
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from .config import Config
from .topology import Topology, detect


class NotInitializedError(RuntimeError):
    def __init__(self) -> None:
        super().__init__("Horovod has not been initialized; use hvd.init().")


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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rendezvous(topo: Topology) -> str:
    env = os.environ
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        return f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if env.get("HOROVOD_COORD_ADDR"):
        return f"tcp://{env['HOROVOD_COORD_ADDR']}"
    if topo.size == 1:
        return f"tcp://127.0.0.1:{_free_port()}"
    raise RuntimeError(
        f"rank {topo.rank} of a world of {topo.size} has no rendezvous "
        "address: launch with torchrun (MASTER_ADDR/MASTER_PORT) or the "
        "horovod launcher (HOROVOD_COORD_ADDR)")


# How long a rank waits for the others at rendezvous and in a collective.
_TIMEOUT = timedelta(minutes=10)


def init(device=None) -> None:
    """Join the job. ``device`` is ``"cuda"`` (default) or ``"cpu"``; the
    backend follows it (NCCL or gloo). Idempotent until ``shutdown()``."""
    with _state.lock:
        if _state.topology is not None:
            return
        device = resolve_device(device)
        topo = detect()
        if device.type == "cuda":
            if topo.local_rank >= torch.cuda.device_count():
                raise RuntimeError(
                    f"local rank {topo.local_rank} has no GPU: "
                    f"{torch.cuda.device_count()} visible")
            torch.cuda.set_device(topo.local_rank)
            device = torch.device("cuda", topo.local_rank)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=_rendezvous(topo), rank=topo.rank,
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
