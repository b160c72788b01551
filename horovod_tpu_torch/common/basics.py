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
one host would otherwise both take ``cuda:0``, which NCCL refuses. The
elastic launcher pins each worker to its slot's GPU with
``HOROVOD_DEVICE_ORDINAL``, so a worker keeps its card across resets.

Under ``HOROVOD_ELASTIC=1`` (set by the elastic launcher) the world may be
torn down and formed again in one process (``elastic/run.py``): a
collective waits for a peer at most ``HOROVOD_STALL_SHUTDOWN_TIME`` seconds
(the process group's timeout); on NCCL its wait then raises in the caller
(``TORCH_NCCL_BLOCKING_WAIT``) and the watchdog neither aborts nor kills
the process (``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``, the heartbeat monitor
off), so the reset path can abort the communicators itself
(``shutdown(abort=True)``). The layouts a reset cannot carry refuse to
build there (``require_not_elastic``).

``engine()`` attaches the eager engine on first use, as the JAX package's
does: the native core (``cc/native_engine.py``) by default, the Python
engine (``common/engine.py``) under ``HOROVOD_ENGINE=python``
(``engine.create`` decides); the negotiated host collectives of numpy
values and CPU tensors (``hvd.allreduce(np_array)``, ``mpi_ops``). Its
rank-0 coordinator binds a port the kernel picks and publishes
``host:port`` through this world's store (``StoreRendezvous``), since
``HOROVOD_COORD_ADDR`` is the store's own address; a sub-world's engine
spans the sub-world. ``shutdown`` (``abort=True`` too) shuts it down.

``init`` also starts this rank's telemetry, as the JAX package's does: the
identity gauges; the metrics exposition at ``HOROVOD_METRICS_PORT`` plus
the local rank; under ``HOROVOD_TRACE_DIR`` the span recorder, with its
clock offset to the launcher's driver where a launcher started the
worker; the flight ring (``HOROVOD_FLIGHT_DIR``); and, unless
``HOROVOD_STALL_CHECK_DISABLE``, the stall watchdog over the collectives
in flight (``parallel/telemetry.py``). ``shutdown`` (``abort=True`` too)
stops them and closes the recorder; the next ``init`` opens it again at
the new rank's file.
"""

from __future__ import annotations

import errno
import itertools
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
        # The draws of ``world_sequence``, from 0 in every world.
        self.sequence = itertools.count()
        self.watchdog = None
        self.metrics_server = None
        self.engine = None
        # Engines attached in this world, so that each attach publishes the
        # coordinator under a store key of its own.
        self.engines_made = 0
        # Whether this world built a model cut over a model group of more
        # than one rank (``note_model_cut``).
        self.model_cut = False


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
# How long rank 0 keeps retrying the rendezvous store's bind while its port
# is still held (EADDRINUSE), as the JAX package's coordinator does.
_BIND_RETRY_S = 15.0
# NCCL's settings under HOROVOD_ELASTIC (env defaults, set before the
# process group is made): a wait past the timeout raises in the caller, and
# no watchdog tears the process down.
_ELASTIC_NCCL_ENV = {
    "TORCH_NCCL_BLOCKING_WAIT": "1",
    "TORCH_NCCL_ASYNC_ERROR_HANDLING": "0",
    "TORCH_NCCL_ENABLE_MONITORING": "0",
    "TORCH_NCCL_DUMP_ON_TIMEOUT": "0",
}


def require_not_elastic(what: str) -> None:
    """Raise when ``what`` is built under HOROVOD_ELASTIC=1: an elastic
    reset re-forms only the world and the flat exchange, so a layout with
    groups of its own, or a captured graph, cannot cross one."""
    if os.environ.get("HOROVOD_ELASTIC") == "1":
        raise ValueError(
            f"{what} does not survive an elastic reset: under "
            "HOROVOD_ELASTIC=1 the port supports the flat data-parallel "
            "exchange (with or without HOROVOD_LATENCY_HIDING) on the eager "
            "step only (ROADMAP.md queue A)")


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


def _init_process_group(backend: str, topo: Topology, timeout) -> None:
    """``init_process_group`` at ``_rendezvous``'s address. Rank 0 of a
    launched world binds the store there, and retries while the port is
    still held (a re-rendezvous binds moments after a previous server
    closed); a failure of the backend raises ``HorovodInternalError``."""
    from ..parallel.collectives import backend_errors
    from .resilience import bind_with_retry

    rendezvous = _rendezvous(topo)

    def bind(_port):
        try:
            dist.init_process_group(backend, **rendezvous, rank=topo.rank,
                                    world_size=topo.size, timeout=timeout)
        except dist.DistNetworkError as e:
            if "EADDRINUSE" in str(e):
                raise OSError(errno.EADDRINUSE, str(e)) from e
            raise

    with backend_errors("init"):
        if topo.rank == 0 and "init_method" in rendezvous:
            bind_with_retry(bind, 0, deadline_s=_BIND_RETRY_S)
        else:
            bind(0)


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
        config = Config.from_env()
        timeout = _TIMEOUT
        if config.elastic and config.stall_shutdown_s > 0:
            timeout = timedelta(seconds=config.stall_shutdown_s)
        if device.type == "cuda":
            ordinal = int(os.environ.get("HOROVOD_DEVICE_ORDINAL",
                                         launched.local_rank))
            if ordinal >= torch.cuda.device_count():
                raise RuntimeError(
                    f"local rank {launched.local_rank} (device ordinal "
                    f"{ordinal}) has no GPU: {torch.cuda.device_count()} visible")
            torch.cuda.set_device(ordinal)
            device = torch.device("cuda", ordinal)
            if config.elastic:
                for k, v in _ELASTIC_NCCL_ENV.items():
                    os.environ.setdefault(k, v)
        _init_process_group("nccl" if device.type == "cuda" else "gloo",
                            topo, timeout)
        _state.topology = topo
        _state.config = config
        _state.device = device
        _state.sequence = itertools.count()
        _state.engines_made = 0
        _start_telemetry(topo, config)


def _clock_offset_ns() -> Optional[int]:
    """This worker's clock offset to the launcher's driver over its task
    channel (``tracing/clock.py``), or None outside a launched worker or
    when the probe fails (the spans then stay on the local clock)."""
    secret = os.environ.get("HOROVOD_SECRET")
    try:
        from ..runner.network import BasicClient
        from ..runner.service import worker_addresses
        from ..tracing.clock import estimate_offset_ns

        addrs = worker_addresses()
        if not addrs or not secret:
            return None
        client = BasicClient(addrs, bytes.fromhex(secret), timeout=5.0)
        try:
            return estimate_offset_ns(
                lambda: client.request({"kind": "clock_probe"})["t"])[0]
        finally:
            client.close()
    except Exception as e:  # noqa: BLE001 - tracing never fails init
        log("warning", f"trace clock probe failed ({e}); spans stay on the "
            "local clock")
        return None


def _start_telemetry(topo: Topology, config: Config) -> None:
    """The identity gauges, the flight ring, the recorder, the collectives'
    timing, the watchdog and the exposition of this world (module
    docstring). A port that cannot be bound is a warning, never a failed
    init."""
    from .. import tracing
    from ..metrics import StallWatchdog, registry, start_metrics_server
    from ..parallel import telemetry
    from ..tracing import flight

    reg = registry()
    reg.gauge("horovod_rank", help="this process's rank").set(topo.rank)
    reg.gauge("horovod_size", help="world size").set(topo.size)
    reg.gauge("horovod_local_rank").set(topo.local_rank)
    flight.init_flight(f"rank{topo.rank}")
    rec = tracing.init_recorder(config.trace_dir, topo.rank)
    if rec is not None:
        offset = _clock_offset_ns()
        if offset is not None:
            rec.set_clock_offset(offset)
    telemetry.configure(rec is not None or not config.stall_check_disable)
    if not config.stall_check_disable:
        _state.watchdog = StallWatchdog(
            check_time_s=config.stall_warning_s,
            shutdown_time_s=config.stall_shutdown_s, rank=topo.rank,
            on_abort=telemetry.abort_stalled,
            on_warn=lambda _: flight.get_flight().dump("stall"))
        _state.watchdog.add_source(telemetry.stall_source)
    if config.metrics_port:
        try:
            _state.metrics_server = start_metrics_server(
                config.metrics_port + topo.local_rank)
        except OSError as e:
            log("warning", f"HOROVOD_METRICS_PORT={config.metrics_port}: "
                f"cannot bind the metrics server ({e}); exposition disabled "
                "for this rank")


def _stop_telemetry(abort: bool) -> None:
    from ..parallel import telemetry
    from ..tracing import close_recorder

    if _state.watchdog is not None:
        _state.watchdog.stop()
        _state.watchdog = None
    if _state.metrics_server is not None:
        try:
            _state.metrics_server.stop()
        except Exception:  # noqa: BLE001 - teardown goes on
            pass
        _state.metrics_server = None
    try:
        telemetry.reset(flush=not abort)
    except Exception:  # noqa: BLE001 - a dead world's events may not read
        pass
    close_recorder()


def shutdown(abort: bool = False) -> None:
    """Leave the job: every process group the port made (the world, and the
    groups of ``parallel.mesh``) and the rendezvous store go with it;
    ``init()`` may be called again afterwards. ``abort`` (the elastic
    reset's teardown of a world that lost a peer) aborts NCCL's
    communicators first, so that no collective still waiting for the dead
    peer holds the teardown."""
    with _state.lock:
        if _state.topology is None:
            return
        _stop_engine()
        _stop_telemetry(abort)
        try:
            if abort and dist.get_backend() == "nccl":
                dist.distributed_c10d._abort_process_group()
            else:
                dist.destroy_process_group()
        finally:
            _state.topology = None
            _state.config = None
            _state.device = None
            _state.model_cut = False


def _coordinator_host() -> str:
    """The address rank 0's engine coordinator binds and publishes: the
    host of the rendezvous address (every rank reaches it), else
    loopback."""
    env = os.environ
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        return env["MASTER_ADDR"]
    if env.get("HOROVOD_COORD_ADDR"):
        return env["HOROVOD_COORD_ADDR"].rsplit(":", 1)[0]
    return "127.0.0.1"


def engine():
    """The eager engine of this world, attached on first use (every rank
    must attach it: its coordinator and ring form across the world)."""
    _topo()
    with _state.lock:
        if _state.engine is None:
            from . import engine as engine_mod

            rendezvous = None
            if _state.topology.size > 1:
                rendezvous = engine_mod.StoreRendezvous(
                    store=dist.distributed_c10d._get_default_store(),
                    key=f"horovod_engine_coord/{_state.engines_made}",
                    host=_coordinator_host())
            _state.engines_made += 1
            _state.engine = engine_mod.create(
                _state.topology, _state.config, rendezvous=rendezvous,
                watchdog=_state.watchdog)
        return _state.engine


def _stop_engine() -> None:
    """Shut the engine down (its threads and sockets end; pending handles
    fail). The next ``engine()`` of this world attaches a fresh one."""
    eng, _state.engine = _state.engine, None
    if eng is not None:
        try:
            eng.shutdown()
        except Exception as e:  # noqa: BLE001 - teardown goes on
            log("warning", f"engine shutdown failed: {e}")


def reset_engine() -> None:
    """Drop this world's engine, so that the next ``engine()`` builds a new
    one from the config as it then stands: no cached response or retained
    result outlives the call. Every rank must call it alike."""
    with _state.lock:
        _stop_engine()


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


def note_model_cut() -> None:
    """Record that this world holds a model cut over a model group of more
    than one rank (``TransformerLM(tp_group=)``): a rank's state is then
    one slice of the model, which ``checkpoint`` refuses to commit.
    ``shutdown`` clears it."""
    _state.model_cut = True


def model_cut() -> bool:
    """Whether ``note_model_cut`` was called in this world."""
    return _state.model_cut


def store() -> dist.Store:
    """The rendezvous store of the world's process group: a key-value store
    every rank reaches over TCP, whose ``wait`` takes a timeout of its own
    (a collective on the device does not)."""
    _topo()
    return dist.distributed_c10d._get_default_store()


def world_sequence() -> int:
    """The next number of a count that every rank of this world draws in
    the same order, from 0 in every world ``init`` forms: it names the store
    keys of an exchange every rank makes, so that a worker which joined a
    re-formed world (elastic) meets the survivors' keys."""
    _topo()
    return next(_state.sequence)
