"""The eager engine: negotiated host collectives over named numpy arrays.
The port of ``horovod_tpu/common/engine.py`` (its Python engine).

Framework threads enqueue named arrays asynchronously and get handles; a
background loop wakes on enqueue (or a cycle-time heartbeat while work is
in flight), negotiates which names every rank has submitted, executes the
collective, and completes the handles (``HandleManager``). Ranks may submit
in different orders: collectives are matched by name, not by position.

It serves host values only — numpy arrays, CPU torch tensors
(``mpi_ops.py``), metrics. Tensors on the card go to NCCL through
``parallel/collectives.py`` and never come here.

Control plane: rank 0 runs the coordinator over TCP, with a *response
cache* (``response_cache.py``): after a name's first full negotiation the
coordinator binds its signature to a small integer bit, and steady-state
ticks exchange per-rank bitvectors instead of request lists. A rank of a
world formed by ``init`` finds the coordinator through that world's store:
rank 0 binds a port the kernel picks and publishes ``host:port`` there
(``StoreRendezvous``); an engine built outside ``init`` dials
``HOROVOD_COORD_ADDR``, which rank 0 binds, as in the JAX package.
``HOROVOD_CTRL_RELAY`` sends a rank's control socket through its host's
relay (``ctrl/relay.py``) instead.

Data plane: allreduce bytes move over a peer-to-peer TCP ring
(reduce-scatter then allgather between ring neighbours), or, with
``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` on a multi-host grid, over the
two-level plane (intra-host ring, leaders ring across hosts, intra-host
allgather). The rank-0 star relay carries worlds of two, the other ops,
and every allreduce after a link fault demotes the plane. Every plane
reduces in the same canonical chunk order (``_ring_order_reduce``), so the
results are bitwise equal across planes, cold and cached negotiations,
and the JAX package's Python engine. Wires: none, fp16, bf16 (cast at
enqueue, rounded per hop) and topk (indices+values frames), chosen by
``HOROVOD_COMPRESSION`` or live through ``set_knobs``.

Every frame is authenticated: the coordinator channel is HMAC-SHA256 over
the pickled payload keyed by ``HOROVOD_SECRET``, checked before
unpickling; the ring links ride ``runner/network.py``'s ``Channel``.

``create`` builds this engine. The JAX package's native C++ engine is not
ported yet: ``HOROVOD_ENGINE=native`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import hmac
import os
import pickle
import queue as queue_mod
import socket
import struct
import threading
import time
from hashlib import sha256
from typing import Any, NamedTuple, Optional

import numpy as np

from . import protocol, resilience
from .basics import HorovodInternalError
from .config import Config, STALL_WARNING_TIME_S, _env_float
from .policy import CompressionPolicy
from .response_cache import CacheMirror, ResponseCache, request_key
from ..compression import (
    as_engine_array,
    cast,
    dtype_name,
    is_bfloat16,
    is_16bit_float,
    np_dtype,
    numpy_dtype_by_name,
    numpy_wire_dtype,
    parse_spec,
    topk_densify,
    topk_encode,
    topk_k,
    topk_eligible,
    topk_pack,
    topk_ratio_from_env,
    topk_select,
    topk_sparsify,
    topk_state_add,
    topk_state_dense,
    topk_state_scale,
    topk_state_slice,
    topk_unpack,
)
from .topology import Topology
from ..metrics import StallInfo, StallWatchdog, registry as _metrics_registry
from ..metrics.registry import DEFAULT_BYTE_BUCKETS
from ..tracing import get_recorder as _trace_recorder
from ..tracing import init_recorder as _trace_init
from ..tracing import trace_id as _trace_id
from ..tracing.clock import estimate_offset_ns as _estimate_offset_ns
from ..utils.logging import log


class TensorShapeMismatchError(HorovodInternalError):
    """Rank-divergent shape/dtype/op — the reference turns this into
    Response::ERROR delivered to every rank instead of a deadlock
    (ConstructResponse, operations.cc:321-523)."""


# Error-string sentinel on coordinator results that must surface as a plain
# HorovodInternalError (rung 3 of the escalation ladder — dead rank, needs
# the elastic reset), not as a validation mismatch.
_FATAL = "[reset] "


# ---------------------------------------------------------------- wire helpers

# Cap on a single frame (same role as the native engine's
# HOROVOD_MAX_FRAME_BYTES): a peer-claimed length above this aborts the
# connection instead of allocating.
_MAX_PAYLOAD = int(os.environ.get("HOROVOD_MAX_FRAME_BYTES", str(8 << 30)))
_DIGEST_LEN = 32


def _secret_from_env() -> bytes:
    s = os.environ.get("HOROVOD_SECRET", "")
    return s.encode() if s else b""


def _send_msg(sock: socket.socket, obj: Any, key: bytes) -> int:
    """Send one authenticated frame; returns the payload size in bytes
    (the control-plane byte counters read it)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    digest = hmac.new(key, payload, sha256).digest()
    sock.sendall(digest + struct.pack("!Q", len(payload)) + payload)
    return len(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    # resilience.recv_exact: preallocated recv_into (the bytes-+=
    # loop is quadratic on MB frames) plus the transport ladder's retry
    # rung — on sockets with a timeout, each idle deadline spends one
    # HOROVOD_NETWORK_RETRIES attempt before the op fails; the coordinator
    # server side accepts connections without a timeout and keeps blocking
    # between ticks, exactly as before.
    return resilience.recv_exact(sock, n)


def _recv_msg(sock: socket.socket, key: bytes) -> Any:
    digest = _recv_exact(sock, _DIGEST_LEN)
    (n,) = struct.unpack("!Q", _recv_exact(sock, 8))
    if n > _MAX_PAYLOAD:
        raise ConnectionError(
            f"frame length {n} exceeds HOROVOD_MAX_FRAME_BYTES cap")
    payload = _recv_exact(sock, n)
    if not hmac.compare_digest(digest, hmac.new(key, payload, sha256).digest()):
        # Authentication failed: drop the connection without ever unpickling.
        raise ConnectionError("frame failed HOROVOD_SECRET authentication")
    return pickle.loads(payload)


# ------------------------------------------------------------------ handles

class HandleManager:
    """int handle → status map (reference torch/handle_manager.{cc,h})."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0
        self._results: dict[int, tuple[Optional[Exception], Any]] = {}
        self._done = threading.Condition(self._lock)

    def allocate(self) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            return h

    def mark_done(self, handle: int, error: Optional[Exception], result: Any) -> None:
        with self._done:
            self._results[handle] = (error, result)
            self._done.notify_all()

    def poll(self, handle: int) -> bool:
        with self._lock:
            return handle in self._results

    def wait_and_clear(self, handle: int, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._done:
            while handle not in self._results:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"handle {handle} not done")
                self._done.wait(remaining)
            error, result = self._results.pop(handle)
        if error is not None:
            raise error
        return result


# --------------------------------------------------- canonical ring reduction

def _chunk_bounds(n: int, world: int) -> list[int]:
    """np.array_split boundaries for a flat array of n elements (the
    canonical ring chunking — protocol.chunk_bounds)."""
    return protocol.chunk_bounds(n, world)


def _acc_start(chunk: np.ndarray) -> np.ndarray:
    """Seed a chunk accumulator at NATIVE ring width: f32 adds
    for f32 payloads, f64 for f64 — exactly the arithmetic the native ring's
    add_chunk performs, which is what pins native == python bitwise for
    uncompressed folds (and halves the f32 phase-1 hop bytes the old
    float64 accumulator shipped). 16-bit float payloads never reach this:
    they route through the implicit wire path (protocol.reduce_plan) and
    round per hop like the native 16-bit storage does. The seed is never
    mutated by either plane (adds allocate or land on the received
    buffer), so inputs pass through copy-free."""
    return chunk


def _acc_finish(acc: np.ndarray, average: bool, world: int,
                dtype: np.dtype) -> np.ndarray:
    if average:
        acc = acc / world
    return acc if acc.dtype == dtype else cast(acc, dtype)


def _ring_order_reduce(arrs: list[np.ndarray], average: bool,
                       wire_dtype=None, grid=None) -> np.ndarray:
    """Canonical allreduce reduction, shared by the star relay and the peer
    ring: chunk c accumulates contributions starting at rank (c+1) % world
    in ring order — exactly the order the ring reduce-scatter performs —
    so the two data planes (and cold vs cached negotiations) produce
    BITWISE-IDENTICAL results.

    ``grid=(L, C)`` switches to the HIERARCHICAL canonical order:
    ``arrs`` indexed by blocked global rank (rank = cross*L + local), each
    element reduced as host-subtotals-then-hosts exactly the way the
    two-level plane's local-RS → cross-ring → local-AG ladder computes it
    (see ``_grid_order_reduce``). ``grid=(1, world)`` and ``grid=(world,
    1)`` both degenerate to this flat order bitwise — the single-host
    degeneracy the hier tests pin.

    ``wire_dtype`` (HOROVOD_COMPRESSION) simulates the compressed ring's
    wire hops exactly: every partial sum is rounded to the wire dtype
    before the next contribution lands (the reduce-scatter hop payload),
    the finished partial is rounded once more BEFORE the average divide
    (the storage round — the native ring's final add stores the partial at
    wire width, ring.h add_chunk), and the finished chunk is rounded again
    for the allgather so every rank — including the chunk's owner — holds
    the identical wire-representable value. Compressed accumulation runs
    at float32 — the native engine's accumulate-in-fp32 (ring.h
    add_chunk) — which is lossless relative to the per-hop 16-bit rounding
    and half the cast/add cost of a float64 path; contributions were
    quantized at enqueue, so viewing them at f32 drops no information
    either.

    Uncompressed folds run at NATIVE ring width —
    f32 adds for f32 payloads, f64 for f64 (protocol.reduce_plan) — and a
    16-bit float payload with no explicit wire dtype implicitly hops at
    its own width (per-hop rounding: storage between adds is 16-bit on
    both engines). That is exactly the arithmetic the native ring performs,
    which is what pins both engines bitwise to this oracle for
    none/bf16/fp16/topk alike.

    ``wire_dtype="topk"`` is the SPARSE wire's canonical order:
    callers pass the already-sparsified dense contributions (enqueue-time
    top-k selection, zeros elsewhere) and the fold runs at float32 with no
    per-hop rounding — sparse frames carry exact f32 values, so the f32
    astype hops below are identities and this degenerates to the pure
    ring-order f32 fold the index-merging data planes compute. Selected
    values are never exact zeros (topk_select's contract), which is what
    makes skipping the zero terms in a sparse merge bitwise equal to this
    dense fold."""
    if isinstance(wire_dtype, str) and wire_dtype == "topk":
        wire_dtype = np.dtype(np.float32)
    if wire_dtype is None and is_16bit_float(arrs[0].dtype):
        # Implicit wire = self: 16-bit payloads round at every hop on both
        # engines (native storage between adds is 16-bit, ring.h).
        wire_dtype = arrs[0].dtype
    if grid is not None:
        return _grid_order_reduce(arrs, average, wire_dtype, grid)
    world = len(arrs)
    shape, dtype = arrs[0].shape, arrs[0].dtype
    flats = [np.ascontiguousarray(a).ravel() for a in arrs]
    n = flats[0].size
    bounds = _chunk_bounds(n, world)
    out = np.empty(n, dtype=dtype)
    if wire_dtype is not None:
        acc_dt = np.dtype(np.float32)
        flats = [f if f.dtype == acc_dt else cast(f, acc_dt) for f in flats]
    for c in range(world):
        lo, hi = bounds[c], bounds[c + 1]
        start = (c + 1) % world
        if wire_dtype is None:
            acc = _acc_start(flats[start][lo:hi])
        else:
            acc = flats[start][lo:hi]
        for k in range(1, world):
            if wire_dtype is not None:
                # The hop: the sender rounds the partial to the wire dtype,
                # the receiver upcasts to accumulator width before adding.
                acc = cast(cast(acc, wire_dtype), acc_dt)
            acc = acc + flats[(start + k) % world][lo:hi]
        if wire_dtype is not None:
            # Storage round: the native ring's final reduce-scatter add
            # stores the partial at wire width; the average then divides
            # the ROUNDED value on both engines. Idempotent for SUM folds
            # (the allgather round below re-rounds the same value).
            acc = cast(cast(acc, wire_dtype), acc_dt)
        fin = _acc_finish(acc, average, world, dtype)
        if wire_dtype is not None:
            fin = cast(cast(fin, wire_dtype), dtype)
        out[lo:hi] = fin
    return out.reshape(shape)


def _grid_order_reduce(arrs: list[np.ndarray], average: bool,
                       wire_dtype, grid: tuple) -> np.ndarray:
    """Hierarchical canonical order (the ``grid=`` branch of
    :func:`_ring_order_reduce`): the exact fold the two-level data plane
    performs, as pure numpy.

    Per local chunk l (an L-way split of the flat buffer): every host folds
    its members' contributions in local ring order starting at member
    (l+1) % L — the intra-host reduce-scatter; then per cross subchunk k
    (a C-way split of chunk l) the host subtotals fold in cross ring order
    starting at host (k+1) % C — the leaders ring. The fixed (l+1)/(k+1)
    leader starts are the ring lockstep's natural fold starts, so the wire
    plane reproduces this order hop for hop. Compression rounds exactly
    where the wire does: before every add on both levels (partials travel
    at the wire dtype) and once on the finished value (the allgather hop).
    """
    if isinstance(wire_dtype, str) and wire_dtype == "topk":
        wire_dtype = np.dtype(np.float32)  # sparse wire: exact f32 fold
    if wire_dtype is None and is_16bit_float(arrs[0].dtype):
        wire_dtype = arrs[0].dtype  # implicit wire = self (16-bit storage)
    L, C = int(grid[0]), int(grid[1])
    world = L * C
    if len(arrs) != world:
        raise ValueError(f"grid {grid} needs {world} arrays, got {len(arrs)}")
    shape, dtype = arrs[0].shape, arrs[0].dtype
    flats = [np.ascontiguousarray(a).ravel() for a in arrs]
    n = flats[0].size
    lb = _chunk_bounds(n, L)
    out = np.empty(n, dtype=dtype)
    if wire_dtype is not None:
        acc_dt = np.dtype(np.float32)
        flats = [f if f.dtype == acc_dt else cast(f, acc_dt) for f in flats]
    for l in range(L):
        lo, hi = lb[l], lb[l + 1]
        # Stage 1: per-host subtotals of local chunk l (intra-host RS fold).
        start = (l + 1) % L
        partials = []
        for c in range(C):
            x = flats[c * L + start][lo:hi]
            acc = x if wire_dtype is not None else _acc_start(x)
            for k in range(1, L):
                if wire_dtype is not None:
                    acc = cast(cast(acc, wire_dtype), acc_dt)
                acc = acc + flats[c * L + (start + k) % L][lo:hi]
            if wire_dtype is not None:
                # Storage round: the intra-host reduce-scatter's final add
                # stores the host subtotal at wire width on the native
                # ladder; stage 2 folds the ROUNDED subtotals.
                acc = cast(cast(acc, wire_dtype), acc_dt)
            partials.append(acc)
        # Stage 2: fold the host subtotals per cross subchunk (leaders ring).
        cb = _chunk_bounds(hi - lo, C)
        for k in range(C):
            s, e = cb[k], cb[k + 1]
            cstart = (k + 1) % C
            acc = partials[cstart][s:e]
            for j in range(1, C):
                if wire_dtype is not None:
                    acc = cast(cast(acc, wire_dtype), acc_dt)
                acc = acc + partials[(cstart + j) % C][s:e]
            if wire_dtype is not None:
                acc = cast(cast(acc, wire_dtype), acc_dt)  # storage round
            fin = _acc_finish(acc, average, world, dtype)
            if wire_dtype is not None:
                fin = cast(cast(fin, wire_dtype), dtype)
            out[lo + s:lo + e] = fin
    return out.reshape(shape)


# ---------------------------------------------------- fabric topology planning

def plan_grid(coords: dict) -> Optional[dict]:
    """Validate a world's host coordinates as a homogeneous blocked grid and
    return the two-level plan, or None when the ladder cannot run.

    ``coords``: rank -> (local_rank, local_size, cross_rank, cross_size).
    Requirements (the Python mirror of the native ``analyze_hier``): L > 1 and C > 1, identical (L, C) on every rank,
    every (cross, local) cell covered exactly once, and the BLOCKED rank
    map rank == cross*L + local — the eager plane's chunk ownership and the
    canonical grid reduce order both index by it. Deterministic over the
    same map, so every rank reaches the same verdict (an asymmetric verdict
    would deadlock ring establishment)."""
    if not coords:
        return None
    ranks = sorted(coords)
    l0, L, c0, C = coords[ranks[0]]
    if L <= 1 or C <= 1 or len(ranks) != L * C:
        return None
    if ranks != list(range(L * C)):
        return None
    for r in ranks:
        lr, ls, cr, cs = coords[r]
        if ls != L or cs != C:
            return None
        if not (0 <= lr < L and 0 <= cr < C):
            return None
        if r != cr * L + lr:
            return None
    return {"L": L, "C": C,
            # rank r's ring peers: host members in local order, and the
            # ranks sharing r's local slot in cross order.
            "local_group": lambda r: [(r // L) * L + i for i in range(L)],
            "cross_group": lambda r: [c * L + (r % L) for c in range(C)]}


# ----------------------------------------------------------- peer ring plane

def _connect_ring(listener, my_pos: int, size: int, endpoints: list,
                  ring_key: bytes, tag: str, connect_timeout: float):
    """Build one ring's neighbour links: connect to the next member, accept
    from the previous, verify the authenticated hello names this ring and
    these positions. ``endpoints[pos] = (host, port)``. Returns
    ``(next_ch, prev_ch, next_sock, prev_sock)``.

    Shared by the flat peer ring and both levels of the hierarchical plane;
    the ``tag`` rides the hello so a connection misrouted between the flat /
    local / cross listeners is rejected instead of silently pairing the
    wrong rings (the channels are also keyed per ring purpose, so the
    frames would not authenticate anyway — the tag turns that into a
    readable error)."""
    from ..runner.network import Channel

    nxt, prv = (my_pos + 1) % size, (my_pos - 1) % size
    accepted: dict = {}

    def _accept():
        try:
            conn, _ = listener.accept()
            conn.settimeout(connect_timeout)
            ch = Channel(conn, ring_key, server=True, scope="ring")
            hello = ch.recv()
            if (hello.get("hello") != prv or hello.get("to") != my_pos
                    or hello.get("ring", tag) != tag):
                raise ConnectionError(
                    f"{tag} ring accept: expected member {prv}, got {hello}")
            ch.send({"ok": 1})
            accepted["ch"], accepted["sock"] = ch, conn
        except Exception as e:  # noqa: BLE001
            accepted["err"] = e

    t = threading.Thread(target=_accept, daemon=True)
    t.start()
    nhost, nport = endpoints[nxt]
    deadline = time.monotonic() + connect_timeout
    nsock = None
    while True:
        try:
            nsock = socket.create_connection(
                (nhost, nport), timeout=connect_timeout)
            break
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.1)
    nsock.settimeout(connect_timeout)
    nch = Channel(nsock, ring_key, server=False, scope="ring")
    nch.send({"hello": my_pos, "to": nxt, "ring": tag})
    if nch.recv().get("ok") != 1:
        raise ConnectionError(f"{tag} ring connect: bad ack from next")
    t.join(timeout=connect_timeout)
    if "ch" not in accepted:
        raise accepted.get(
            "err", ConnectionError(f"{tag} ring accept timed out"))
    # Steady-state deadline from the transport policy: a stalled
    # hop spends HOROVOD_NETWORK_RETRIES idle periods of this length
    # (counted in horovod_transport_retries_total) before the link fails
    # and the plane demotes — replacing the old flat 600 s hang that only
    # the stall watchdog could interrupt. A dead peer still wakes us
    # immediately (RST).
    for s_ in (nsock, accepted["sock"]):
        s_.settimeout(resilience.default_policy().timeout_s)
        s_.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # MB-scale chunk hops with default (~200 KiB) buffers cost dozens
        # of sender/receiver context-switch pairs per hop — pure overhead
        # when ranks share cores.
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                s_.setsockopt(socket.SOL_SOCKET, opt, 4 << 20)
            except OSError:  # pragma: no cover - cap by sysctl
                pass
    return nch, accepted["ch"], nsock, accepted["sock"]


class _RingLinks:
    """One ring's pair of neighbour channels plus a dedicated sender thread.

    Links ride :class:`horovod_tpu_torch.runner.network.Channel` — the repo's
    session-keyed, sequence-numbered HMAC framing — under a purpose-bound
    subkey of the job secret, so a captured ring frame neither replays nor
    authenticates on the coordinator channel (or on another ring). The
    sender thread decouples send from recv (both neighbours push ~equal
    bytes per step; blocking sends back-to-back would deadlock once chunks
    exceed the socket buffers).

    Every link carries a fabric-tier tag (``local`` = same host, ``cross``
    = the link crosses a host boundary): sends bill
    ``horovod_wire_bytes_total{tier=...}`` through ``on_tier`` and the
    tracing io hooks stamp wire spans with the tier — the per-fabric
    accounting the hierarchical A/B and the straggler report read."""

    _STOP = object()

    def __init__(self, next_ch, prev_ch, socks, owner,
                 next_tier: str = "local", prev_tier: str = "local") -> None:
        self._next_ch = next_ch
        self._prev_ch = prev_ch
        self._socks = list(socks)
        self._owner = owner
        self.next_tier = next_tier
        self.prev_tier = prev_tier
        self.bytes_sent = 0
        self._err: Optional[Exception] = None
        self._sendq: "queue_mod.Queue" = queue_mod.Queue()
        if owner._tracer is not None:
            # Distributed tracing: the
            # owner plane's `trace_ctx` names the collective currently on
            # the wire; the Channel io hooks time the hops at the socket
            # layer — the send side runs on the sender thread, which is
            # exactly the wire time, not queue time. Each hook closes over
            # ITS link's tier, so wire_send/wire_recv spans say which
            # fabric carried the bytes.
            def _hook(tier):
                def _io(direction: str, nbytes: int, t0: int, t1: int):
                    ctx = owner.trace_ctx
                    if ctx is not None:
                        extra = ({"fmt": ctx["fmt"]} if ctx.get("fmt")
                                 else {})
                        owner._tracer.span(
                            ctx["tid"], ctx["name"], "allreduce",
                            "wire_send" if direction == "send"
                            else "wire_recv", t0, t1, bytes=int(nbytes),
                            tier=tier, **extra)
                return _io

            next_ch.io_hook = _hook(next_tier)
            prev_ch.io_hook = _hook(prev_tier)
        self._sender = threading.Thread(
            target=self._send_loop, name="hvd_ring_send", daemon=True)
        self._sender.start()

    def _send_loop(self) -> None:
        while True:
            item = self._sendq.get()
            if item is self._STOP:
                return
            try:
                self._next_ch.send_bytes(item)
            except Exception as e:  # noqa: BLE001
                self._err = e
                return

    def send(self, arr: np.ndarray) -> None:
        # Raw-buffer frame (Channel.send_bytes): the receiver derives shape
        # and dtype from protocol position, so the chunk bytes skip pickle
        # entirely — on a CPU-bound host that is ~45% of the per-byte cost.
        if self._err is not None:
            raise ConnectionError(f"ring sender failed: {self._err}")
        arr = np.ascontiguousarray(arr)
        # uint8 view (zero-copy): the structured bfloat16 dtype has no
        # plain PEP-3118 buffer format for memoryview(arr).cast inside
        # send_bytes; the byte view is dtype-agnostic and free.
        self._sendq.put(arr.view(np.uint8))
        n = int(arr.nbytes)
        self.bytes_sent += n
        self._owner._on_bytes(n)
        self._owner._on_tier(n, self.next_tier)

    def recv(self, dtype, count: int) -> np.ndarray:
        if self._err is not None:
            raise ConnectionError(f"ring sender failed: {self._err}")
        buf = self._prev_ch.recv_bytes()
        expected = count * np.dtype(dtype).itemsize
        if len(buf) != expected:
            raise ConnectionError(
                f"ring frame size {len(buf)} != expected {expected}")
        return np.frombuffer(buf, dtype=dtype) if count else \
            np.empty(0, dtype=dtype)

    def recv_raw(self) -> np.ndarray:
        """One frame as uint8, length taken from the frame itself — the
        sparse wire's hops are variable-size (k grows with every index
        merge), so the fixed dtype*count check of :meth:`recv` moves into
        topk_unpack's self-describing header validation."""
        if self._err is not None:
            raise ConnectionError(f"ring sender failed: {self._err}")
        return np.frombuffer(self._prev_ch.recv_bytes(), dtype=np.uint8)

    def close(self) -> None:
        self._sendq.put(self._STOP)
        # Drain before closing: a rank finishes its allreduce the moment the
        # last frame ARRIVES, but its own final send (which the next
        # neighbour still needs) may sit in the queue — closing the socket
        # now would destroy it and fail the neighbour with "peer closed".
        # FIFO order means the _STOP is reached only after every pending
        # frame hit the kernel; the bounded join keeps shutdown from
        # hanging on a peer that already died mid-send.
        self._sender.join(timeout=10.0)
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass


def _wire_method(wire_dtype) -> str:
    """Method label for the wire telemetry: the HOROVOD_COMPRESSION name of
    a wire dtype ('bf16'/'fp16'), or 'topk' for the sparse sentinel."""
    if isinstance(wire_dtype, str):
        return wire_dtype
    name = dtype_name(wire_dtype)
    return {"float16": "fp16", "bfloat16": "bf16"}.get(name, name)


def _wire_tag(wire) -> str:
    """The request's ``wire`` field of an entry's wire: '' uncompressed,
    'topk', or the wire dtype's name ('bfloat16'/'float16')."""
    if wire is None:
        return ""
    return wire if isinstance(wire, str) else dtype_name(wire)


class _PeerRing:
    """Authenticated peer-to-peer TCP ring for the Python engine's allreduce
    data plane (reduce-scatter + allgather, the shape of the native ring.h
    and the reference's NCCL ring, operations.cc:1221-1446). The FLAT plane:
    one ring over all N ranks; cross-host links (host-boundary neighbours)
    are tier-tagged so the hier A/B can measure what this plane ships over
    the slow fabric. See :class:`_HierPlane` for the two-level ladder."""

    def __init__(self, rank: int, world: int, next_ch, prev_ch,
                 next_sock, prev_sock, listener,
                 on_bytes=None, on_wire=None, on_tier=None, tracer=None,
                 next_tier: str = "local", prev_tier: str = "local") -> None:
        self.rank = rank
        self.world = world
        self._on_bytes = on_bytes or (lambda n: None)
        # on_wire(wire_bytes, saved_bytes, method): compression telemetry —
        # called per compressed hop with the bytes actually sent, the bytes
        # the uncompressed plane would have sent minus that, and the format
        # name ("bf16"/"fp16"/"topk") for the method-labeled saved counter.
        self._on_wire = on_wire or (lambda w, s, m=None: None)
        self._on_tier = on_tier or (lambda n, t: None)
        self._tracer = tracer
        self.trace_ctx: Optional[dict] = None
        self._links = _RingLinks(next_ch, prev_ch,
                                 [next_sock, prev_sock, listener], self,
                                 next_tier=next_tier, prev_tier=prev_tier)

    @property
    def bytes_sent(self) -> int:
        return self._links.bytes_sent

    def _send(self, arr: np.ndarray) -> None:
        self._links.send(arr)

    def _recv(self, dtype, count: int) -> np.ndarray:
        return self._links.recv(dtype, count)

    def allreduce(self, arr: np.ndarray, average: bool,
                  wire_dtype=None, sparse_tiers=None) -> np.ndarray:
        """Ring allreduce, bitwise-identical to _ring_order_reduce.

        Uncompressed (``wire_dtype=None``): phase-1 partial sums travel at
        accumulator width (float64 for floating dtypes); after world-1 hops
        this rank owns the finished sum of chunk ``rank``; phase-2 finished
        chunks circulate at native width.

        Compressed (HOROVOD_COMPRESSION): every hop carries 2-byte
        wire-dtype payloads — phase-1 partials are rounded to the wire
        dtype per hop and upcast to accumulator width before each add
        (cast-on-send, accumulate-in-fp64), and the finished chunk is
        rounded once for the allgather so every rank (owner included)
        stores the identical wire-representable value. The exact same
        rounding sequence lives in ``_ring_order_reduce``, keeping star
        and ring bitwise identical under compression too.

        Sparse (``wire_dtype="topk"``): hops carry self-describing
        indices+values frames of the partial's nonzero support —
        sparse+sparse reduces by index merge, densifying on overflow — see
        :meth:`_sparse_allreduce`.
        """
        arr = np.ascontiguousarray(arr)
        world, rank = self.world, self.rank
        if world == 1:
            return arr
        if isinstance(wire_dtype, str) and wire_dtype == "topk":
            return self._sparse_allreduce(arr, average, sparse_tiers)
        # Implicit wire = self for 16-bit float payloads (protocol.
        # reduce_plan): hops round per step like the native 16-bit storage
        # does; no compression telemetry — nothing was compressed.
        count_wire = wire_dtype is not None
        if wire_dtype is None and is_16bit_float(arr.dtype):
            wire_dtype = arr.dtype
        flat = arr.ravel()
        bounds = _chunk_bounds(flat.size, world)
        acc_dt = _acc_start(flat[:0]).dtype  # uncompressed phase-1 width
        native_itemsize = int(arr.dtype.itemsize)
        if wire_dtype is not None:
            # Compressed accumulate-in-fp32 (native ring.h parity; same
            # rounding chain as the oracle): the enqueue-time quantization
            # makes the f32 view of the contribution lossless, and f32
            # casts/adds run at half the f64 path's CPU cost. The saved
            # counter still compares against what the UNCOMPRESSED plane
            # ships on this hop (acc_dt-width partials).
            wire_acc = np.dtype(np.float32)
            work = flat if flat.dtype == wire_acc else cast(flat, wire_acc)
        else:
            work = flat

        def chunk(c):
            return work[bounds[c]:bounds[c + 1]]

        def csize(c):
            return bounds[c + 1] - bounds[c]

        # Tracing: hop IO spans come from the Channel io hooks; the local
        # reduction arithmetic is timed here so the analyzer can split wire
        # time from reduce time per collective.
        ctx = self.trace_ctx
        trace = self._tracer if ctx is not None else None
        if wire_dtype is None:
            part = _acc_start(chunk((rank - 1) % world))
        else:
            part = chunk((rank - 1) % world)
        for s in range(1, world):
            if wire_dtype is None:
                self._send(part)
            else:
                w = cast(part, wire_dtype)
                self._send(w)
                if count_wire:
                    self._on_wire(
                        int(w.nbytes),
                        int(w.size) * native_itemsize - int(w.nbytes),
                        _wire_method(wire_dtype))
            c = (rank - s - 1) % world
            if wire_dtype is None:
                part = self._recv(acc_dt, csize(c))
                # In-place on the received buffer (np.frombuffer over the
                # recv bytearray is writable): same IEEE results as
                # `recv + chunk`, one allocation+copy less per hop.
                r0 = time.monotonic_ns() if trace else 0
                part += chunk(c)
            else:
                part = cast(self._recv(wire_dtype, csize(c)), wire_acc)
                r0 = time.monotonic_ns() if trace else 0
                part += chunk(c)
            if trace:
                trace.span(ctx["tid"], ctx["name"], "allreduce", "reduce",
                           r0, time.monotonic_ns(), hop=s)
        if wire_dtype is not None:
            # Storage round (protocol.reduce_plan): the native ring's final
            # reduce-scatter add stores the partial at wire width; average
            # divides the rounded value on both engines.
            part = cast(cast(part, wire_dtype), wire_acc)
        mine = _acc_finish(part, average, world, arr.dtype)
        out = np.empty_like(flat)
        if wire_dtype is None:
            out[bounds[rank]:bounds[rank + 1]] = mine
            cur = mine
            for s in range(1, world):
                self._send(cur)
                c = (rank - s) % world
                cur = self._recv(arr.dtype, csize(c))
                out[bounds[c]:bounds[c + 1]] = cur
        else:
            cur_w = cast(mine, wire_dtype)
            out[bounds[rank]:bounds[rank + 1]] = cast(cur_w, arr.dtype)
            for s in range(1, world):
                self._send(cur_w)
                if count_wire:
                    self._on_wire(
                        int(cur_w.nbytes),
                        int(cur_w.size * native_itemsize - cur_w.nbytes),
                        _wire_method(wire_dtype))
                c = (rank - s) % world
                # Forward the wire bytes verbatim: re-rounding an already
                # wire-representable chunk is the identity, so every rank
                # stores the same upcast value.
                cur_w = self._recv(wire_dtype, csize(c))
                out[bounds[c]:bounds[c + 1]] = cast(cur_w, arr.dtype)
        return out.reshape(arr.shape)

    def _sparse_allreduce(self, arr: np.ndarray, average: bool,
                          sparse_tiers=None) -> np.ndarray:
        """Top-k ring allreduce, bitwise-identical to
        ``_ring_order_reduce(..., wire_dtype="topk")`` on the same
        (enqueue-sparsified) inputs.

        Phase 1 carries the partial's nonzero support as indices+values
        frames, reduced by index merge (incoming + mine, the dense fold's
        add order) with densify-on-overflow past the byte break-even;
        phase 2 circulates the finished chunks the same way. Frame values
        are exact f32, so whether a given link frames sparse or dense
        (``sparse_tiers`` — the per-tier policy) never changes the result,
        only where the byte savings land."""
        world, rank = self.world, self.rank
        flat = arr.ravel()
        bounds = _chunk_bounds(flat.size, world)
        prefer = (sparse_tiers is None
                  or self._links.next_tier in sparse_tiers)

        def chunk(c):
            return flat[bounds[c]:bounds[c + 1]]

        def csize(c):
            return bounds[c + 1] - bounds[c]

        ctx = self.trace_ctx
        trace = self._tracer if ctx is not None else None
        c = (rank - 1) % world
        state = ("sparse", *topk_sparsify(chunk(c)))
        for s in range(1, world):
            frame = topk_encode(state, csize(c), prefer)
            self._send(frame)
            # Saved vs what the UNCOMPRESSED plane ships on this hop:
            # native-width (f32) phase-1 partials (protocol.reduce_plan).
            self._on_wire(int(frame.nbytes),
                          max(0, csize(c) * 4 - int(frame.nbytes)), "topk")
            c = (rank - s - 1) % world
            st_in = topk_unpack(self._links.recv_raw(), csize(c))
            r0 = time.monotonic_ns() if trace else 0
            state = topk_state_add(st_in, *topk_sparsify(chunk(c)), csize(c))
            if trace:
                trace.span(ctx["tid"], ctx["name"], "allreduce", "reduce",
                           r0, time.monotonic_ns(), hop=s, fmt="topk")
        if average:
            state = topk_state_scale(state, world)
        out = np.empty_like(flat)
        out[bounds[rank]:bounds[rank + 1]] = \
            topk_state_dense(state, csize(rank))
        cur = topk_encode(state, csize(rank), prefer)
        c = rank
        for s in range(1, world):
            self._send(cur)
            self._on_wire(int(cur.nbytes),
                          max(0, csize(c) * 4 - int(cur.nbytes)), "topk")
            c = (rank - s) % world
            # Forward the frame verbatim next hop: every rank stores the
            # identical f32 values whichever encoding carried them.
            cur = self._links.recv_raw()
            st = topk_unpack(cur, csize(c))
            out[bounds[c]:bounds[c + 1]] = topk_state_dense(st, csize(c))
        return out.reshape(arr.shape)

    def close(self) -> None:
        self._links.close()


class _HierPlane:
    """Two-level, fabric-aware eager allreduce plane (the Python mirror of
    the native ladder ``allreduce_buffer`` and upstream
    HOROVOD_HIERARCHICAL_ALLREDUCE):

    1. intra-host ring reduce-scatter among co-located ranks — local rank l
       ends holding local chunk l reduced across this host (loopback
       traffic only);
    2. cross-host ring allreduce of chunk l among the ranks sharing local
       slot l — each local rank is its host's LEADER for its own chunk, so
       L leaders rings run in parallel, each carrying 1/local_size of the
       payload over the slow fabric (2·(B/L)·(C-1)/C cross bytes per rank
       vs the flat boundary rank's 2·B·(N-1)/N);
    3. intra-host ring allgather redistributes the finished chunks.

    The fold order — fixed leader starts (l+1) % L locally, (k+1) % C
    across hosts, per-hop wire-dtype rounding exactly where the flat ring
    rounds — is the canonical grid order of ``_ring_order_reduce(grid=...)``,
    so results are deterministic, identical across ranks, and reproducible
    by the pure-numpy oracle (cold == cached, and == the star executor run
    under the same grid order)."""

    def __init__(self, topo, on_bytes=None, on_wire=None, on_tier=None,
                 tracer=None) -> None:
        self.topo = topo
        self.rank, self.world = topo.rank, topo.size
        self.L, self.C = topo.local_size, topo.cross_size
        self._on_bytes = on_bytes or (lambda n: None)
        self._on_wire = on_wire or (lambda w, s, m=None: None)
        self._on_tier = on_tier or (lambda n, t: None)
        self._tracer = tracer
        self.trace_ctx: Optional[dict] = None
        self._local: Optional[_RingLinks] = None
        self._cross: Optional[_RingLinks] = None
        self._listeners: list = []

    @property
    def bytes_sent(self) -> int:
        return ((self._local.bytes_sent if self._local else 0)
                + (self._cross.bytes_sent if self._cross else 0))

    def _connect(self, key: bytes, peers: dict, local_listener,
                 cross_listener, connect_timeout: float) -> None:
        from ..runner.network import derive_key

        # Owned immediately: a failure between the two ring builds must
        # still close both listeners through close().
        self._listeners = [local_listener, cross_listener]
        t = self.topo
        # Intra-host ring: my host's members in local-rank order. Every
        # link is same-host by construction (tier "local").
        lgroup = [t.cross_rank * self.L + i for i in range(self.L)]
        lends = [(peers[r]["host"], peers[r]["local_port"]) for r in lgroup]
        nch, pch, ns, ps = _connect_ring(
            local_listener, t.local_rank, self.L, lends,
            derive_key(key, b"eager-ring-local"), "local", connect_timeout)
        self._local = _RingLinks(nch, pch, [ns, ps, local_listener], self,
                                 next_tier="local", prev_tier="local")
        # Cross-host leaders ring: the ranks sharing my local slot, in
        # cross-rank order. Every link crosses hosts by construction
        # (tier "cross") — this is the ONLY stage that touches the slow
        # fabric, carrying 1/local_size of the bytes.
        xgroup = [c * self.L + t.local_rank for c in range(self.C)]
        xends = [(peers[r]["host"], peers[r]["cross_port"]) for r in xgroup]
        nch, pch, ns, ps = _connect_ring(
            cross_listener, t.cross_rank, self.C, xends,
            derive_key(key, b"eager-ring-cross"), "cross", connect_timeout)
        self._cross = _RingLinks(nch, pch, [ns, ps, cross_listener], self,
                                 next_tier="cross", prev_tier="cross")

    def allreduce(self, arr: np.ndarray, average: bool,
                  wire_dtype=None, sparse_tiers=None) -> np.ndarray:
        """Two-level ring allreduce, bitwise-identical to
        ``_ring_order_reduce(..., grid=(L, C))``.

        Uncompressed: stage-1/2 partials travel at accumulator width
        (float64 for floating dtypes); finished chunks circulate at native
        width. Compressed (HOROVOD_COMPRESSION): every hop on BOTH fabrics
        carries wire-dtype payloads — partials are rounded per hop and
        accumulated in f32 (native ring.h parity, the same rounding chain
        as the grid oracle), and the finished chunk is rounded once so
        every rank stores the identical wire-representable value.

        Sparse (``wire_dtype="topk"``): indices+values frames on both
        fabrics, index-merged per hop, with ``sparse_tiers`` choosing per
        FABRIC whether a hop frames sparse or dense (the adaptive policy's
        full-width-on-ICI / aggressive-on-DCN split) — a value-neutral
        choice, so the grid fold stays bitwise identical either way. See
        :meth:`_sparse_allreduce`."""
        arr = np.ascontiguousarray(arr)
        if isinstance(wire_dtype, str) and wire_dtype == "topk":
            return self._sparse_allreduce(arr, average, sparse_tiers)
        # Implicit wire = self for 16-bit float payloads; no compression
        # telemetry for it (protocol.reduce_plan, same as the flat ring).
        count_wire = wire_dtype is not None
        if wire_dtype is None and is_16bit_float(arr.dtype):
            wire_dtype = arr.dtype
        L, C, world = self.L, self.C, self.world
        l, c = self.topo.local_rank, self.topo.cross_rank
        flat = arr.ravel()
        lb = _chunk_bounds(flat.size, L)
        acc_dt = _acc_start(flat[:0]).dtype
        if wire_dtype is not None:
            wire_acc = np.dtype(np.float32)
            work = flat if flat.dtype == wire_acc else cast(flat, wire_acc)
        else:
            work = flat

        def lchunk(i):
            return work[lb[i]:lb[i + 1]]

        def lsize(i):
            return lb[i + 1] - lb[i]

        ctx = self.trace_ctx
        trace = self._tracer if ctx is not None else None

        def _reduce_span(t0, tier, hop):
            if trace:
                trace.span(ctx["tid"], ctx["name"], "allreduce", "reduce",
                           t0, time.monotonic_ns(), tier=tier, hop=hop)

        # -- stage 1: intra-host reduce-scatter (fold start (i+1) % L) ----
        if wire_dtype is None:
            part = _acc_start(lchunk((l - 1) % L))
        else:
            part = lchunk((l - 1) % L)
        native_itemsize = int(arr.dtype.itemsize)
        for s in range(1, L):
            if wire_dtype is None:
                self._local.send(part)
            else:
                w = cast(part, wire_dtype)
                self._local.send(w)
                if count_wire:
                    self._on_wire(
                        int(w.nbytes),
                        int(w.size) * native_itemsize - int(w.nbytes),
                        _wire_method(wire_dtype))
            i = (l - s - 1) % L
            if wire_dtype is None:
                part = self._local.recv(acc_dt, lsize(i))
            else:
                part = cast(self._local.recv(wire_dtype, lsize(i)), wire_acc)
            r0 = time.monotonic_ns() if trace else 0
            part += lchunk(i)
            _reduce_span(r0, "local", s)
        if wire_dtype is not None:
            # Storage round: the native ladder stores the host subtotal at
            # wire width after the intra-host reduce-scatter's final add.
            part = cast(cast(part, wire_dtype), wire_acc)
        # `part` = this host's subtotal of local chunk l, accumulator width.

        # -- stage 2: leaders ring allreduce of chunk l across hosts ------
        nl = int(part.size)
        cb = _chunk_bounds(nl, C)

        def cchunk(i):
            return part[cb[i]:cb[i + 1]]

        def csz(i):
            return cb[i + 1] - cb[i]

        cpart = cchunk((c - 1) % C)
        for s in range(1, C):
            if wire_dtype is None:
                self._cross.send(cpart)
            else:
                w = cast(cpart, wire_dtype)
                self._cross.send(w)
                if count_wire:
                    self._on_wire(
                        int(w.nbytes),
                        int(w.size) * native_itemsize - int(w.nbytes),
                        _wire_method(wire_dtype))
            i = (c - s - 1) % C
            if wire_dtype is None:
                cpart = self._cross.recv(acc_dt, csz(i))
            else:
                cpart = cast(self._cross.recv(wire_dtype, csz(i)), wire_acc)
            r0 = time.monotonic_ns() if trace else 0
            cpart += cchunk(i)
            _reduce_span(r0, "cross", s)
        if wire_dtype is not None:
            cpart = cast(cast(cpart, wire_dtype), wire_acc)  # storage round
        mine = _acc_finish(cpart, average, world, arr.dtype)
        fin_l = np.empty(nl, dtype=arr.dtype)
        if wire_dtype is None:
            fin_l[cb[c]:cb[c + 1]] = mine
            cur = mine
            for s in range(1, C):
                self._cross.send(cur)
                i = (c - s) % C
                cur = self._cross.recv(arr.dtype, csz(i))
                fin_l[cb[i]:cb[i + 1]] = cur
        else:
            # Final rounding (the allgather hop): every rank — owner
            # included — stores the identical wire-representable value;
            # forwarding the wire bytes verbatim keeps it that way.
            cur_w = cast(mine, wire_dtype)
            fin_l[cb[c]:cb[c + 1]] = cast(cur_w, arr.dtype)
            for s in range(1, C):
                self._cross.send(cur_w)
                if count_wire:
                    self._on_wire(
                        int(cur_w.nbytes),
                        int(cur_w.size * native_itemsize - cur_w.nbytes),
                        _wire_method(wire_dtype))
                i = (c - s) % C
                cur_w = self._cross.recv(wire_dtype, csz(i))
                fin_l[cb[i]:cb[i + 1]] = cast(cur_w, arr.dtype)

        # -- stage 3: intra-host allgather of finished local chunks -------
        out = np.empty_like(flat)
        out[lb[l]:lb[l + 1]] = fin_l
        if wire_dtype is None:
            cur = fin_l
            for s in range(1, L):
                self._local.send(cur)
                i = (l - s) % L
                cur = self._local.recv(arr.dtype, lsize(i))
                out[lb[i]:lb[i + 1]] = cur
        else:
            cur_w = cast(fin_l, wire_dtype)  # exact: values wire-representable
            for s in range(1, L):
                self._local.send(cur_w)
                if count_wire:
                    self._on_wire(
                        int(cur_w.nbytes),
                        int(cur_w.size * native_itemsize - cur_w.nbytes),
                        _wire_method(wire_dtype))
                i = (l - s) % L
                cur_w = self._local.recv(wire_dtype, lsize(i))
                out[lb[i]:lb[i + 1]] = cast(cur_w, arr.dtype)
        return out.reshape(arr.shape)

    def _sparse_allreduce(self, arr: np.ndarray, average: bool,
                          sparse_tiers=None) -> np.ndarray:
        """Top-k two-level allreduce, bitwise-identical to
        ``_ring_order_reduce(..., wire_dtype="topk", grid=(L, C))``: the
        same three-stage ladder as the dense plane, with every hop's
        payload an indices+values frame of the partial's nonzero support,
        index-merged in the grid fold's add order. Per-fabric framing:
        ``sparse_tiers`` says which of {"local", "cross"} prefer sparse
        frames; the other fabric ships dense f32 — identical values, so
        the policy split costs nothing in determinism."""
        L, C, world = self.L, self.C, self.world
        l, c = self.topo.local_rank, self.topo.cross_rank
        flat = arr.ravel()
        lb = _chunk_bounds(flat.size, L)
        sp_local = sparse_tiers is None or "local" in sparse_tiers
        sp_cross = sparse_tiers is None or "cross" in sparse_tiers

        def lchunk(i):
            return flat[lb[i]:lb[i + 1]]

        def lsize(i):
            return lb[i + 1] - lb[i]

        ctx = self.trace_ctx
        trace = self._tracer if ctx is not None else None

        def _reduce_span(t0, tier, hop):
            if trace:
                trace.span(ctx["tid"], ctx["name"], "allreduce", "reduce",
                           t0, time.monotonic_ns(), tier=tier, hop=hop,
                           fmt="topk")

        # -- stage 1: intra-host reduce-scatter (fold start (i+1) % L) ----
        i = (l - 1) % L
        state = ("sparse", *topk_sparsify(lchunk(i)))
        for s in range(1, L):
            frame = topk_encode(state, lsize(i), sp_local)
            self._local.send(frame)
            self._on_wire(int(frame.nbytes),
                          max(0, lsize(i) * 4 - int(frame.nbytes)), "topk")
            i = (l - s - 1) % L
            st_in = topk_unpack(self._local.recv_raw(), lsize(i))
            r0 = time.monotonic_ns() if trace else 0
            state = topk_state_add(st_in, *topk_sparsify(lchunk(i)),
                                   lsize(i))
            _reduce_span(r0, "local", s)
        # `state` = this host's subtotal of local chunk l.

        # -- stage 2: leaders ring allreduce of chunk l across hosts ------
        nl = lsize(l)
        cb = _chunk_bounds(nl, C)

        def csz(k):
            return cb[k + 1] - cb[k]

        k = (c - 1) % C
        cstate = topk_state_slice(state, cb[k], cb[k + 1])
        for s in range(1, C):
            frame = topk_encode(cstate, csz(k), sp_cross)
            self._cross.send(frame)
            self._on_wire(int(frame.nbytes),
                          max(0, csz(k) * 4 - int(frame.nbytes)), "topk")
            k = (c - s - 1) % C
            st_in = topk_unpack(self._cross.recv_raw(), csz(k))
            r0 = time.monotonic_ns() if trace else 0
            mine = topk_state_slice(state, cb[k], cb[k + 1])
            state_mi, state_mv = (topk_sparsify(mine[1])
                                  if mine[0] == "dense"
                                  else (mine[1], mine[2]))
            cstate = topk_state_add(st_in, state_mi, state_mv, csz(k))
            _reduce_span(r0, "cross", s)
        if average:
            cstate = topk_state_scale(cstate, world)
        fin_l = np.empty(nl, dtype=arr.dtype)
        fin_l[cb[c]:cb[c + 1]] = topk_state_dense(cstate, csz(c))
        cur = topk_encode(cstate, csz(c), sp_cross)
        k = c
        for s in range(1, C):
            self._cross.send(cur)
            self._on_wire(int(cur.nbytes),
                          max(0, csz(k) * 4 - int(cur.nbytes)), "topk")
            k = (c - s) % C
            cur = self._cross.recv_raw()
            st = topk_unpack(cur, csz(k))
            fin_l[cb[k]:cb[k + 1]] = topk_state_dense(st, csz(k))

        # -- stage 3: intra-host allgather of finished local chunks -------
        out = np.empty_like(flat)
        out[lb[l]:lb[l + 1]] = fin_l
        cur = topk_encode(("sparse", *topk_sparsify(fin_l)), nl, sp_local)
        i = l
        for s in range(1, L):
            self._local.send(cur)
            self._on_wire(int(cur.nbytes),
                          max(0, lsize(i) * 4 - int(cur.nbytes)), "topk")
            i = (l - s) % L
            cur = self._local.recv_raw()
            st = topk_unpack(cur, lsize(i))
            out[lb[i]:lb[i + 1]] = topk_state_dense(st, lsize(i))
        return out.reshape(arr.shape)

    def close(self) -> None:
        for links in (self._local, self._cross):
            if links is not None:
                links.close()
        for li in self._listeners:
            try:
                li.close()
            except OSError:
                pass


def establish_data_plane(client: "_Client", topo, key: bytes, config,
                         on_bytes=None, on_wire=None, on_tier=None,
                         tracer=None, connect_timeout: float = 60.0):
    """Negotiate and build this rank's eager data plane: the two-level
    hierarchical plane (HOROVOD_HIERARCHICAL_ALLREDUCE on a multi-host
    grid), the flat peer ring, or None for the star relay.

    Every rank must reach the same verdict (a half-plane deadlocks), so
    activation is two coordinator barriers: ``ring_hello`` gathers every
    rank's listener endpoints + host coordinates + hierarchical willingness
    and answers with ONE plane verdict for the whole world (hier only when
    every rank wants it and the coordinates form a homogeneous blocked
    grid); ``ring_confirm`` gathers per-rank connect success — the plane is
    active only when ALL ranks connected, else everyone falls back to the
    star together."""
    from ..runner.network import derive_key

    rank, world = topo.rank, topo.size
    enabled = world > 2 and bool(getattr(config, "ring_data_plane", True))
    hier_want = bool(getattr(config, "hierarchical_allreduce", False))
    grid_ok = topo.local_size > 1 and topo.cross_size > 1
    if hier_want and world > 1 and not (enabled and grid_ok):
        # Mirror the native engine's loud fallback (a silently ignored
        # knob is a bug): say WHY the ladder cannot run here.
        why = ("the ring data plane is disabled or the world is too small"
               if not enabled else
               "the topology is not a multi-host grid (need local_size>1 "
               "and cross_size>1)")
        log("warning",
            f"HOROVOD_HIERARCHICAL_ALLREDUCE=1 but {why}; using the flat "
            "eager plane", rank=rank)
    offer_hier = enabled and hier_want and grid_ok
    listeners: dict = {}
    plane = None
    ok = False
    try:
        info = {"enabled": enabled, "hier": offer_hier,
                "local_rank": topo.local_rank, "local_size": topo.local_size,
                "cross_rank": topo.cross_rank, "cross_size": topo.cross_size,
                "host": "", "port": 0, "local_port": 0, "cross_port": 0}
        if enabled:
            for name in (("flat", "port"),
                         *((("local", "local_port"), ("cross", "cross_port"))
                           if offer_hier else ())):
                li = socket.create_server(("0.0.0.0", 0), backlog=4)
                li.settimeout(connect_timeout)
                listeners[name[0]] = li
                info[name[1]] = li.getsockname()[1]
            info["host"] = client.local_host()
        resp = client.ring_hello(info)
        peers = resp.get("peers")
        verdict = resp.get("plane")
        if peers is not None and verdict == "hier":
            plane = _HierPlane(topo, on_bytes=on_bytes, on_wire=on_wire,
                               on_tier=on_tier, tracer=tracer)
            plane._connect(key, peers, listeners.pop("local"),
                           listeners.pop("cross"), connect_timeout)
            ok = True
        elif peers is not None:
            nxt, prv = (rank + 1) % world, (rank - 1) % world
            ends = [(peers[r]["host"], peers[r]["port"])
                    for r in range(world)]
            nch, pch, ns, ps = _connect_ring(
                listeners["flat"], rank, world, ends,
                derive_key(key, b"eager-ring"), "flat", connect_timeout)
            tier = {True: "cross", False: "local"}
            plane = _PeerRing(
                rank, world, nch, pch, ns, ps, listeners.pop("flat"),
                on_bytes=on_bytes, on_wire=on_wire, on_tier=on_tier,
                tracer=tracer,
                next_tier=tier[peers[nxt]["cross_rank"] != topo.cross_rank],
                prev_tier=tier[peers[prv]["cross_rank"] != topo.cross_rank])
            ok = True
    except Exception as e:  # noqa: BLE001
        log("warning",
            f"peer data plane unavailable on rank {rank} ({e}); "
            "falling back to the star relay")
        ok = False
    active = client.ring_confirm(ok) if world > 1 else False
    # Unused listeners (the flat one under a hier verdict, or everything on
    # failure/fallback) must not leak.
    for li in listeners.values():
        try:
            li.close()
        except OSError:
            pass
    if active and plane is not None:
        return plane
    if plane is not None:
        plane.close()
    return None


# ------------------------------------------------------------------ engine

_OPS = ("allreduce", "allgather", "broadcast", "alltoall", "reducescatter")


class StoreRendezvous(NamedTuple):
    """Where the ranks of an ``init`` world meet the coordinator: rank 0
    binds ``host`` at a port the kernel picks and sets ``key`` in
    ``store`` to ``host:port``; every rank reads it there."""

    store: Any
    key: str
    host: str


class PyEngine:
    """Python reference implementation of the eager engine.

    ``rendezvous`` (a :class:`StoreRendezvous`) locates the coordinator
    through a store; without one, rank 0 binds ``HOROVOD_COORD_ADDR``.
    ``watchdog``, a running ``StallWatchdog`` (``init``'s), takes the
    engine's stall source and abort hook beside its own; without one the
    engine starts its own watchdog."""

    def __init__(self, topo: Topology, config: Config,
                 rendezvous: Optional[StoreRendezvous] = None,
                 watchdog: Optional[StallWatchdog] = None) -> None:
        self.topo = topo
        self.config = config
        if config.hierarchical_allgather:
            # The Python engine implements the hierarchical ALLREDUCE plane;
            # the two-stage allgather remains native-only — keep that
            # knob's no-op loud.
            log("warning",
                "HOROVOD_HIERARCHICAL_ALLGATHER is implemented by the "
                "native engine only; the Python engine runs flat "
                "allgathers (set HOROVOD_ENGINE=native to honor the knob)")
        self.handles = HandleManager()
        self._shutdown = threading.Event()
        self._wake = threading.Event()   # wake-on-enqueue (adaptive cycle)
        # HOROVOD_WAKE_ON_ENQUEUE=0 restores the fixed-cycle sleep
        # (debugging / tests that need an enqueue to stay unprocessed).
        self._wake_on_enqueue = os.environ.get(
            "HOROVOD_WAKE_ON_ENQUEUE", "1") != "0"
        self._idle_max_s = max(
            _env_float("HOROVOD_CYCLE_IDLE_MAX_MS", 100.0), 1.0) / 1000.0
        self._lock = threading.Lock()
        # name → (op, array, root, handle, enqueue_time); the tensor table
        # (reference operations.cc:121-127 tensor_table + message_queue).
        self._queue: list[dict] = []
        self._inflight: set[str] = set()  # duplicate-name guard
        self._timeline = None
        if config.timeline and topo.rank == 0:
            from ..utils.timeline import Timeline

            self._timeline = Timeline(config.timeline, mark_cycles=config.timeline_mark_cycles)
        self._coord: Optional[_Coordinator] = None
        self._client: Optional[_Client] = None
        self._ring: Optional[_PeerRing] = None
        # Transport-resilience ladder state (docs/eager-engine.md
        # "Graded failure escalation"): a ring/hier link fault no longer
        # latches a fatal error — the plane demotes to the star relay
        # mid-run, the faulted collective replays there, and a cooldown
        # probe (HOROVOD_PLANE_REPROMOTE_S) re-promotes once links hold.
        self._plane_key: bytes = b""
        self._plane_demote_seen = 0    # coordinator demote epoch applied
        self._plane_reprobe_seen = 0   # coordinator re-promotion epoch applied
        self._reestablish = False      # re-run plane establishment next cycle
        # Last few finished ring-plane allreduce results, keyed by name and
        # tagged with the directive's global seq: a link can die on the
        # FINAL allgather hop, completing the collective on some ranks but
        # not others — a survivor's retained copy answers the coordinator's
        # redo request so failed ranks receive the identical bits without
        # re-running anything. The seq tag matters: tensor NAMES recur
        # every step, so an untagged copy from a previous execution would
        # answer with stale bits (OrderedDict LRU, tiny).
        from collections import OrderedDict

        self._retained: "OrderedDict[str, tuple[int, np.ndarray]]" = \
            OrderedDict()
        self._retain_max = 16
        # Per-rank response-cache mirror (response_cache.py): follows the
        # coordinator's assign/evict announcements; capacity lives with the
        # coordinator authority.
        cache_cap = int(getattr(config, "cache_capacity", 0) or 0)
        self._mirror: Optional[CacheMirror] = (
            CacheMirror() if cache_cap > 0 else None)
        # On-the-wire compression (docs/compression.md): allreduce
        # contributions are quantized ONCE at enqueue (cast to the wire
        # dtype and back — the same value the wire will carry), the ring
        # hops and the star channel move 2-byte payloads, and accumulation
        # stays at the float64 _acc_start width. Error feedback keeps the
        # local quantization residual and folds it into the NEXT submission
        # of the same tensor name (Lin et al., Deep Gradient Compression).
        self._compression = getattr(config, "compression", "none") or "none"
        self._error_feedback = bool(
            getattr(config, "compression_error_feedback", False))
        self._residuals: dict[str, np.ndarray] = {}
        # Sparse top-k wire format + adaptive policy : 'topk' sparsifies allreduce contributions
        # once at enqueue (indices+values frames on the wire, un-sent mass
        # into the residuals above); 'adaptive' hands the per-tensor format
        # choice to common/policy.py's per-fabric-tier table.
        comp_name, ratio_override = parse_spec(self._compression)
        self._compression_name = comp_name
        self._topk_ratio = (ratio_override
                            or float(getattr(config, "topk_ratio", 0.0) or 0)
                            or topk_ratio_from_env())
        self._compression_min_bytes = int(
            getattr(config, "compression_min_bytes", 4096) or 4096)
        self._policy: Optional[CompressionPolicy] = (
            CompressionPolicy(config, topo) if comp_name == "adaptive"
            else None)
        self._policy_refresh_cycles = 0
        # Top-k without error feedback silently drops ~99% of the gradient
        # mass every step — a bias, not a compression (DGC's residual is
        # what makes it converge). EF therefore defaults ON for topk;
        # HOROVOD_COMPRESSION_ERROR_FEEDBACK=0 still disables it explicitly
        # (docs/troubleshooting.md "my gradients ship sparse but training
        # diverges").
        self._topk_error_feedback = (
            self._error_feedback
            or os.environ.get("HOROVOD_COMPRESSION_ERROR_FEEDBACK")
            in ("", None))
        # Live knob retuning: the runtime controller switches
        # value-affecting knobs (wire format, top-k ratio) mid-job through
        # the coordinator's knob epoch — the demote/re-promote safe-switch
        # of the plane ladder generalized from "plane" to "any knob". Enqueue reads
        # ONE snapshot dict (replaced wholesale under _lock, read as a
        # single reference), so a caller-thread submission can never see a
        # torn (epoch, format) pair; the entry's `ke` stamp tells the
        # coordinator which table formatted it.
        self._knob_epoch_seen = 0
        self._knobs: dict = {
            "epoch": 0,
            "compression": self._compression_name,
            "topk_ratio": self._topk_ratio,
            "policy": self._policy,
        }
        # Distributed tracing (docs/tracing.md): per-rank span
        # recorder + per-name submission counters — the counter makes the
        # trace ID (<name>#<seq>) deterministic AND identical across ranks
        # with zero wire bytes; the request `trace` field and ring-directive
        # echo verify that agreement on the wire.
        self._trace = _trace_init(
            getattr(config, "trace_dir", "") or "", topo.rank)
        self._trace_seq: dict[str, int] = {}
        # Telemetry.
        self._metrics = _metrics_registry()
        self._m_hits = self._metrics.counter(
            "horovod_engine_cache_hits_total",
            help="response-cache hits (negotiations sent as a cache bit)")
        self._m_misses = self._metrics.counter(
            "horovod_engine_cache_misses_total",
            help="response-cache misses (negotiations sent as full requests)")
        self._m_full = self._metrics.counter(
            "horovod_engine_full_requests_total",
            help="full request dicts shipped to the coordinator")
        self._m_ctrl = self._metrics.counter(
            "horovod_engine_control_bytes_total",
            help="exchange payload bytes excluding tensor data (the "
                 "bytes-per-tick negotiation cost)")
        self._m_exch = self._metrics.counter(
            "horovod_engine_exchanges_total",
            help="coordinator exchanges performed")
        self._m_knob_changes = self._metrics.counter(
            "horovod_knob_changes_total",
            help="live knob-table epochs applied by this rank "
                 "(runtime controller safe-switch)")
        self._m_star = self._metrics.counter(
            "horovod_engine_data_bytes_total",
            help="tensor bytes moved by the eager data plane", plane="star")
        self._m_ring = self._metrics.counter(
            "horovod_engine_data_bytes_total",
            help="tensor bytes moved by the eager data plane", plane="ring")
        self._m_wire = self._metrics.counter(
            "horovod_wire_bytes_total",
            help="gradient payload bytes moved at the compressed wire dtype",
            plane="eager")
        self._m_wire_saved = self._metrics.counter(
            "horovod_wire_bytes_saved_total",
            help="bytes the compressed wire avoided sending vs the "
                 "uncompressed plane", plane="eager")
        # Per-format savings: which compression method the bytes
        # were saved BY — 'bf16'/'fp16' casts vs 'topk' sparse frames —
        # so the adaptive policy's win is attributable per method.
        self._m_saved_method: dict[str, Any] = {}
        # Per-fabric-tier wire accounting: every byte the eager
        # data plane puts on a link, billed to that link's fabric — local
        # (same host: shm/loopback) vs cross (the host boundary / DCN).
        # The 1/local_size cross-byte cut of the hierarchical plane shows
        # on exactly these series.
        self._m_tier = {
            t: self._metrics.counter(
                "horovod_wire_bytes_total",
                help="eager data-plane bytes sent per fabric tier "
                     "(local = same host, cross = host boundary)", tier=t)
            for t in ("local", "cross")}
        # Escalation-ladder telemetry: every rung is countable so
        # "my ring keeps demoting" is a metrics query, not a log dig
        # (docs/troubleshooting.md). horovod_transport_* live in
        # common/resilience.py; the plane rungs live here.
        self._m_demotions = self._metrics.counter(
            "horovod_plane_demotions_total",
            help="eager data-plane demotions to the star relay after a "
                 "peer-link fault (rung 2 of the escalation ladder)")
        self._m_repromotions = self._metrics.counter(
            "horovod_plane_repromotions_total",
            help="successful ring/hier re-promotions after the "
                 "HOROVOD_PLANE_REPROMOTE_S cooldown")
        self._m_plane = self._metrics.gauge(
            "horovod_plane_current",
            help="active eager data plane: 0 = star relay, 1 = flat peer "
                 "ring, 2 = hierarchical two-level")
        if topo.size > 1:
            addr = os.environ.get("HOROVOD_COORD_ADDR")
            if rendezvous is None and not addr:
                raise HorovodInternalError(
                    "multi-process eager collectives need the world of "
                    "init() (its store carries the coordinator's address) "
                    "or HOROVOD_COORD_ADDR (set by the launcher)"
                )
            key = _secret_from_env()
            if not key:
                raise HorovodInternalError(
                    "the Python eager engine authenticates its coordinator "
                    "channel with HOROVOD_SECRET, which is unset; launch "
                    "through the horovod_tpu_torch runner (which "
                    "distributes it) or export the same secret on every rank"
                )
            if rendezvous is not None:
                host, port = self._coordinator_via_store(
                    rendezvous, key, cache_cap)
            else:
                host, port = addr.rsplit(":", 1)
                port = int(port)
                if topo.rank == 0:
                    self._coord = _Coordinator(topo.size, host, port,
                                               key=key,
                                               cache_capacity=cache_cap)
                    self._coord.start()
            self._client = _Client(host, port, topo.rank, key=key,
                                   local=getattr(topo, "local_size", 1))
            # Clock alignment for the trace (tracing/clock.py): estimate
            # this rank's monotonic-clock offset to the coordinator over the
            # control channel BEFORE any spans matter. Rank 0 IS the
            # reference clock (offset 0). Never fatal: tracing degrades to
            # per-host alignment if the probe fails.
            if self._trace is not None and topo.rank != 0:
                try:
                    offset, err_ns = _estimate_offset_ns(
                        self._client.clock_probe)
                    self._trace.set_clock_offset(offset)
                    log("debug",
                        f"trace clock offset {offset} ns "
                        f"(+/- {err_ns} ns) vs coordinator", rank=topo.rank)
                except Exception as e:  # noqa: BLE001
                    log("warning",
                        f"trace clock probe failed ({e}); spans stay on "
                        "the local clock", rank=topo.rank)
            # Data plane: worlds of 3+ only (a 2-world ring IS the star
            # shape), every rank must agree (establish_data_plane runs the
            # hello + confirm barriers and returns None when any rank fell
            # back). On a multi-host grid with the knob set, the flat peer
            # ring is replaced by the two-level hierarchical plane. The key
            # is kept: the re-promotion probe rebuilds the plane with it
            # after a demotion cooldown.
            self._plane_key = key
            self._establish_plane()
        # Stall watchdog: keeps reporting even when the loop is
        # wedged inside a blocking exchange, names missing ranks on the
        # coordinator rank, and can escalate (HOROVOD_STALL_SHUTDOWN_TIME)
        # by failing the stalled collective.
        self._watchdog: Optional[StallWatchdog] = None
        self._shared_watchdog: Optional[StallWatchdog] = None
        if watchdog is not None:
            # init's watchdog already scans the NCCL/gloo collectives in
            # flight: the engine's queue joins it as one more source, with
            # its own abort hook, so neither registration displaces the
            # other and one gauge counts both.
            self._shared_watchdog = watchdog
            watchdog.add_source(self._watch_source(),
                                on_abort=self._abort_stalled)
        elif not config.stall_check_disable:
            stall_s = getattr(config, "stall_warning_s", STALL_WARNING_TIME_S)
            self._watchdog = StallWatchdog(
                check_time_s=stall_s,
                shutdown_time_s=getattr(config, "stall_shutdown_s", 0.0),
                rank=topo.rank,
                on_abort=self._abort_stalled,
            )
            self._watchdog.add_source(self._watch_source())
        self._thread = threading.Thread(
            target=self._loop, name="horovod_tpu_engine", daemon=True
        )
        self._thread.start()

    def _coordinator_via_store(self, rv: StoreRendezvous, key: bytes,
                               cache_cap: int) -> tuple[str, int]:
        """Rank 0 starts the coordinator on a port the kernel picks and
        publishes ``host:port`` under ``rv.key``; every rank reads it."""
        if self.topo.rank == 0:
            self._coord = _Coordinator(self.topo.size, rv.host, 0, key=key,
                                       cache_capacity=cache_cap)
            self._coord.start()
            port = self._coord.server.getsockname()[1]
            rv.store.set(rv.key, f"{rv.host}:{port}")
        host, port = rv.store.get(rv.key).decode().rsplit(":", 1)
        return host, int(port)

    def _watch_source(self):
        """The stall source of this rank: the coordinator's pending table
        on rank 0 — it knows WHICH ranks are missing per tensor, and sees
        tensors this rank never submitted — else the local queue."""
        if self._coord is not None:
            return self._coord.stall_candidates
        return self._stall_source

    # -- public enqueue API (reference EnqueueTensorAllreduce/..., operations.cc:2472-2591)

    def enqueue(self, op: str, array: np.ndarray, name: Optional[str],
                root_rank: int = 0, average: bool = True) -> int:
        if op not in _OPS:
            raise ValueError(f"unknown op {op}")
        if self._shutdown.is_set():
            raise HorovodInternalError("Horovod has been shut down")
        if op == "allgather" and np.ndim(array) == 0:
            raise HorovodInternalError(
                "Allgather requires tensors of rank >= 1 (got a scalar)")
        handle = self.handles.allocate()
        if not name:
            # Auto-name by handle (reference GetOpName, mpi_ops_v2.cc:44-50):
            # handles increment identically across ranks when op order matches.
            name = f"{op}.noname.{handle}"
        arr = as_engine_array(array)
        tid = None
        if self._trace is not None:
            # Trace ID at first enqueue: the k-th submission of `name`. A
            # name completes before it may be reused (duplicate-name guard
            # below), and collective semantics mean every rank submits a
            # name the same number of times — so this counter agrees across
            # ranks without a handshake, cache ticks included.
            seq = self._trace_seq.get(name, 0) + 1
            self._trace_seq[name] = seq
            tid = _trace_id(name, seq)
        entry = {
            "op": op,
            "array": arr,
            "orig": arr,
            "name": name,
            "root": root_rank,
            "average": average,
            "handle": handle,
            "t": time.monotonic(),
            "wire": None,
            "wire_array": None,
            "wire_method": None,
            "sparse_tiers": None,
            "ke": 0,
            "res_claimed": None,
            "tid": tid,
        }
        # Wire-format resolution + quantization from ONE knob snapshot
        # : deterministic in (size, dtype, topology, table),
        # so every rank at the same knob epoch resolves the same format and
        # the coordinator's cross-rank wire validation holds.
        self._format_entry(entry, self._knobs)
        arr = entry["array"]
        with self._lock:
            if name in self._inflight:
                raise HorovodInternalError(
                    f"Duplicate tensor name {name}; a name may only be used "
                    "once until its collective completes"
                )
            self._inflight.add(name)
            self._queue.append(entry)
        # Wake the loop immediately: small eager ops must not pay a
        # half-cycle of sleep latency (the adaptive cycle).
        if self._wake_on_enqueue:
            self._wake.set()
        self._metrics.counter(
            "horovod_collectives_enqueued_total",
            help="collectives submitted to the eager engine", op=op).inc()
        if tid is not None:
            self._trace.point(tid, name, op, "enqueue",
                              bytes=int(arr.nbytes))
        if self._timeline:
            self._timeline.negotiate_start(name, op.upper(), tid=tid)
        return handle

    def poll(self, handle: int) -> bool:
        return self.handles.poll(handle)

    def synchronize(self, handle: int, timeout: Optional[float] = None) -> Any:
        return self.handles.wait_and_clear(handle, timeout)

    def run(self, op: str, array: np.ndarray, name: str, **kw) -> Any:
        return self.synchronize(self.enqueue(op, array, name, **kw))

    def timeline_start(self, path: str, mark_cycles: bool = False) -> int:
        """Scoped timeline attach (hvd.timeline.trace): returns 1 when this
        call opened the timeline (caller owns the stop), 0 when one is
        already configured or this rank doesn't write (rank 0 only)."""
        if self.topo.rank != 0 or self._timeline is not None:
            return 0
        from ..utils.timeline import Timeline

        self._timeline = Timeline(path, mark_cycles=mark_cycles)
        return 1

    def timeline_stop(self) -> None:
        if self._timeline is not None:
            self._timeline.close()
            self._timeline = None

    # -- response-cache surface (docs/eager-engine.md)

    def cache_stats(self) -> dict:
        """Live response-cache counters plus the data-plane verdict."""
        out = {
            "enabled": self._mirror is not None,
            "ring_active": self._ring is not None,
            # Which data plane carries allreduce bytes: the two-level
            # ladder, the flat peer ring, or the rank-0 star relay.
            "plane": ("hier" if isinstance(self._ring, _HierPlane)
                      else "ring" if self._ring is not None else "star"),
            "compression": self._compression,
            "topk_ratio": self._topk_ratio,
            # Adaptive per-tier policy report: the decision table
            # for a representative large gradient plus the live diagnosis —
            # what the sparse smoke asserts picks DIFFERENT formats for the
            # ICI vs DCN tiers.
            "policy": (self._policy.report()
                       if self._policy is not None else None),
            # `is not None`, not truthiness: CacheMirror defines __len__,
            # so a freshly-flushed (empty) mirror is falsy.
            "mirror": (self._mirror.stats()
                       if self._mirror is not None else None),
        }
        if self._coord is not None:
            out["authority"] = self._coord.cache_stats()
        return out

    def cache_flush(self) -> None:
        """Drop every cached negotiation (elastic reset / membership change:
        a stale cached response must never be servable). Safe to call on any
        subset of ranks — the coordinator re-announces assignments with
        every result delivery, so a flushed mirror self-heals. Error-feedback
        residuals drop too: they compensate THIS membership's quantization
        stream, and carrying them across an elastic reset would fold a dead
        world's error into the new one's first step."""
        if self._mirror is not None:
            self._mirror.flush()
        if self._coord is not None:
            self._coord.cache_flush()
        self._residuals.clear()
        # Retained ring results are this membership's bits: a new elastic
        # generation must never serve them as a redo answer.
        self._retained.clear()

    def _on_wire(self, wire_bytes: int, saved_bytes: int,
                 method: Optional[str] = None) -> None:
        """Wire telemetry fan-in for every data plane: the plane-wide
        totals plus (when the caller names its format) the method-labeled
        saved counter — horovod_wire_bytes_saved_total{method=...}."""
        self._m_wire.inc(wire_bytes)
        self._m_wire_saved.inc(saved_bytes)
        if method:
            ctr = self._m_saved_method.get(method)
            if ctr is None:
                ctr = self._metrics.counter(
                    "horovod_wire_bytes_saved_total",
                    help="bytes avoided per compression method "
                         "(bf16/fp16 casts vs topk sparse frames)",
                    method=method)
                self._m_saved_method[method] = ctr
            ctr.inc(saved_bytes)

    # -- live knob retuning -------------------------------------

    def _format_entry(self, e: dict, ks: dict) -> None:
        """Resolve and apply the wire format of one entry under the knob
        snapshot ``ks`` — the single formatting point for first enqueue AND
        the knob-epoch reformat path. Claims the error-feedback residual
        (the pop makes the claim literal) and remembers it in
        ``res_claimed`` so :meth:`_unformat_entry` can put it back."""
        op, name = e["op"], e["name"]
        arr = e["orig"]
        fmt = "none"
        if op == "allreduce":
            pol = ks["policy"]
            fmt = (pol.resolve(int(arr.nbytes), arr.dtype)
                   if pol is not None else ks["compression"])
        wire_tag = None      # request['wire']: a numpy dtype or "topk"
        wire_np = None
        wire_arr = None
        wire_method = None
        sparse_tiers = None
        res_claimed = None
        if fmt == "topk" and not topk_eligible(
                arr.dtype, int(arr.nbytes), ks["topk_ratio"],
                self._compression_min_bytes):
            fmt = "none"  # non-f32 / below the floor: ship dense
        if fmt == "topk":
            # Claim the residual HERE, before the select — the redo path
            # after a plane demotion replays the already-sparsified
            # contribution (e['array']/e['wire_array']) and must never fold
            # the residual a second time (the pop makes the claim literal).
            ef = self._topk_error_feedback
            res = self._residuals.pop(name, None) if ef else None
            res_claimed = res
            if (res is not None and res.shape == arr.shape
                    and res.dtype == arr.dtype):
                arr = arr + res
            flat = np.ascontiguousarray(arr).ravel()
            k = topk_k(flat.size, ks["topk_ratio"])
            t_idx, t_val = topk_select(flat, k)
            dense = topk_densify(t_idx, t_val, flat.size).reshape(arr.shape)
            if ef:
                # The un-sent mass: everything the selection dropped plus
                # nothing else (selected values ship exactly), carried into
                # the NEXT submission of this name (DGC).
                self._residuals[name] = arr - dense
            arr = dense
            wire_tag = "topk"
            wire_method = "topk"
            # Star uploads ship the packed sparse frame of the whole tensor.
            wire_arr = topk_pack(t_idx, t_val)
            sparse_tiers = (ks["policy"].sparse_tiers()
                            if ks["policy"] is not None else None)
        elif fmt in ("fp16", "bf16"):
            wire_np = numpy_wire_dtype(fmt, arr.dtype)
        if wire_np is not None:
            res = (self._residuals.pop(name, None)
                   if self._error_feedback else None)
            res_claimed = res
            if (res is not None and res.shape == arr.shape
                    and res.dtype == arr.dtype):
                arr = arr + res
            # Quantize the contribution once, here: both data planes then
            # move/reduce the exact wire-representable value, which is what
            # keeps star==ring and cold==cached bitwise under compression.
            wire_arr = cast(np.ascontiguousarray(arr), wire_np)
            deq = cast(wire_arr, arr.dtype)
            if self._error_feedback:
                self._residuals[name] = arr - deq
            arr = deq
            wire_tag = wire_np
            wire_method = fmt
        e["array"] = arr if fmt != "none" else e["orig"]
        e["wire"] = wire_tag
        e["wire_array"] = wire_arr
        e["wire_method"] = wire_method
        e["sparse_tiers"] = sparse_tiers
        e["ke"] = int(ks["epoch"])
        e["res_claimed"] = res_claimed

    def _unformat_entry(self, e: dict) -> None:
        """Undo :meth:`_format_entry`'s error-feedback side effects so the
        entry can be re-formatted under a NEW knob table. Safe because the
        duplicate-name guard means nothing else touched this name's
        residual slot since the entry was formatted."""
        if e.get("wire") is not None:
            self._residuals.pop(e["name"], None)
            if e.get("res_claimed") is not None:
                self._residuals[e["name"]] = e["res_claimed"]
        e["res_claimed"] = None

    def _apply_knob_table(self, table: dict, epoch: int) -> None:
        """Adopt a committed knob table (engine-side knobs only: wire
        compression + top-k ratio; unknown keys belong to other layers and
        are ignored here). Replaces the enqueue snapshot atomically."""
        comp = table.get("compression")
        ratio = table.get("topk_ratio")
        if comp is not None:
            name, ratio_override = parse_spec(str(comp))
            if ratio_override:
                ratio = ratio_override
            self._compression = str(comp)
            self._compression_name = name
            self._policy = (CompressionPolicy(self.config, self.topo)
                            if name == "adaptive" else None)
        if ratio is not None:
            self._topk_ratio = float(ratio)
        self._knobs = {
            "epoch": int(epoch),
            "compression": self._compression_name,
            "topk_ratio": self._topk_ratio,
            "policy": self._policy,
        }
        self._m_knob_changes.inc()
        log("info",
            f"knob epoch {epoch} applied on rank {self.topo.rank}: "
            f"{ {k: v for k, v in table.items()} }")
        try:
            from ..tracing import flight as _flight

            _flight.get_flight().event(
                "knob_apply", rank=self.topo.rank, epoch=int(epoch),
                table={k: str(v) for k, v in table.items()})
        except Exception:  # noqa: BLE001 - telemetry never blocks the switch
            pass

    def set_knobs(self, table: dict) -> int:
        """Commit a value-affecting knob change to the WHOLE world.
        Multi-process: the coordinator bumps its knob epoch, demotes
        the data plane for one safe-switch cycle (in-flight collectives
        replay bitwise through the plane ladder's redo machinery with their
        already-formatted bytes), and every rank adopts the table
        atomically from its next exchange response. Single-process: applied
        immediately. Returns the committed epoch."""
        if self.topo.size == 1 or self._client is None:
            epoch = self._knob_epoch_seen + 1
            self._knob_epoch_seen = epoch
            self._apply_knob_table(dict(table), epoch)
            return epoch
        return self._client.knob_change(dict(table))

    def knob_epoch(self) -> int:
        """The knob epoch this rank has applied (0 = launch table)."""
        return self._knob_epoch_seen

    def _apply_knob_signals(self) -> None:
        """Consume the coordinator's knob epoch + reformat signals from the
        last exchange response. Runs on the engine thread AFTER the plane
        signals (so recalled entries are already redo-marked and keep their
        old-format bytes) and BEFORE the next submission cycle."""
        knob = self._client.last_knob
        if knob:
            epoch = int(knob.get("epoch", 0))
            if epoch > self._knob_epoch_seen:
                self._knob_epoch_seen = epoch
                self._apply_knob_table(dict(knob.get("table") or {}), epoch)
                # Proactively re-format queued entries that have not been
                # negotiated yet: they would only be bounced with a
                # `reformat` answer next tick. Ring-directive redo replays
                # (real seq) keep their already-formatted bytes — the
                # interrupted collective replays bitwise under the OLD
                # table by design — but recalled star pendings (sentinel
                # seq -1) re-enter a fresh re-reduce and switch to the new
                # table like everything else.
                sentinel = {nm for nm, seq in self._client.last_redo
                            if int(seq) == -1}
                with self._lock:
                    stale = [e for e in self._queue
                             if e["op"] == "allreduce"
                             and int(e.get("ke", 0)) != epoch
                             and (e["name"] in sentinel
                                  or (not e.get("redo")
                                      and not e.get("sent")))]
                for e in stale:
                    self._unformat_entry(e)
                    self._format_entry(e, self._knobs)
                    if e["name"] in sentinel:
                        e["sent"] = False
        for nm in self._client.last_reformat:
            # The coordinator refused this rank's stale-epoch contribution;
            # re-format it under the table that rode the same response and
            # re-submit with bytes. (Only sentinel-recalled redos can be
            # bounced — ring-directive redos are exempt — so reformatting a
            # redo-marked entry here is always the fresh-re-reduce case.)
            with self._lock:
                entry = next((e for e in self._queue if e["name"] == nm),
                             None)
            if entry is not None:
                self._unformat_entry(entry)
                self._format_entry(entry, self._knobs)
                entry["sent"] = False

    # -- transport-resilience ladder -----------------------------

    def _establish_plane(self) -> None:
        """(Re)build the eager data plane through the coordinator's
        hello/confirm barriers and publish the verdict to the plane gauge.
        Used at init and by the re-promotion probe."""
        self._ring = establish_data_plane(
            self._client, self.topo, self._plane_key, self.config,
            on_bytes=self._m_ring.inc,
            on_wire=self._on_wire,
            on_tier=lambda n, t: self._m_tier[t].inc(n),
            tracer=self._trace)
        self._m_plane.set(2 if isinstance(self._ring, _HierPlane)
                          else 1 if self._ring is not None else 0)

    def _demote_plane(self, reason: str, name: str = "") -> None:
        """Rung 2: tear this rank's peer plane down and fall back to the
        star relay (which relays through the coordinator and needs no peer
        links). Idempotent; never raises — demotion is the recovery path
        and must not become a second failure."""
        plane, self._ring = self._ring, None
        if plane is None:
            return
        self._m_demotions.inc()
        self._m_plane.set(0)
        log("warning",
            f"eager data plane demoted to star on rank {self.topo.rank}"
            f"{f' (collective {name})' if name else ''}: {reason}")
        if self._trace is not None:
            # The fault span names the flaky link in the merged trace: the
            # reason string carries the underlying errno/timeout text.
            t = self._trace.now_ns()
            self._trace.span("plane#demote", name or "plane", "allreduce",
                             "plane_demote", t, t, reason=str(reason)[:200])
        try:
            # Flight-recorder escalation: a demotion is one of
            # the dump triggers — the ring holds the spans and metric
            # deltas of the seconds before the link went bad.
            from ..tracing import flight as _flight

            fl = _flight.get_flight()
            fl.event("plane_demote", rank=self.topo.rank,
                     collective=name, reason=str(reason)[:200])
            fl.dump(f"plane-demote-rank{self.topo.rank}")
        except Exception:  # noqa: BLE001 - telemetry never blocks recovery
            pass
        try:
            plane.close()
        except Exception:  # noqa: BLE001 - teardown of a broken plane
            pass

    def _report_plane_fault(self, names: list, reason: str) -> None:
        """Tell the coordinator about a link fault and the collectives this
        rank must replay — it demotes the whole world (all-or-nothing, like
        establishment) and opens a redo negotiation per name."""
        if self._client is None:
            return
        try:
            self._client.plane_fault(names, str(reason))
        except Exception as e:  # noqa: BLE001
            # Control channel down too: the next exchange raises the real
            # HorovodInternalError (rung 3 — elastic reset).
            log("warning", f"plane fault report failed: {e}")

    def _requeue_redo(self, e: dict) -> None:
        """Replay a failed/recalled collective through the star plane: a
        fresh negotiation that bypasses the cache bit and re-ships the
        bytes (the coordinator holds none for ring-plane entries)."""
        e["sent"] = False
        e["redo"] = True
        with self._lock:
            self._queue.append(e)

    def _redo_inflight(self) -> None:
        """After a demotion signal: entries already negotiated metadata-only
        under the ring (bytes never shipped) must renegotiate with bytes."""
        with self._lock:
            for e in self._queue:
                if e["op"] == "allreduce" and e.get("sent"):
                    e["sent"] = False
                    e["redo"] = True

    def _retain(self, name: str, seq: int, out: np.ndarray) -> None:
        self._retained[name] = (seq, out)
        self._retained.move_to_end(name)
        while len(self._retained) > self._retain_max:
            self._retained.popitem(last=False)

    def _apply_plane_signals(self) -> None:
        """Consume the coordinator's demote/re-promote epochs piggybacked on
        the last exchange response (one int compare each in the common
        case)."""
        plane = self._client.last_plane
        if not plane:
            return
        demote = int(plane.get("demote", 0))
        if demote > self._plane_demote_seen:
            self._plane_demote_seen = demote
            if self._ring is not None:
                self._demote_plane(
                    "coordinator demoted the world (link fault on a peer)")
            self._redo_inflight()
        reprobe = int(plane.get("reprobe", 0))
        if reprobe > self._plane_reprobe_seen:
            self._plane_reprobe_seen = reprobe
            self._reestablish = True
            self._wake.set()

    def _try_repromote(self) -> None:
        """Cooldown probe: rebuild peer links and return to ring/hier. All
        ranks enter the same hello/confirm barriers, so re-promotion is
        all-or-nothing exactly like initial establishment; on failure every
        rank stays on the star and the coordinator re-arms the cooldown."""
        if self._shutdown.is_set() or self._client is None:
            return
        try:
            self._establish_plane()
        except Exception as e:  # noqa: BLE001
            log("warning", f"plane re-promotion attempt failed: {e}")
            self._ring = None
            self._m_plane.set(0)
        if self._ring is not None:
            self._m_repromotions.inc()
            log("info",
                f"eager data plane re-promoted to "
                f"{'hier' if isinstance(self._ring, _HierPlane) else 'ring'}"
                f" on rank {self.topo.rank} after cooldown")

    def shutdown(self) -> None:
        self._shutdown.set()
        self._wake.set()
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self._shared_watchdog is not None:
            self._shared_watchdog.remove_source(self._watch_source())
            self._shared_watchdog = None
        self._thread.join(timeout=5)
        self.cache_flush()
        if self._ring:
            self._ring.close()
        if self._client:
            self._client.close()
        if self._coord:
            self._coord.stop()
        if self._timeline:
            self._timeline.close()
        if self._trace is not None:
            # Flush, don't close: the process recorder is shared (a new
            # engine after elastic reset re-points it; basics.shutdown owns
            # the close) and the smoke harness reads the file right after.
            self._trace.flush()
        # Fail outstanding callbacks (reference SHUT_DOWN_ERROR, operations.cc:263-268)
        with self._lock:
            for e in self._queue:
                self.handles.mark_done(
                    e["handle"], HorovodInternalError("Horovod has been shut down"), None
                )
            self._queue.clear()
            self._inflight.clear()

    # -- background loop (reference RunLoopOnce, operations.cc:2030-2380)

    def _loop(self) -> None:
        # Stall detection moved to the StallWatchdog thread (metrics/
        # watchdog.py): it keeps scanning even while this loop is blocked
        # inside an exchange, which the old inline check never could.
        cycles = self._metrics.counter(
            "horovod_engine_cycles_total",
            help="eager-engine negotiation cycles")
        idle = 0
        while not self._shutdown.is_set():
            base = self.config.cycle_time_ms / 1000.0
            # Adaptive cycle: wake instantly on enqueue; with work in
            # flight tick at the configured cycle time; when idle, back off
            # exponentially (capped) so idle workers stop spinning.
            timeout = (min(base * (1 << min(idle, 6)), self._idle_max_s)
                       if idle and self._wake_on_enqueue else base)
            self._wake.wait(timeout)
            self._wake.clear()
            if self._shutdown.is_set():
                break
            cycles.inc()
            if self._reestablish:
                # Re-promotion probe: runs between batches, when
                # no ring directive is in flight on this rank. The
                # coordinator barriers line every rank up.
                self._reestablish = False
                self._try_repromote()
            if self._policy is not None:
                # Adaptive-policy refresh: re-read the per-tier
                # wire telemetry every ~64 cycles. Only steers the
                # VALUE-NEUTRAL sparse-vs-dense hop framing, so ranks may
                # refresh at different moments without desyncing results.
                self._policy_refresh_cycles += 1
                if self._policy_refresh_cycles >= 64:
                    self._policy_refresh_cycles = 0
                    try:
                        self._policy.refresh(self._metrics.snapshot())
                    except Exception:  # noqa: BLE001 - advisory only
                        pass
            if self._timeline:
                self._timeline.mark_cycle()
            with self._lock:
                batch = self._queue
                self._queue = []
            if not batch:
                idle += 1
                continue
            idle = 0
            if self.topo.size == 1:
                for e in batch:
                    self._complete_local(e)
            else:
                self._negotiate_and_execute(batch)

    def _finish(self, e: dict, error, result) -> None:
        with self._lock:
            self._inflight.discard(e["name"])
        op = e["op"]
        if self._trace is not None and e.get("tid"):
            # Central completion point = central trace point: every path
            # (local, star, ring, error) lands here exactly once.
            self._trace.point(e["tid"], e["name"], op, "done",
                              ok=error is None,
                              total_s=round(time.monotonic() - e["t"], 6))
        if error is None:
            self._metrics.counter(
                "horovod_collectives_total",
                help="collectives completed by the eager engine", op=op).inc()
            self._metrics.counter(
                "horovod_collective_bytes_total",
                help="tensor bytes processed by completed collectives",
                op=op).inc(int(e["array"].nbytes))
            self._metrics.histogram(
                "horovod_collective_size_bytes",
                help="per-collective tensor sizes",
                buckets=DEFAULT_BYTE_BUCKETS, op=op,
            ).observe(int(e["array"].nbytes))
            self._metrics.histogram(
                "horovod_collective_seconds",
                help="enqueue-to-completion wall time (negotiation + "
                     "execution + relay)", op=op,
            ).observe(time.monotonic() - e["t"])
        else:
            self._metrics.counter(
                "horovod_collective_errors_total",
                help="collectives finished with an error", op=op).inc()
        self.handles.mark_done(e["handle"], error, result)

    def _complete_local(self, e: dict) -> None:
        # Single-process world: every collective is the identity — the
        # average of one, the gather of one, the broadcast from self, and
        # the scatter of the whole array to the only rank.
        name, arr = e["name"], e["array"]
        if self._timeline:
            self._timeline.start(name, e["op"].upper(), tid=e.get("tid"))
            self._timeline.end(name)
        self._finish(e, None, arr)

    def _entry_key(self, e: dict) -> tuple:
        # The trailing element is the wire dtype ('' = uncompressed), so
        # cache bits distinguish compressed from uncompressed negotiations
        # and a wire-dtype change invalidates the stale bit like a shape
        # change would (response_cache.request_key mirrors this).
        return (e["name"], e["op"], tuple(e["array"].shape),
                dtype_name(e["array"].dtype), e["root"], bool(e["average"]),
                _wire_tag(e.get("wire")))

    def _rides_ring(self, e: dict) -> bool:
        return self._ring is not None and e["op"] == "allreduce"

    def _negotiate_and_execute(self, batch: list[dict]) -> None:
        # Workers ship their request list to the coordinator (MPI_Gatherv
        # analog); the coordinator matches by name across ranks, validates,
        # and answers. Star-plane ops carry their bytes on this channel and
        # get values back; ring-plane allreduces are METADATA-ONLY here and
        # get an ordered execution directive instead — the bytes move
        # between ring neighbours. Cached signatures ride as bits in one
        # small bitvector instead of full request dicts.
        requests: list[dict] = []
        bits = 0
        arrays: dict[str, np.ndarray] = {}
        for e in batch:
            first = not e.get("sent")
            if first and not self._rides_ring(e):
                # First contribution ships the bytes; re-polls of a name
                # whose bytes the coordinator already holds are
                # metadata-only (otherwise every cycle spent waiting on a
                # straggling PEER would re-ship this rank's full tensor).
                # Compressed allreduces ship the 2-byte wire cast — the
                # coordinator upcasts losslessly (the contribution was
                # quantized at enqueue, so the wire cast is exact).
                if e.get("wire_array") is not None:
                    arrays[e["name"]] = e["wire_array"]
                    self._on_wire(
                        int(e["wire_array"].nbytes),
                        int(e["array"].nbytes - e["wire_array"].nbytes),
                        e.get("wire_method"))
                else:
                    arrays[e["name"]] = e["array"]
            bit = None
            if self._mirror is not None and not e.get("redo"):
                # Redo entries (plane demotion replay) bypass the cache bit:
                # the coordinator needs the full request WITH bytes, and a
                # replay must not skew the steady-state hit-rate stats.
                key = self._entry_key(e)
                if first:
                    bit = self._mirror.lookup(key)
                    (self._m_hits if bit is not None else self._m_misses).inc()
                else:
                    bit = self._mirror.peek(key)  # re-poll: no stats
            e["cached"] = bit is not None
            if bit is not None:
                bits |= 1 << bit
            else:
                req = {
                    "name": e["name"], "op": e["op"],
                    "shape": tuple(e["array"].shape),
                    "dtype": dtype_name(e["array"].dtype), "root": e["root"],
                    "average": e["average"],
                }
                if e.get("wire") is not None:
                    req["wire"] = _wire_tag(e["wire"])
                if e.get("tid") is not None:
                    # Wire propagation of the trace ID (full requests only —
                    # cached ticks carry no per-tensor fields by design; the
                    # coordinator re-derives the ID from its own counter and
                    # uses this tag to VERIFY cross-rank agreement).
                    req["trace"] = e["tid"]
                if e["op"] == "allreduce" and e.get("ke"):
                    # Knob-epoch stamp: tells the coordinator
                    # which knob table formatted this contribution, so a
                    # mid-run retune bounces stale-format uploads into a
                    # reformat instead of a hard wire-mismatch error.
                    req["ke"] = int(e["ke"])
                requests.append(req)
                self._m_full.inc()
        # Redo answers: a link that died on a collective's FINAL
        # allgather hop completed it here but not everywhere — the
        # coordinator asked for our retained copy on the last response; ship
        # it so the failed ranks get the identical bits. Only a copy whose
        # directive seq MATCHES the recalled execution answers — the same
        # tensor name recurs every step, and a previous step's bits must
        # never close this step's redo.
        redo_payload = {}
        for nm, want_seq in self._client.last_redo:
            held = self._retained.get(nm)
            if held is not None and held[0] == want_seq:
                redo_payload[nm] = held
        redo_payload = redo_payload or None
        neg_t0 = (self._trace.now_ns() if self._trace is not None else 0)
        try:
            results = self._client.exchange(requests, arrays, bits=bits,
                                            redo_results=redo_payload)
        except Exception as exc:
            # Rung 3: the control channel itself failed — nothing below a
            # full reset can heal that (the coordinator is the recovery
            # path). HorovodInternalError feeds hvd.elastic.run.
            for e in batch:
                self._finish(e, HorovodInternalError(str(exc)), None)
            return
        if self._trace is not None:
            # One negotiate span per in-flight entry per tick: cached ticks
            # classify as "cache", full-request ticks as "negotiation" in
            # the critical-path analyzer. Re-polled entries accrue one span
            # per tick, which is exactly the time they spent negotiating.
            neg_t1 = self._trace.now_ns()
            for e in batch:
                if e.get("tid"):
                    self._trace.span(
                        e["tid"], e["name"], e["op"], "negotiate",
                        neg_t0, neg_t1, cached=bool(e.get("cached")))
        self._m_exch.inc()
        data_bytes = sum(int(a.nbytes) for a in arrays.values())
        self._m_star.inc(data_bytes)
        self._m_ctrl.inc(max(0, self._client.last_sent_bytes - data_bytes))
        if self._mirror is not None:
            assign, evict = self._client.last_cache
            self._mirror.apply(assign, evict)
        directives: list[tuple[int, dict, dict]] = []
        for e in batch:
            name = e["name"]
            res = results.get(name)
            if res is None:
                # not globally ready this tick: re-poll next cycle
                e["sent"] = True
                with self._lock:
                    self._queue.append(e)
                continue
            err, value = res
            if err is not None:
                # Rung 3 errors (dead rank) must surface as the reset-worthy
                # exception class — hvd.elastic.run catches
                # HorovodInternalError, not validation mismatches.
                self._finish(e, HorovodInternalError(err)
                             if err.startswith(_FATAL)
                             else TensorShapeMismatchError(err), None)
            elif isinstance(value, dict) and "__ring__" in value:
                directives.append((value["seq"], e, value))
            elif isinstance(value, dict) and "__wire__" in value:
                # Compressed star result: the coordinator ships the reduced
                # value at wire width (lossless — the canonical reduction
                # ends with a wire-dtype rounding); upcast to the original.
                # Sparse results (fmt 'topk') arrive as a packed frame and
                # densify back to the tensor's shape — the frame's f32
                # values ARE the canonical fold's bits.
                w = value["__wire__"]
                if value.get("fmt") == "topk":
                    shape = tuple(value["shape"])
                    n = int(np.prod(shape)) if shape else 1
                    st = topk_unpack(w, n)
                    out_arr = topk_state_dense(st, n).reshape(shape).astype(
                        np_dtype(value["dtype"]), copy=False)
                else:
                    out_arr = cast(w, np_dtype(value["dtype"]))
                self._m_star.inc(int(w.nbytes))
                self._on_wire(int(w.nbytes),
                              max(0, int(out_arr.nbytes - w.nbytes)),
                              e.get("wire_method"))
                self._finish(e, None, out_arr)
            else:
                if isinstance(value, np.ndarray):
                    self._m_star.inc(int(value.nbytes))
                self._finish(e, None, value)
        # Demote/re-promote signals piggybacked on the response — applied
        # AFTER unfinished entries re-joined the queue (so the redo marking
        # sees them) and BEFORE directives execute (so a recalled plane is
        # not used).
        self._apply_plane_signals()
        # Knob signals AFTER plane signals: a knob epoch demotes the plane,
        # and the redo marking above must run first so interrupted
        # collectives keep their already-formatted (old-table) bytes.
        self._apply_knob_signals()
        # Ring execution in global sequence order: the coordinator stamps
        # each ready allreduce with a monotonic seq, and every rank executes
        # them in that order, so the neighbour exchanges pair up.
        #
        # Escalation ladder on a hop failure: a broken ring has no
        # resync point (peer streams may be mid-message), but it no longer
        # takes the job down — this rank demotes to the star relay, reports
        # the fault, and REPLAYS the failed collective (and every later
        # directive of this batch) through a fresh star negotiation. The
        # canonical _ring_order_reduce keeps the replayed bits identical to
        # what the ring would have produced, so ranks that finished before
        # the link died and ranks that replay agree bitwise.
        fault_names: list[str] = []
        fault_reason = ""
        for _seq, e, d in sorted(directives, key=lambda t: t[0]):
            if self._ring is None:
                fault_names.append(e["name"])
                self._requeue_redo(e)
                continue
            if self._trace is not None and e.get("tid"):
                # Directive echo check: the coordinator's independently
                # derived ID must match ours — a mismatch means the
                # deterministic-counter contract broke somewhere.
                echo = d.get("trace")
                if echo is not None and echo != e["tid"]:
                    log("warning",
                        f"trace id mismatch for {e['name']}: local "
                        f"{e['tid']} vs coordinator {echo}")
                self._ring.trace_ctx = {
                    "tid": e["tid"], "name": e["name"],
                    "fmt": (e.get("wire_method")
                            or ("" if e.get("wire") is None
                                else _wire_method(e["wire"])))}
            try:
                out = self._ring.allreduce(e["array"], bool(d["average"]),
                                           wire_dtype=e.get("wire"),
                                           sparse_tiers=e.get("sparse_tiers"))
            except Exception as exc:  # noqa: BLE001
                fault_reason = f"{type(exc).__name__}: {exc}"
                self._demote_plane(fault_reason, name=e["name"])
                fault_names.append(e["name"])
                self._requeue_redo(e)
            else:
                self._retain(e["name"], int(d["seq"]), out)
                self._finish(e, None, out)
            finally:
                if self._ring is not None:
                    self._ring.trace_ctx = None
        if fault_names:
            self._report_plane_fault(
                fault_names, fault_reason or "ring directive recalled after "
                "world demotion")

    def _stall_source(self) -> list:
        """Watchdog view of this rank's in-flight queue (reference
        CheckForStalledTensors, operations.cc:1625-1672; non-coordinator
        ranks can't know WHICH ranks are missing — the coordinator source
        fills that in on rank 0)."""
        now = time.monotonic()
        with self._lock:
            return [StallInfo(name=e["name"], op=e["op"], age_s=now - e["t"])
                    for e in self._queue]

    def _abort_stalled(self, info: StallInfo) -> bool:
        """HOROVOD_STALL_SHUTDOWN_TIME escalation: fail the stalled
        collective with an error naming the missing ranks, so the training
        loop raises instead of hanging forever. Returns False (retry next
        scan) when the entry is momentarily checked out of the queue by an
        in-flight exchange."""
        with self._lock:
            entry = next((e for e in self._queue if e["name"] == info.name),
                         None)
            if entry is not None:
                self._queue.remove(entry)
        if entry is None:
            return info.name not in self._inflight
        missing = (f" (missing ranks: "
                   f"{', '.join(str(r) for r in info.missing_ranks)})"
                   if info.missing_ranks else "")
        self._finish(entry, HorovodInternalError(
            f"collective {info.name} stalled for {info.age_s:.1f}s, past "
            f"HOROVOD_STALL_SHUTDOWN_TIME="
            f"{getattr(self.config, 'stall_shutdown_s', 0.0):g}s{missing}"),
            None)
        return True


# ------------------------------------------------------- multi-process plumbing

class _Coordinator:
    """Rank-0 TCP coordinator: collects per-tick request lists (or cache
    bitvectors) + star-plane data from all ranks, matches by name, validates
    cross-rank consistency, computes star results or stamps ring execution
    directives, and returns them. Plays the reference's coordinator role
    (IncrementTensorCount/ConstructResponse, operations.cc:287-523) plus its
    response-cache authority (response_cache.cc)."""

    def __init__(self, world: int, host: str, port: int,
                 key: bytes = b"", cache_capacity: Optional[int] = None) -> None:
        self.world = world
        self.key = key or _secret_from_env()
        if not self.key:
            raise HorovodInternalError(
                "coordinator requires a shared HOROVOD_SECRET key")
        # Brief bind retry (resilience.bind_with_retry): an elastic
        # re-rendezvous rebuilds the coordinator on the SAME address
        # moments after the previous generation's server closed —
        # lingering accepted sockets can hold the port for a beat
        # (EADDRINUSE despite SO_REUSEADDR). A dead port stays dead past
        # the deadline and still raises.
        from .resilience import bind_with_retry

        self.server, _ = bind_with_retry(
            lambda p: socket.create_server(
                (host, p), backlog=world + 4, reuse_port=False),
            port, deadline_s=15.0)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # Control connections accepted: one per rank, or one per host
        # through the relays of the control tree.
        self.accepted = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # name → {rank: (request, array-or-None)}; the message_table
        self._pending: dict[str, dict[int, tuple[dict, Optional[np.ndarray]]]] = {}
        # name → monotonic time of first contribution (stall-watchdog ages)
        self._first_seen: dict[str, float] = {}
        self._results: dict[str, tuple[Optional[str], Any]] = {}
        self._claimed: dict[str, set[int]] = {}
        # --- response cache (authority half) ---
        self._cache = ResponseCache(capacity=cache_capacity)
        self._assigned: dict[str, tuple[int, tuple]] = {}  # name → (bit, key)
        # Evictions queued per rank, drained into that rank's next response;
        # tombstones keep an evicted bit resolvable until EVERY rank has
        # seen the eviction (a rank may have sent the bit before it landed).
        self._evict_q: dict[int, list[int]] = {r: [] for r in range(world)}
        self._tombstones: dict[int, tuple[tuple, dict, set]] = {}
        # --- ring data plane negotiation ---
        self.ring_active = False
        self._ring_endpoints: dict[int, Optional[dict]] = {}
        self._ring_plane: Optional[str] = None   # "flat" | "hier" verdict
        self._ring_votes: dict[int, bool] = {}
        self._ring_seq = 0
        # --- transport-resilience ladder ---
        # Demote/re-promote epochs piggybacked on every exchange response;
        # ranks apply them with one int compare. A plane_fault report from
        # any rank demotes the WHOLE world to the star relay (all ranks or
        # none, same invariant as establishment) and opens a redo
        # negotiation for each recalled/failed collective. After the
        # cooldown the reprobe epoch sends every rank back through the
        # hello/confirm barriers.
        self._demote_epoch = 0
        self._reprobe_epoch = 0
        self._grid: Optional[tuple] = None      # (L, C) when plane == hier
        # name -> seq of the latest ring directive issued under it: tensor
        # names recur every step, so a redo is identified by (name, seq)
        # and only a retained copy of THAT execution may answer it.
        self._directive_seq: dict[str, int] = {}
        self._redo_wanted: dict[str, int] = {}     # name -> directive seq
        self._redo_grid: dict[str, tuple] = {}
        # name -> (close time, directive seq) of recently delivered redo
        # answers: purge timer for retained-answer results, and duplicate
        # late reports about the SAME execution must not reopen the redo.
        self._redo_done: dict[str, tuple] = {}
        # name -> ranks that FINISHED the recalled execution (and so will
        # never re-poll it). A retained-answer result is pre-claimed for
        # them, or it would linger until the next same-NAME collective,
        # whose submissions would silently claim the stale bits (tensor
        # names recur every step — the claim bookkeeping must reach world
        # for the result to retire).
        self._redo_claim: dict[str, set] = {}
        self._repromote_s = _env_float("HOROVOD_PLANE_REPROMOTE_S", 30.0)
        self._repromote_at: Optional[float] = None
        # --- live knob retuning ---
        # The knob epoch generalizes the demote/re-promote safe-switch from
        # "plane" to "any value-affecting knob": a knob_change bumps this
        # epoch, demotes the eager plane for one cycle (interrupted
        # collectives replay bitwise through the redo machinery above), and
        # the cumulative committed table rides every exchange response until
        # each rank has applied it. Contributions formatted under a STALE
        # epoch are bounced back (`reformat`) instead of tripping the
        # cross-rank wire-mismatch error.
        self._knob_epoch = 0
        self._knob_table: dict = {}
        self._knob_repromote_s = _env_float("HOROVOD_KNOB_REPROMOTE_S", 1.0)
        # Ranks whose control connection dropped uncleanly (no "bye"): their
        # collectives can never complete — fail them so survivors escalate
        # to the elastic reset instead of waiting for the stall watchdog.
        self._dead: set[int] = set()
        # Result-bearing responses currently between claim and socket write
        # (the stop() drain waits on this as well as on unclaimed results).
        self._owed = 0
        # --- distributed tracing ---
        # The coordinator derives each collective's trace ID from its OWN
        # per-name execution counter — the same deterministic sequence the
        # ranks use at enqueue — so cached (bitvector) ticks need no trace
        # bytes on the wire; full requests carry a `trace` tag that this
        # side checks against the derivation.
        self._trace_seq: dict[str, int] = {}
        # Control-tree accounting: bytes the batch handlers did
        # NOT send because an identical field (knob table, plane epochs,
        # ring verdict) was hoisted out of a whole host's responses and
        # shipped once.
        self._m_hoisted = _metrics_registry().counter(
            "horovod_ctrl_bytes_total",
            help="Control-plane bytes by direction (up_out/up_in at host "
                 "agents, absorbed = rank requests answered locally, "
                 "hoisted = response bytes deduplicated by batching).",
            dir="hoisted")

    def start(self) -> None:
        t = threading.Thread(target=self._accept_loop, name="hvd_coord_accept", daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self, drain_timeout: float = 5.0) -> None:
        # A star-plane result is delivered on each rank's NEXT poll, so at
        # the moment rank 0's own collective completes, peers may not have
        # claimed theirs yet — tearing the coordinator down now (followed by
        # process exit) fails those ranks with "peer closed" while their
        # result sits computed in self._results. Drain first: wait until
        # every computed result has been claimed by every rank AND every
        # claimed response has actually hit the socket. Bounded, because a
        # dead peer never claims.
        deadline = time.monotonic() + drain_timeout
        with self._cv:
            while ((self._results or self._owed)
                   and not self._stop.is_set()
                   and time.monotonic() < deadline):
                self._cv.wait(timeout=0.02)
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        try:
            self.server.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.server.accept()
            except OSError:
                return
            self.accepted += 1
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        rank: Optional[int] = None
        # Control-tree relay connections (ctrl/relay.py) carry a
        # whole host's ranks on one socket: relay_hello declares them, so an
        # unclean drop of the RELAY fails every rank behind it — the same
        # rung-3 heartbeat invariant a flat connection gives one rank.
        relay_for: set[int] = set()
        clean = False
        try:
            while not self._stop.is_set():
                msg = _recv_msg(conn, self.key)
                kind = msg["kind"]
                if "rank" in msg:
                    rank = msg["rank"]
                if kind == "exchange":
                    out = self._handle_exchange(
                        msg["rank"], msg["requests"], msg["arrays"],
                        msg.get("bits", 0), msg.get("redo_results"))
                    try:
                        _send_msg(conn, out, self.key)
                    finally:
                        if out["results"]:
                            with self._cv:
                                self._owed -= 1
                                self._cv.notify_all()
                elif kind == "batch_exchange":
                    out = self._handle_batch_exchange(msg["items"])
                    owed = sum(1 for it in out["items"] if it["results"])
                    try:
                        _send_msg(conn, out, self.key)
                    finally:
                        if owed:
                            with self._cv:
                                self._owed -= owed
                                self._cv.notify_all()
                elif kind == "ring_hello":
                    _send_msg(conn, self._handle_ring_hello(
                        msg["rank"], msg.get("info") or {}), self.key)
                elif kind == "ring_confirm":
                    _send_msg(conn, self._handle_ring_confirm(
                        msg["rank"], bool(msg["ok"])), self.key)
                elif kind == "batch_ring_hello":
                    _send_msg(conn, self._handle_batch_ring_hello(
                        msg["items"]), self.key)
                elif kind == "batch_ring_confirm":
                    _send_msg(conn, self._handle_batch_ring_confirm(
                        msg["items"]), self.key)
                elif kind == "relay_hello":
                    relay_for.update(int(r) for r in msg.get("ranks") or ())
                    _send_msg(conn, {"ok": 1}, self.key)
                elif kind == "peer_lost":
                    # The relay reports a LOCAL rank's unclean drop. The
                    # lost rank rides "lost", not "rank", so the envelope
                    # attribution above never marks the relay itself dead.
                    relay_for.discard(int(msg["lost"]))
                    self._peer_lost(int(msg["lost"]))
                    _send_msg(conn, {"ok": 1}, self.key)
                elif kind == "plane_fault":
                    _send_msg(conn, self._handle_plane_fault(
                        msg["rank"], msg.get("names") or [],
                        msg.get("reason", "")), self.key)
                elif kind == "knob_change":
                    _send_msg(conn, self._handle_knob_change(
                        msg["rank"], msg.get("table") or {}), self.key)
                elif kind == "clock_probe":
                    # Trace clock alignment (tracing/clock.py): answer with
                    # this process's monotonic reading, nothing else — the
                    # caller brackets the round trip and estimates its
                    # offset to this (the reference) clock.
                    _send_msg(conn, {"t": time.monotonic_ns()}, self.key)
                elif kind == "bye":
                    clean = True
                    return
        except (ConnectionError, EOFError, OSError):
            return
        finally:
            # Always close — in particular on auth failure, so the peer sees
            # a clean rejection instead of a hung connection.
            try:
                conn.close()
            except OSError:
                pass
            # Rung 3 (coordinator heartbeat): a control connection that
            # drops WITHOUT the "bye" goodbye means the worker died or is
            # partitioned — its collectives can never complete. Fail them
            # now so every surviving rank raises HorovodInternalError into
            # the elastic reset path instead of waiting out the stall
            # watchdog.
            if not clean and not self._stop.is_set():
                if rank is not None:
                    self._peer_lost(rank)
                for r in sorted(relay_for):
                    self._peer_lost(r)

    # -- ring negotiation barriers

    def _handle_ring_hello(self, rank: int, info: dict) -> dict:
        """Data-plane registration barrier. Gathers every rank's endpoints
        + host coordinates + hierarchical willingness, then answers ONE
        plane verdict for the whole world: ``hier`` when every rank offered
        the two-level plane and the coordinates form a homogeneous blocked
        grid (plan_grid — the Python analyze_hier), ``flat`` when every
        rank has the ring enabled, peers None otherwise (star)."""
        with self._cv:
            self._ring_endpoints[rank] = info if info.get("enabled") else None
            self._cv.notify_all()
            return self._ring_hello_barrier()

    def _handle_batch_ring_hello(self, items: list) -> dict:
        """Host-leader form of ring_hello: one message registers a whole
        host's ranks, then waits the SAME world barrier. The verdict is
        identical for every rank by construction (asymmetry would deadlock
        establishment), so it rides once as ``shared`` and the relay fans
        it out locally."""
        with self._cv:
            for it in items:
                info = it.get("info") or {}
                self._ring_endpoints[it["rank"]] = \
                    info if info.get("enabled") else None
            self._cv.notify_all()
            shared = self._ring_hello_barrier()
        if len(items) > 1:
            self._m_hoisted.inc((len(items) - 1) * len(
                pickle.dumps(shared, protocol=pickle.HIGHEST_PROTOCOL)))
        return {"shared": shared}

    def _ring_hello_barrier(self) -> dict:
        """Wait for the full endpoint map and compute the plane verdict
        (caller holds the lock)."""
        deadline = time.monotonic() + 120.0
        while (len(self._ring_endpoints) < self.world
               and not self._stop.is_set()
               and time.monotonic() < deadline):
            self._cv.wait(1.0)
        if (len(self._ring_endpoints) < self.world
                or any(v is None for v in self._ring_endpoints.values())):
            return {"peers": None}
        if self._ring_plane is None:
            # Compute the verdict exactly once over the complete map;
            # every waiter returns the same answer (an asymmetric
            # verdict would deadlock establishment).
            infos = self._ring_endpoints
            plane = "flat"
            self._grid = None
            if all(i.get("hier") for i in infos.values()):
                coords = {r: (i.get("local_rank", 0),
                              i.get("local_size", 1),
                              i.get("cross_rank", r),
                              i.get("cross_size", self.world))
                          for r, i in infos.items()}
                if (plan_grid(coords) is not None
                        and all(i.get("local_port") and i.get("cross_port")
                                for i in infos.values())):
                    plane = "hier"
                    # Remembered for redo replays: a collective that the
                    # two-level plane partially finished must be
                    # re-reduced in the GRID canonical order, or the
                    # replayed ranks would diverge bitwise from the
                    # ranks that completed.
                    info0 = infos[min(infos)]
                    self._grid = (info0.get("local_size", 1),
                                  info0.get("cross_size", 1))
            self._ring_plane = plane
        return {"peers": dict(self._ring_endpoints),
                "plane": self._ring_plane}

    def _handle_ring_confirm(self, rank: int, ok: bool) -> dict:
        with self._cv:
            self._ring_votes[rank] = ok
            self._cv.notify_all()
            return self._ring_confirm_barrier()

    def _handle_batch_ring_confirm(self, items: list) -> dict:
        """Host-leader form of ring_confirm: all of one host's votes land
        in a single message; the all-or-nothing activation verdict rides
        back once as ``shared``."""
        with self._cv:
            for it in items:
                self._ring_votes[it["rank"]] = bool(it["ok"])
            self._cv.notify_all()
            shared = self._ring_confirm_barrier()
        if len(items) > 1:
            self._m_hoisted.inc((len(items) - 1) * len(
                pickle.dumps(shared, protocol=pickle.HIGHEST_PROTOCOL)))
        return {"shared": shared}

    def _ring_confirm_barrier(self) -> dict:
        """Wait for every vote and settle ``ring_active`` (caller holds the
        lock). The verdict is all-or-nothing: one missing or negative vote
        keeps the whole world on the star relay."""
        deadline = time.monotonic() + 120.0
        while (len(self._ring_votes) < self.world
               and not self._stop.is_set()
               and time.monotonic() < deadline):
            self._cv.wait(1.0)
        self.ring_active = (len(self._ring_votes) == self.world
                            and all(self._ring_votes.values()))
        if not self.ring_active and self._demote_epoch > 0 \
                and self._repromote_s > 0:
            # Failed re-promotion probe (some link still down): stay on
            # the star and re-arm the cooldown for the next attempt.
            self._repromote_at = time.monotonic() + self._repromote_s
        return {"active": self.ring_active}

    # -- escalation ladder --

    def _handle_plane_fault(self, rank: int, names: list, reason: str) -> dict:
        """A rank's peer link failed (timeout past the retry budget,
        ECONNRESET, rejected frame). Demote the WHOLE world to the star
        relay — every rank applies the epoch from its next exchange
        response — and open a redo negotiation for each collective the
        reporter must replay."""
        with self._cv:
            if self.ring_active:
                self._demote_and_recall(self._repromote_s)
                log("warning",
                    f"coordinator: eager data plane demoted to star after a "
                    f"link fault on rank {rank} "
                    f"({', '.join(names) or 'link'}: {reason}); "
                    + ("re-promotion probe in "
                       f"{self._repromote_s:g}s" if self._repromote_s > 0
                       else "re-promotion disabled (HOROVOD_PLANE_REPROMOTE_S=0)"))
            for nm in names:
                done = self._redo_done.get(nm)
                if done is not None and \
                        self._directive_seq.get(nm) == done[1]:
                    # Duplicate late report about an execution whose redo
                    # already closed: do NOT reopen it (names recur — a
                    # fresh redo would target the next execution). Un-claim
                    # the retiring answer so the reporter's replay can still
                    # collect it.
                    if nm in self._results and rank in self._claimed.get(
                            nm, set()):
                        self._claimed[nm].discard(rank)
                    continue
                self._want_redo(nm)
                # The reporter must REPLAY nm, so it is not a finisher: it
                # will claim the redo answer itself.
                if nm in self._redo_claim:
                    self._redo_claim[nm].discard(rank)
            self._cv.notify_all()
        return {"ok": 1}

    def _demote_and_recall(self, cooldown: float) -> None:
        """Demote the active eager plane to the star relay and recall its
        undelivered directives into redo negotiations (caller holds the
        lock). Shared by the link-fault path and the knob-epoch safe
        switch; ``cooldown`` arms the re-promotion probe."""
        self.ring_active = False
        self._demote_epoch += 1
        if cooldown > 0:
            self._repromote_at = time.monotonic() + cooldown
        # Ring-plane contributions were metadata-only; the star
        # replay needs bytes. Drop them so re-submissions (full
        # request + tensor) take their place.
        for entry in self._pending.values():
            for r in [r for r, (_q, a) in entry.items() if a is None]:
                del entry[r]
        # Recall undelivered ring directives: ranks that have not
        # claimed them yet renegotiate on the star; ranks that
        # already executed retain their result for the redo.
        for nm in list(self._results):
            err, val = self._results[nm]
            if err is None and isinstance(val, dict) \
                    and val.get("__ring__"):
                # Ranks that already claimed the directive may have
                # finished it; ranks that never claimed it will
                # renegotiate and must claim the redo answer.
                was_claimed = set(self._claimed.get(nm, set()))
                del self._results[nm]
                self._claimed.pop(nm, None)
                self._want_redo(nm, finished=was_claimed)

    def _handle_knob_change(self, rank: int, table: dict) -> dict:
        """Commit a value-affecting knob table world-wide via
        the demote/re-promote safe switch. Three guarantees: (1) every
        in-flight eager directive replays BITWISE under its old format
        (recalled through the redo machinery — retained results or a
        canonical star re-reduce over the already-formatted bytes); (2)
        pending star negotiations are recalled into a fresh-only redo (seq
        sentinel -1: a stale retained copy of a previous same-name
        execution must never answer them) and re-collected after every
        rank reformats; (3) no rank mixes tables within one collective —
        stale-epoch contributions are bounced, never ingested."""
        with self._cv:
            self._knob_table.update({str(k): v for k, v in table.items()})
            self._knob_epoch += 1
            # ALWAYS bump the demote epoch: ranks run _redo_inflight on it,
            # which redo-marks their sent-but-unanswered entries so the
            # engine-side knob apply skips them (they replay old-format).
            if self.ring_active:
                self._demote_and_recall(self._knob_repromote_s)
                log("info",
                    f"coordinator: eager plane demoted for knob epoch "
                    f"{self._knob_epoch} (rank {rank}); re-promotion probe "
                    f"in {self._knob_repromote_s:g}s")
            else:
                self._demote_epoch += 1
            # Recall every pending (incomplete) allreduce negotiation: its
            # collected contributions may span knob epochs. Fresh-only redo
            # (sentinel seq -1) — every rank re-ships bytes formatted under
            # the NEW table and the star folds them canonically.
            for nm in list(self._pending):
                reqs = [q for (q, _a) in self._pending[nm].values()]
                if not reqs or reqs[0].get("op") != "allreduce":
                    continue
                del self._pending[nm]
                self._first_seen.pop(nm, None)
                if nm not in self._results and nm not in self._redo_wanted:
                    self._redo_wanted[nm] = -1
                    self._redo_claim[nm] = set()
            # Flush the response cache: cached request dicts carry the OLD
            # epoch's wire signature and ke stamp, and a stale bit must
            # never let two formats meet in one collective. Tombstones keep
            # in-flight bits resolvable (they bounce on the ke check) and
            # the per-rank eviction queues re-teach every mirror.
            self._queue_evictions(self._cache.flush())
            self._cv.notify_all()
            return {"ok": 1, "epoch": self._knob_epoch}

    def _want_redo(self, name: str, finished: Optional[set] = None) -> None:
        """Open a redo negotiation for ``name`` (caller holds the lock): the
        collective is answered either by a rank that finished it on the
        peer plane (retained result — the identical bits) or by a fresh
        star reduction over every rank's re-shipped bytes, whichever
        arrives first."""
        if name in self._results:
            return  # already (re)answered
        if name not in self._redo_wanted:
            self._redo_wanted[name] = self._directive_seq.get(name, -1)
            # Presumed finishers (pre-claimed when a retained answer closes
            # the redo): the recall path passes the directive's claim set;
            # a fault report on a fully-delivered directive starts from the
            # whole world and carves reporters out as their reports arrive.
            self._redo_claim[name] = set(range(self.world)) \
                if finished is None else set(finished)
        if self._grid is not None:
            self._redo_grid[name] = self._grid

    def _peer_lost(self, rank: int) -> None:
        """Rung 3: rank's control connection dropped without a goodbye. Its
        collectives can never complete — fail every pending (and redo)
        negotiation with an error every surviving rank will receive, so the
        failure surfaces as HorovodInternalError (the elastic reset +
        blacklist path) within one engine tick."""
        with self._cv:
            if rank in self._dead:
                return
            self._dead.add(rank)
            msg = (_FATAL + f"lost control connection to rank {rank} before "
                   "its collectives completed (worker dead or partitioned); "
                   "failing in-flight collectives")
            names = list(self._pending) + [n for n in self._redo_wanted
                                           if n not in self._pending]
            for name in names:
                self._pending.pop(name, None)
                self._first_seen.pop(name, None)
                self._redo_wanted.pop(name, None)
                self._redo_grid.pop(name, None)
                self._redo_claim.pop(name, None)
                if name not in self._results:
                    self._results[name] = (msg, None)
                    self._claimed[name] = set()
            if names:
                log("warning", f"coordinator: {msg} "
                    f"({', '.join(sorted(names))})")
            self._cv.notify_all()

    def _maybe_schedule_reprobe(self) -> None:
        """Cooldown check (caller holds the lock): when the re-promotion
        timer expires, clear the establishment barriers and bump the
        reprobe epoch — every rank re-enters hello/confirm from its engine
        loop."""
        if (self._repromote_at is None or self.ring_active
                or self._dead or time.monotonic() < self._repromote_at):
            return
        self._repromote_at = None
        self._reprobe_epoch += 1
        self._ring_endpoints.clear()
        self._ring_votes.clear()
        self._ring_plane = None
        log("info", "coordinator: demotion cooldown expired — probing "
            "ring re-promotion")

    # -- response cache authority

    def cache_stats(self) -> dict:
        with self._lock:
            return self._cache.stats()

    def cache_flush(self) -> None:
        with self._cv:
            self._queue_evictions(self._cache.flush())

    def _queue_evictions(self, evicted) -> None:
        """Record evictions (from assign/evict_name/flush) for broadcast.
        ``evicted``: list of (bit, key, meta) triples. Callers hold _lock."""
        for bit, key, meta in evicted:
            name = key[0]
            if self._assigned.get(name, (None,))[0] == bit:
                del self._assigned[name]
            self._tombstones[bit] = (key, meta, set(range(self.world)))
            for r in range(self.world):
                self._evict_q[r].append(bit)

    def _drain_evictions(self, rank: int) -> list[int]:
        out = self._evict_q[rank]
        self._evict_q[rank] = []
        for bit in out:
            tomb = self._tombstones.get(bit)
            if tomb is not None:
                tomb[2].discard(rank)
                if not tomb[2]:
                    del self._tombstones[bit]
        return out

    def _resolve_bits(self, bits: int) -> list[dict]:
        """Expand a rank's cache bitvector into request dicts."""
        reqs = []
        m = bits
        while m:
            b = (m & -m).bit_length() - 1
            m &= m - 1
            entry = self._cache.lookup_bit(b)
            if entry is None:
                tomb = self._tombstones.get(b)
                entry = (tomb[0], tomb[1]) if tomb else None
            if entry is None:
                log("warning", f"coordinator: unknown cache bit {b} ignored")
                continue
            self._cache.hits += 1
            reqs.append(dict(entry[1]))
        return reqs

    def _maybe_assign(self, name: str, contribs: dict) -> None:
        """Bind a freshly-completed tensor's signature to a cache bit.
        Allgather is uncacheable: its first dimension is legitimately
        rank-divergent, so no single signature matches every rank."""
        if not self._cache.enabled:
            return
        req0 = contribs[min(contribs)][0]
        if req0["op"] == "allgather":
            return
        key = request_key(req0)
        if self._cache.bit_for(key) is not None:
            return  # already bound (idempotent re-completion)
        bit, evicted = self._cache.assign(
            key, dict(req0), in_use=set(self._pending))
        self._queue_evictions(evicted)
        if bit is not None:
            self._assigned[name] = (bit, key)

    # -- the exchange

    def _handle_exchange(self, rank: int, requests: list[dict], arrays: dict,
                         bits: int = 0,
                         redo_results: Optional[dict] = None) -> dict:
        with self._cv:
            names, reformat = self._exchange_ingest(
                rank, requests, arrays, bits, redo_results)
            self._exchange_wait(names)
            return self._exchange_build(rank, names, reformat)

    def _handle_batch_exchange(self, items: list) -> dict:
        """Host-leader form of exchange: a relay delivers one
        tick carrying several ranks' envelopes. Ingest them all FIRST, then
        run the bounded wait ONCE on the union of their names — co-hosted
        ranks usually tick the same tensors, so a name that needs all of
        them completes inside this very call instead of bouncing L serial
        0.1 s empty-waits. Each rank then builds its own response (claims
        are per-rank); response fields that are identical across the whole
        batch (knob table, plane epochs) are hoisted into the envelope and
        sent once, with the savings counted in
        ``horovod_ctrl_bytes_total{dir="hoisted"}``."""
        parts: list[tuple[int, list, list]] = []
        with self._cv:
            union: list[str] = []
            seen: set = set()
            for msg in items:
                names, reformat = self._exchange_ingest(
                    msg["rank"], msg["requests"], msg.get("arrays") or {},
                    msg.get("bits", 0), msg.get("redo_results"))
                parts.append((msg["rank"], names, reformat))
                for n in names:
                    if n not in seen:
                        seen.add(n)
                        union.append(n)
            self._exchange_wait(union)
            out_items = [self._exchange_build(rank, names, reformat)
                         for rank, names, reformat in parts]
        resp: dict = {"items": out_items}
        if len(out_items) > 1:
            saved = 0
            for field in ("knob", "plane"):
                vals = [it[field] for it in out_items if field in it]
                if len(vals) == len(out_items) \
                        and all(v == vals[0] for v in vals):
                    for it in out_items:
                        del it[field]
                    resp[field] = vals[0]
                    saved += (len(out_items) - 1) * len(pickle.dumps(
                        vals[0], protocol=pickle.HIGHEST_PROTOCOL))
            if saved:
                self._m_hoisted.inc(saved)
        return resp

    def _exchange_ingest(self, rank: int, requests: list[dict], arrays: dict,
                         bits: int = 0,
                         redo_results: Optional[dict] = None
                         ) -> tuple[list[str], list[str]]:
        """Fold one rank's tick into coordinator state (caller holds the
        lock): redo answers, cache-bit resolution, stale-knob-epoch
        bounces, pending contributions, ready executions, dead-rank
        backstop. Returns the names this rank awaits and the bounced
        (reformat) names."""
        ready: list[str] = []
        self._maybe_schedule_reprobe()
        now = time.monotonic()
        # Redo answers: a rank that finished a collective on
        # the peer plane before the link died ships its retained result
        # — the identical bits the failed ranks would have produced —
        # and the redo negotiation closes without re-reducing anything.
        # Seq-checked: only a copy of the RECALLED execution counts
        # (names recur every step; a stale copy must never answer).
        for nm, (seq, arr) in (redo_results or {}).items():
            if (self._redo_wanted.get(nm) == int(seq)
                    and nm not in self._results):
                self._results[nm] = (None, np.asarray(arr))
                # Pre-claim the finishers: only the redoing ranks still
                # owe a claim, so the result retires as soon as they
                # collect it instead of lingering into (and poisoning)
                # the next same-name collective.
                self._claimed[nm] = set(self._redo_claim.pop(nm, set()))
                self._pending.pop(nm, None)
                self._first_seen.pop(nm, None)
                self._redo_wanted.pop(nm, None)
                self._redo_grid.pop(nm, None)
                self._redo_done[nm] = (now, int(seq))
        # Retained-result answers can never be claimed by the whole
        # world (the ranks that finished never re-poll the name), so the
        # world-claimed deletion cannot fire — purge them after a claim
        # window instead.
        for nm, (ts, _seq) in list(self._redo_done.items()):
            if now - ts > 60.0:
                self._redo_done.pop(nm)
                self._results.pop(nm, None)
                self._claimed.pop(nm, None)
        full_reqs = list(requests)
        if full_reqs and self._cache.enabled:
            for req in full_reqs:
                # Shape-change invalidation: a full request for a name
                # bound under a DIFFERENT signature evicts the stale bit
                # everywhere. (Same signature = a flushed mirror
                # re-learning; the assignment is re-announced with the
                # result delivery.)
                old = self._cache.bit_for_name(req["name"])
                if old is not None and self._cache.lookup_bit(old)[0] != \
                        request_key(req):
                    self._queue_evictions(
                        self._cache.evict_name(req["name"]))
                if (req["name"] not in self._results
                        and rank not in self._pending.get(req["name"], {})):
                    self._cache.misses += 1
        all_reqs = full_reqs + self._resolve_bits(bits)
        reformat: list[str] = []
        for req in all_reqs:
            name = req["name"]
            # Re-poll after a partial response: the result is already
            # waiting for this rank — don't contribute again (a stale
            # entry would poison the next same-name collective).
            if name in self._results and rank not in self._claimed.get(name, set()):
                continue
            if (req["op"] == "allreduce"
                    and int(req.get("ke", 0)) != self._knob_epoch
                    and self._redo_wanted.get(name, -1) == -1):
                # Knob-epoch safe switch: this contribution
                # was formatted under a stale knob table — bounce it for
                # re-formatting instead of ingesting (mixing tables
                # within one collective would trip the wire-mismatch
                # validation, or worse, silently fold mixed precision).
                # RING-directive redos (real seq) are EXEMPT: every rank
                # re-ships its old-format bytes consistently, which is
                # exactly how an interrupted collective replays bitwise.
                # Recalled star pendings (sentinel seq -1) are NOT: a
                # late rank may first learn of the recall on this very
                # response, so the fresh re-reduce collects only
                # new-table contributions.
                reformat.append(name)
                continue
            entry = self._pending.setdefault(name, {})
            self._first_seen.setdefault(name, time.monotonic())
            if name in arrays:
                entry[rank] = (req, arrays[name])
            elif (rank not in entry and self.ring_active
                    and req["op"] == "allreduce"):
                # Ring-plane allreduce: metadata-only contribution —
                # the bytes never transit the coordinator.
                entry[rank] = (req, None)
            # else: metadata-only re-poll — this rank's bytes are already
            # stored from its first contribution; nothing to overwrite.
            if len(entry) == self.world:
                ready.append(name)
        for name in ready:
            contribs = self._pending.pop(name)
            self._results[name] = self._execute(name, contribs)
            self._first_seen.pop(name, None)
            self._redo_wanted.pop(name, None)
            self._redo_claim.pop(name, None)
            self._claimed[name] = set()
            if self._results[name][0] is None:
                self._maybe_assign(name, contribs)
        if self._dead:
            # Rung 3 backstop: anything still (or newly) pending misses
            # at least one dead rank forever — fail it now with the
            # reset-worthy error instead of letting re-polls spin until
            # the stall watchdog.
            dmsg = (_FATAL + f"rank(s) {sorted(self._dead)} lost their "
                    "control connection (worker dead or partitioned); "
                    "collective cannot complete")
            for name in list(self._pending):
                self._pending.pop(name)
                self._first_seen.pop(name, None)
                self._redo_wanted.pop(name, None)
                self._redo_grid.pop(name, None)
                self._redo_claim.pop(name, None)
                if name not in self._results:
                    self._results[name] = (dmsg, None)
                    self._claimed[name] = set()
        self._cv.notify_all()
        # Bounced (stale knob epoch) names re-submit next cycle — the
        # wait's grace loop must not stall waiting for contributions this
        # very response is rejecting.
        return ([r["name"] for r in all_reqs if r["name"] not in reformat],
                reformat)

    def _exchange_wait(self, names: list[str]) -> None:
        """Bounded readiness wait (caller holds the lock).

        Collective semantics: a tensor completes only when every rank
        contributed. But an exchange never blocks on a straggler (the
        round-3 divergence: every tensor shared the fate of the
        batch's slowest name for up to 30 s, and because the engine
        loop is single-threaded, tensors enqueued in LATER cycles
        queued behind it too). The response returns when ALL requested
        names are ready; once ANY is, after a short grace for the
        rest; and when NONE is, empty after one short tick. Unready
        names are simply absent from the response; the rank re-polls
        them metadata-only on its next cycle (no tensor re-shipping,
        and newly enqueued tensors join that next exchange instead of
        waiting behind this one) and the stall checker warns on the
        original enqueue age (reference CheckForStalledTensors,
        operations.cc:1625-1672)."""
        empty_deadline = time.monotonic() + 0.1
        grace: Optional[float] = None
        while True:
            unready = [n for n in names if n not in self._results]
            if not unready:
                break
            if len(unready) < len(names):
                # something is ready: linger briefly for the rest, then
                # return the partials
                if grace is None:
                    grace = time.monotonic() + 0.05
                if time.monotonic() >= grace:
                    break
                self._cv.wait(timeout=0.01)
            else:
                if time.monotonic() >= empty_deadline:
                    break  # nothing ready: hand control back to the rank
                self._cv.wait(timeout=0.02)

    def _exchange_build(self, rank: int, names: list[str],
                        reformat: list[str]) -> dict:
        """Claim whatever is ready for ``rank`` and assemble its response
        (caller holds the lock)."""
        out: dict[str, tuple[Optional[str], Any]] = {}
        assign: list[tuple[int, tuple]] = []
        for n in names:
            if n in self._results and rank not in self._claimed[n]:
                out[n] = self._results[n]
                if n in self._assigned:
                    assign.append(self._assigned[n])
                self._claimed[n].add(rank)
                if len(self._claimed[n]) == self.world:
                    del self._results[n]
                    del self._claimed[n]
        if out:
            # Owed until _serve's send completes — stop()'s drain must
            # not declare victory between the claim and the write.
            self._owed += 1
        resp = {"results": out, "assign": assign,
                "evict": self._drain_evictions(rank)}
        if self._demote_epoch or self._reprobe_epoch:
            # Ladder signals: epochs ride every response once
            # a demotion happened (two small ints; ranks apply them with
            # one compare each). Absent in the steady state, so the
            # healthy-path response stays byte-identical to before.
            resp["plane"] = {"demote": self._demote_epoch,
                             "reprobe": self._reprobe_epoch}
        if self._redo_wanted:
            # Ask every rank for its retained copy of the recalled
            # (name, seq) executions — whichever survivor answers first
            # closes the redo without re-reducing anything.
            resp["redo"] = [[nm, seq]
                            for nm, seq in self._redo_wanted.items()]
        if self._knob_epoch:
            # Knob-table commit: the cumulative table rides
            # every response once a knob changed; ranks apply it with
            # one epoch compare. Absent in the steady state.
            resp["knob"] = {"epoch": self._knob_epoch,
                            "table": dict(self._knob_table)}
        if reformat:
            resp["reformat"] = reformat
        return resp

    def stall_candidates(self) -> list:
        """Watchdog source (reference CheckForStalledTensors with
        missing-rank lists, operations.cc:1625-1672): every pending tensor's
        age and the ranks that have NOT yet contributed it."""
        now = time.monotonic()
        out = []
        all_ranks = set(range(self.world))
        with self._lock:
            for name, contribs in self._pending.items():
                missing = sorted(all_ranks - set(contribs))
                op = next(iter(contribs.values()))[0]["op"] if contribs else "?"
                out.append(StallInfo(
                    name=name, op=op,
                    age_s=now - self._first_seen.get(name, now),
                    missing_ranks=missing))
        return out

    def _validate(self, name: str, reqs: list[dict]) -> Optional[str]:
        """Cross-rank validation (ConstructResponse, operations.cc:321-523)."""
        op = reqs[0]["op"]
        if any(r["op"] != op for r in reqs):
            return f"Mismatched collective operations for tensor {name}"
        if any(r["dtype"] != reqs[0]["dtype"] for r in reqs):
            return f"Mismatched data types for tensor {name}"
        if any(r.get("wire") != reqs[0].get("wire") for r in reqs):
            # Divergent HOROVOD_COMPRESSION across ranks: half the world
            # would ship 2-byte chunks the other half reads at full width.
            return f"Mismatched wire compression for tensor {name}"
        if op in ("allreduce", "broadcast", "alltoall", "reducescatter") and any(
            r["shape"] != reqs[0]["shape"] for r in reqs
        ):
            return f"Mismatched tensor shapes for {op} {name}"
        if op == "allgather" and any(
                tuple(r["shape"][1:]) != tuple(reqs[0]["shape"][1:])
                for r in reqs):
            return f"Mismatched non-first dimensions for allgather {name}"
        if op == "broadcast" and any(r["root"] != reqs[0]["root"] for r in reqs):
            return f"Mismatched root ranks for broadcast {name}"
        return None

    def _trace_tid(self, name: str, reqs: list[dict]) -> Optional[str]:
        """Trace ID for this execution: the coordinator's own per-name
        counter, cross-checked against any `trace` tags the full requests
        carried (cached ticks carry none — the derivation covers them)."""
        rec = _trace_recorder()
        if rec is None:
            return None
        seq = self._trace_seq.get(name, 0) + 1
        self._trace_seq[name] = seq
        tid = _trace_id(name, seq)
        tagged = {r.get("trace") for r in reqs if r.get("trace")}
        if tagged and (len(tagged) > 1 or tid not in tagged):
            log("warning",
                f"coordinator trace-id disagreement for {name}: derived "
                f"{tid}, requests carried {sorted(tagged)}")
            # The ranks' view wins for span keying (they already emitted
            # spans under it); agreement failures are surfaced, not fatal.
            tid = sorted(tagged)[0]
        return tid

    def _execute(self, name: str, contributions: dict[int, tuple[dict, Optional[np.ndarray]]]):
        reqs = [contributions[r][0] for r in sorted(contributions)]
        op = reqs[0]["op"]
        err = self._validate(name, reqs)
        if err is not None:
            return (err, None)
        tid = self._trace_tid(name, reqs)
        if self.ring_active and op == "allreduce":
            # Ring directive: every rank executes this allreduce against its
            # neighbours, in the global order this seq defines. The
            # coordinator never touches the bytes. The directive echoes the
            # trace ID so every rank can verify the shared derivation.
            seq = self._ring_seq
            self._ring_seq += 1
            self._directive_seq[name] = seq
            out = {"__ring__": True, "seq": seq,
                   "average": bool(reqs[0]["average"])}
            if tid is not None:
                out["trace"] = tid
            return (None, out)
        arrs = [contributions[r][1] for r in sorted(contributions)]
        if any(a is None for a in arrs):  # pragma: no cover - engine bug guard
            return (f"missing tensor bytes for star-plane {op} {name}", None)
        rec = _trace_recorder() if tid is not None else None
        red_t0 = rec.now_ns() if rec is not None else 0
        try:
            if op == "allreduce":
                # Redo replay after a HIERARCHICAL-plane demotion:
                # ranks that finished before the link died hold grid-order
                # bits; the star replay must fold in the same grid order or
                # the world would diverge bitwise. (Uncompressed f64
                # accumulation is order-exact, but the compressed path
                # rounds per hop — the order IS the value.)
                grid = self._redo_grid.pop(name, None)
                wire_name = reqs[0].get("wire")
                if wire_name == "topk":
                    # Sparse star plane: contributions arrived as
                    # packed indices+values frames of each rank's enqueue-
                    # time selection. Densify, run the canonical f32 fold
                    # (the exact add order the index-merging ring performs
                    # — grid order after a hier demotion), and ship the
                    # result back as a frame: star==ring==hier bitwise.
                    shape = tuple(reqs[0]["shape"])
                    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
                    full = [topk_state_dense(topk_unpack(a, n), n)
                            .reshape(shape) for a in arrs]
                    red = _ring_order_reduce(full, reqs[0]["average"],
                                             wire_dtype="topk", grid=grid)
                    if rec is not None:
                        rec.span(tid, name, op, "reduce", red_t0,
                                 rec.now_ns(), plane="star", fmt="topk")
                    frame = topk_encode(
                        ("sparse", *topk_sparsify(red.ravel())), n)
                    return (None, {"__wire__": frame, "fmt": "topk",
                                   "dtype": reqs[0]["dtype"],
                                   "shape": shape})
                if wire_name:
                    # Contributions arrived at wire width (exact: they were
                    # quantized at enqueue). Upcast, run the canonical
                    # reduction with the wire's hop rounding, and hand the
                    # result back at wire width — the final rounding makes
                    # that lossless too.
                    wire_np = numpy_dtype_by_name(wire_name)
                    orig = np_dtype(reqs[0]["dtype"])
                    full = [cast(a, orig) for a in arrs]
                    red = _ring_order_reduce(full, reqs[0]["average"],
                                             wire_dtype=wire_np, grid=grid)
                    if rec is not None:
                        rec.span(tid, name, op, "reduce", red_t0,
                                 rec.now_ns(), plane="star")
                    return (None, {"__wire__": cast(red, wire_np),
                                   "dtype": dtype_name(orig)})
                red = _ring_order_reduce(arrs, reqs[0]["average"], grid=grid)
                if rec is not None:
                    # Star-plane reduction runs HERE (rank 0's process):
                    # record it under the shared trace ID so the merged
                    # trace shows where the arithmetic happened.
                    rec.span(tid, name, op, "reduce", red_t0, rec.now_ns(),
                             plane="star")
                return (None, red)
            if op == "allgather":
                return (None, np.concatenate(arrs, axis=0))
            if op == "broadcast":
                return (None, arrs[reqs[0]["root"]])
            if op == "reducescatter":
                if is_bfloat16(arrs[0].dtype):
                    # numpy cannot add bfloat16 patterns: fold at float64,
                    # as the other floats do.
                    acc = cast(sum(cast(a, np.float64) for a in arrs),
                               arrs[0].dtype)
                else:
                    acc = sum(a.astype(np.float64) for a in arrs) \
                        if np.issubdtype(arrs[0].dtype, np.floating) \
                        else sum(arrs)
                    acc = np.asarray(acc, dtype=arrs[0].dtype)
                shards = np.array_split(acc, self.world, axis=0)
                return (None, {"__per_rank__": shards})
            if op == "alltoall":
                shards = [np.array_split(a, self.world, axis=0) for a in arrs]
                per_rank = [np.concatenate([shards[s][r] for s in range(self.world)], axis=0)
                            for r in range(self.world)]
                return (None, {"__per_rank__": per_rank})
        except Exception as exc:  # pragma: no cover
            return (str(exc), None)
        return (f"unknown op {op}", None)


class _Client:
    def __init__(self, host: str, port: int, rank: int,
                 key: bytes = b"", local: int = 1) -> None:
        self.rank = rank
        self.key = key or _secret_from_env()
        if not self.key:
            raise HorovodInternalError(
                "client requires a shared HOROVOD_SECRET key")
        # Control tree: when the launcher exported a per-host
        # relay address, the control socket goes THERE (loopback) instead of
        # to the rank-0 coordinator; the relay coalesces this host's ticks
        # so the root pays O(hosts) connections. The wire protocol is
        # unchanged — only the first hop moves.
        relay = os.environ.get("HOROVOD_CTRL_RELAY", "")
        dial_host, dial_port = host, port
        if relay:
            rhost, rport = relay.rsplit(":", 1)
            dial_host, dial_port = rhost, int(rport)
        deadline = time.monotonic() + 60.0
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                self.sock = socket.create_connection(
                    (dial_host, dial_port), timeout=60)
                break
            except OSError as e:
                last = e
                time.sleep(0.1)
        else:
            raise HorovodInternalError(
                f"cannot reach coordinator at {dial_host}:{dial_port}: {last}")
        self.sock.settimeout(120)
        self._lock = threading.Lock()
        self._via_relay = bool(relay)
        self._coord_host = host
        if relay:
            # Tell the relay who this is, the host's full complement (its
            # ring-barrier batch size), and where the coordinator of THIS
            # generation lives (elastic resets move it).
            _send_msg(self.sock, {"kind": "relay_hello", "rank": rank,
                                  "local": int(local),
                                  "coord": [host, int(port)]}, self.key)
            _recv_msg(self.sock, self.key)
        self.last_sent_bytes = 0
        # (assign, evict) announcements from the latest exchange response;
        # the engine applies them to its CacheMirror.
        self.last_cache: tuple[list, list] = ([], [])
        # Escalation-ladder signals piggybacked on the latest exchange
        # response: the coordinator's demote/reprobe epochs and
        # the redo names it wants this rank's retained ring results for.
        self.last_plane: dict = {}
        self.last_redo: list = []
        # Knob-epoch signals: the committed knob table riding the
        # latest response, and the names whose stale-epoch contributions the
        # coordinator bounced for re-formatting.
        self.last_knob: dict = {}
        self.last_reformat: list = []

    def local_host(self) -> str:
        """Local address of the control connection — the interface that
        routes to the coordinator, advertised for this rank's ring
        listener (native Client::local_host analog)."""
        if self._via_relay:
            # The control socket points at the loopback relay; the ring
            # listener must advertise the interface that routes to the REAL
            # coordinator. A connected UDP socket resolves that route
            # without sending a packet.
            probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                probe.connect((self._coord_host, 9))
                return probe.getsockname()[0]
            except OSError:
                return self.sock.getsockname()[0]
            finally:
                probe.close()
        return self.sock.getsockname()[0]

    def ring_hello(self, info: dict) -> dict:
        """Registration barrier for the eager data plane: ships this rank's
        endpoints + host coordinates + hierarchical willingness, returns
        ``{"peers": {rank: info} | None, "plane": "flat" | "hier"}`` — the
        coordinator's single world-wide plane verdict."""
        with self._lock:
            _send_msg(self.sock, {"kind": "ring_hello", "rank": self.rank,
                                  "info": dict(info)}, self.key)
            return _recv_msg(self.sock, self.key)

    def ring_confirm(self, ok: bool) -> bool:
        """Connect-success barrier: True only when EVERY rank connected."""
        with self._lock:
            _send_msg(self.sock, {"kind": "ring_confirm", "rank": self.rank,
                                  "ok": bool(ok)}, self.key)
            return bool(_recv_msg(self.sock, self.key).get("active"))

    def clock_probe(self) -> int:
        """One NTP-style round trip: the coordinator's monotonic_ns reading
        (tracing clock alignment; the caller brackets this call)."""
        with self._lock:
            _send_msg(self.sock, {"kind": "clock_probe", "rank": self.rank},
                      self.key)
            return int(_recv_msg(self.sock, self.key)["t"])

    def plane_fault(self, names: list, reason: str) -> None:
        """Report a peer-link fault to the coordinator (rung 2): it demotes
        the whole world to the star relay and opens a redo negotiation for
        each named collective this rank must replay."""
        with self._lock:
            _send_msg(self.sock, {"kind": "plane_fault", "rank": self.rank,
                                  "names": list(names),
                                  "reason": str(reason)}, self.key)
            _recv_msg(self.sock, self.key)

    def knob_change(self, table: dict) -> int:
        """Commit a value-affecting knob table to the coordinator: it bumps the knob epoch, demotes the plane for one safe-switch
        cycle, and piggybacks the table on every rank's next exchange
        response. Returns the committed epoch."""
        with self._lock:
            _send_msg(self.sock, {"kind": "knob_change", "rank": self.rank,
                                  "table": dict(table)}, self.key)
            return int(_recv_msg(self.sock, self.key).get("epoch", 0))

    def exchange(self, requests: list[dict], arrays: dict,
                 bits: int = 0, redo_results: Optional[dict] = None) -> dict:
        with self._lock:
            msg = {"kind": "exchange", "rank": self.rank,
                   "requests": requests, "arrays": arrays, "bits": bits}
            if redo_results:
                msg["redo_results"] = redo_results
            self.last_sent_bytes = _send_msg(self.sock, msg, self.key)
            resp = _recv_msg(self.sock, self.key)
        if isinstance(resp, dict) and "results" in resp:
            self.last_cache = (resp.get("assign") or [],
                               resp.get("evict") or [])
            self.last_plane = resp.get("plane") or {}
            self.last_redo = resp.get("redo") or []
            self.last_knob = resp.get("knob") or {}
            self.last_reformat = resp.get("reformat") or []
            out = resp["results"]
        else:  # pragma: no cover - legacy shape
            self.last_cache = ([], [])
            self.last_plane, self.last_redo = {}, []
            self.last_knob, self.last_reformat = {}, []
            out = resp
        # Unwrap per-rank results (reducescatter / alltoall)
        for name, (err, val) in list(out.items()):
            if err is None and isinstance(val, dict) and "__per_rank__" in val:
                out[name] = (None, val["__per_rank__"][self.rank])
        return out

    def close(self) -> None:
        try:
            _send_msg(self.sock, {"kind": "bye"}, self.key)
            self.sock.close()
        except OSError:
            pass


def create(topo: Topology, config: Config, **kw):
    """Factory: the native C++ engine when it builds, the Python engine
    otherwise; ``kw`` (``rendezvous``, ``watchdog``) goes to either.

    ``HOROVOD_ENGINE=python`` forces the Python engine; ``native`` (the
    default) tries the native one first; ``native!`` raises instead of
    falling back. In multi-process worlds the fallback is NOT silent: the
    two engines speak different wire protocols, so a mixed world would
    hang; every rank must make the same choice, hence a failed build raises
    there. ``HOROVOD_NATIVE_DATA_PLANE=0`` is the other spelling of the
    Python engine; an explicit ``HOROVOD_ENGINE`` wins when both are set."""
    impl = (os.environ.get("HOROVOD_ENGINE") or "").lower()
    if not impl:
        ndp = os.environ.get("HOROVOD_NATIVE_DATA_PLANE", "1")
        impl = "python" if ndp in ("0", "false") else "native"
    if impl not in ("native", "native!", "python"):
        log("warning", f"unknown HOROVOD_ENGINE={impl!r}; using 'native'")
        impl = "native"
    if impl.startswith("native"):
        try:
            from ..cc.native_engine import NativeEngine

            return NativeEngine(topo, config, **kw)
        except Exception as e:
            if impl == "native!" or topo.size > 1:
                raise HorovodInternalError(
                    f"native engine unavailable ({e}); in multi-process worlds "
                    "all ranks must use the same engine — fix the native build "
                    "or set HOROVOD_ENGINE=python on every rank"
                ) from e
            log("debug", f"native engine unavailable ({e}); using Python engine")
    return PyEngine(topo, config, **kw)
