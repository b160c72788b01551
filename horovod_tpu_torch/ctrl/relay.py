"""Per-host relay for the engine coordinator's control plane: the port of
``horovod_tpu/ctrl/relay.py``.

The eager engine (``common/engine.py``) coordinates collectives through a rank-0 star:
every rank holds one control socket to the coordinator and ticks it with
exchange envelopes, so the root pays O(world) connections and O(world)
control bytes per step. ``CoordRelay`` collapses that to O(hosts): it
listens on loopback, every LOCAL rank connects to it instead of the
coordinator (``HOROVOD_CTRL_RELAY``), and it maintains exactly one primary
upstream connection per coordinator generation. Rank envelopes are
forwarded with three disciplines, chosen per message kind to preserve the
engine's protocol invariants exactly:

- ``exchange`` — opportunistically coalesced: envelopes that arrive within
  a short window (``HOROVOD_CTRL_TICK_WINDOW_S``) ride one upstream
  ``batch_exchange``; the coordinator ingests them all before its bounded
  wait, and response fields identical across the host (knob table, plane
  epochs) come back hoisted once and are re-inflated here. This is NOT a
  local barrier — an idle rank delays nobody; a lone envelope simply
  ships alone after the window.
- ``ring_hello`` / ``ring_confirm`` — true local barriers: the engine's
  establishment rounds are world barriers anyway (the coordinator answers
  after ALL ranks arrive), so waiting for the host's full complement
  (declared in ``relay_hello``) costs nothing and sends one
  ``batch_ring_*`` per host. The shared verdict fans back out locally,
  keeping the all-or-nothing activation property bit-identical.
- ``plane_fault`` / ``knob_change`` / ``clock_probe`` — forwarded
  one-for-one; these are rare (fault paths) or latency-calibrating (the
  probe brackets its own round trip, the extra hop only widens its error
  bound).

Liveness is preserved across the extra hop: the relay declares its ranks
upstream via ``relay_hello``, so an unclean RELAY drop fails the whole
host at the coordinator (the host is the failure domain), and an unclean
LOCAL drop is reported as ``peer_lost`` so the coordinator fails exactly
that rank — the same rung-3 semantics a flat connection gives. If the
upstream dies, every local connection is closed so ranks escalate into
the elastic reset path immediately.

Barriers share the primary upstream connection. A ring barrier can hold
it for up to 120 s at the coordinator, but the engine only runs barriers
while every local rank is parked INSIDE the same barrier — no exchange
traffic exists to block behind it, and the occasional clock probe just
waits (its socket timeout outlasts the barrier window).
"""

from __future__ import annotations

import os
import pickle
import socket
import threading
from typing import Any, Optional

from ..common.engine import _recv_msg, _send_msg
from ..common.protocol import COORD_WIRE_KINDS
from ..metrics import registry as _metrics_registry
from ..utils.logging import log

# The kinds this relay treats specially (coalesced, barriered, or
# consumed); everything else in the coordinator's dispatch alphabet is
# forwarded one-for-one. Guarded against COORD_WIRE_KINDS so a kind
# renamed or split in _Coordinator._serve fails HERE at import, not as a
# silent pass-through that defeats the batching.
_RELAY_SPECIAL_KINDS = ("exchange", "ring_hello", "ring_confirm",
                        "relay_hello", "bye")
if not set(_RELAY_SPECIAL_KINDS) <= set(COORD_WIRE_KINDS):
    raise AssertionError(
        f"ctrl relay special-cases {set(_RELAY_SPECIAL_KINDS) - set(COORD_WIRE_KINDS)} "
        "which the coordinator no longer dispatches — update ctrl/relay.py "
        "to match common/protocol.py COORD_WIRE_KINDS")


def _wire_size(obj: Any) -> int:
    """Bytes this object would have cost as its own wire frame (payload +
    length prefix + HMAC tag) — the accounting unit for ``absorbed``."""
    return len(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)) + 40


def tick_window_s() -> float:
    """Coalescing window for exchange envelopes (seconds)."""
    try:
        v = float(os.environ.get("HOROVOD_CTRL_TICK_WINDOW_S", "0.005"))
    except ValueError:
        v = 0.005
    return max(0.0, v)


class CoordRelay:
    """Loopback control-plane relay for one job's local ranks."""

    def __init__(self, key: bytes, host: str = "127.0.0.1", port: int = 0,
                 window_s: Optional[float] = None) -> None:
        self.key = key
        self.window_s = tick_window_s() if window_s is None else window_s
        self._stop = threading.Event()
        # Upstream (coordinator) state, re-established per generation: the
        # elastic reset rebuilds the coordinator at a NEW address, and the
        # fresh local clients announce it in their relay_hello.
        self._up_lock = threading.Lock()      # serializes primary-socket RPCs
        self._up: Optional[socket.socket] = None
        self._coord: Optional[tuple[str, int]] = None
        self._declared: set[int] = set()      # ranks declared upstream
        # Local membership: rank -> its connection, plus each rank's claim
        # of the host's full complement (for the ring barriers).
        self._state = threading.Condition()
        self._conns: dict[int, socket.socket] = {}
        self._local: int = 1
        # Exchange coalescing batch (leader/follower, like a bakery queue):
        # {"items": [(rank, envelope)], "out": {rank: resp}, "done": Event,
        #  "closed": bool, "error": Optional[str]}
        self._batch: Optional[dict] = None
        # Ring barrier aggregation, one per kind in flight at a time.
        self._barrier: dict[str, dict] = {}
        reg = _metrics_registry()
        self._m_up_out = reg.counter(
            "horovod_ctrl_bytes_total",
            help="Control-plane bytes by direction (up_out/up_in at host "
                 "agents, absorbed = rank requests answered locally, "
                 "hoisted = response bytes deduplicated by batching).",
            dir="up_out")
        self._m_absorbed = reg.counter(
            "horovod_ctrl_bytes_total",
            help="Control-plane bytes by direction (up_out/up_in at host "
                 "agents, absorbed = rank requests answered locally, "
                 "hoisted = response bytes deduplicated by batching).",
            dir="absorbed")
        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ctrl-relay-accept", daemon=True)
        self._accept_thread.start()

    # -- lifecycle

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._up_lock:
            self._close_up(clean=True)
        with self._state:
            for conn in self._conns.values():
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()
            self._state.notify_all()

    def _close_up(self, clean: bool) -> None:
        """Drop the primary upstream (caller holds _up_lock)."""
        if self._up is not None:
            try:
                if clean:
                    _send_msg(self._up, {"kind": "bye"}, self.key)
            except OSError:
                pass
            try:
                self._up.close()
            except OSError:
                pass
        self._up = None
        self._declared.clear()

    # -- local side

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             name="ctrl-relay-conn", daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        rank: Optional[int] = None
        clean = False
        try:
            while not self._stop.is_set():
                msg = _recv_msg(conn, self.key)
                kind = msg.get("kind")
                if kind == "relay_hello":
                    rank = int(msg["rank"])
                    with self._state:
                        old = self._conns.get(rank)
                        self._conns[rank] = conn
                        if msg.get("local"):
                            self._local = max(1, int(msg["local"]))
                        self._state.notify_all()
                    if old is not None and old is not conn:
                        # Stale connection from a previous generation of
                        # this rank: retire it quietly (no peer_lost — the
                        # rank is alive, right here).
                        try:
                            old.close()
                        except OSError:
                            pass
                    coord = msg.get("coord")
                    if coord:
                        self._ensure_up((str(coord[0]), int(coord[1])))
                    self._declare_ranks()
                    _send_msg(conn, {"ok": 1}, self.key)
                elif kind == "exchange":
                    _send_msg(conn, self._relay_exchange(msg), self.key)
                elif kind in ("ring_hello", "ring_confirm"):
                    _send_msg(conn, self._relay_barrier(kind, msg), self.key)
                elif kind == "bye":
                    clean = True
                    return
                else:
                    # plane_fault / knob_change / clock_probe and anything
                    # future: one-for-one forwarding preserves semantics.
                    _send_msg(conn, self._upstream(msg), self.key)
        except (ConnectionError, EOFError, OSError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if rank is not None:
                with self._state:
                    if self._conns.get(rank) is conn:
                        del self._conns[rank]
                        self._state.notify_all()
                    else:
                        rank = None  # superseded connection: not a loss
            if rank is not None and not clean and not self._stop.is_set():
                # Exactly the flat-mode rung-3 signal, one rank wide.
                try:
                    self._upstream({"kind": "peer_lost", "lost": rank})
                except (ConnectionError, EOFError, OSError):
                    pass

    # -- upstream side

    def _ensure_up(self, coord: tuple[str, int]) -> None:
        with self._up_lock:
            if self._coord == coord and self._up is not None:
                return
            # New coordinator generation: drop the old upstream and any
            # coalescing state that referenced it.
            self._close_up(clean=True)
            self._coord = coord
        with self._state:
            self._batch = None
            self._barrier.clear()
            self._state.notify_all()

    def _dial(self) -> socket.socket:
        """Connect the primary upstream (caller holds _up_lock)."""
        if self._coord is None:
            raise ConnectionError("relay has no coordinator address yet")
        sock = socket.create_connection(self._coord, timeout=60)
        sock.settimeout(180)
        return sock

    def _declare_ranks(self) -> None:
        """Tell the coordinator which ranks live behind this connection —
        the unclean-drop failure domain (engine _serve relay_for)."""
        with self._state:
            ranks = set(self._conns)
        with self._up_lock:
            if not ranks - self._declared and self._up is not None:
                return
            try:
                if self._up is None:
                    self._up = self._dial()
                    self._declared.clear()
                self._m_up_out.inc(_send_msg(
                    self._up, {"kind": "relay_hello",
                               "ranks": sorted(ranks)}, self.key))
                _recv_msg(self._up, self.key)
                self._declared = ranks
            except (ConnectionError, EOFError, OSError) as e:
                self._upstream_lost(e)
                raise

    def _upstream(self, msg: dict) -> Any:
        """One request/response on the primary upstream connection."""
        with self._up_lock:
            try:
                if self._up is None:
                    self._up = self._dial()
                    self._declared.clear()
                self._m_up_out.inc(_send_msg(self._up, msg, self.key))
                return _recv_msg(self._up, self.key)
            except (ConnectionError, EOFError, OSError) as e:
                self._upstream_lost(e)
                raise

    def _upstream_lost(self, err: Exception) -> None:
        """Primary upstream died (caller holds _up_lock): close every local
        connection so ranks fail fast into the elastic reset instead of
        hanging on a relay that can no longer deliver."""
        self._close_up(clean=False)
        log("warning", f"[ctrl] relay lost its coordinator ({err}); "
                       "failing local control connections")
        with self._state:
            conns = list(self._conns.values())
            self._conns.clear()
            self._batch = None
            self._barrier.clear()
            self._state.notify_all()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass

    # -- exchange coalescing

    def _relay_exchange(self, msg: dict) -> dict:
        """Coalesce co-arriving exchange envelopes into one upstream
        batch_exchange; re-inflate hoisted response fields per rank."""
        item = {k: v for k, v in msg.items() if k != "kind"}
        rank = int(msg["rank"])
        with self._state:
            batch = self._batch
            if batch is None or batch["closed"]:
                batch = self._batch = {"items": [], "out": {}, "closed": False,
                                       "error": None,
                                       "done": threading.Event()}
                leader = True
            else:
                leader = False
            batch["items"].append((rank, item))
        if leader:
            if self.window_s > 0:
                self._stop.wait(self.window_s)
            with self._state:
                batch["closed"] = True
                if self._batch is batch:
                    self._batch = None
                items = list(batch["items"])
            try:
                resp = self._upstream({"kind": "batch_exchange",
                                       "items": [it for _r, it in items]})
                out_items = resp["items"]
                for field in ("knob", "plane"):
                    if field in resp:
                        for it in out_items:
                            it[field] = resp[field]
                for (r, _req), it in zip(items, out_items):
                    batch["out"][r] = it
                if len(items) > 1:
                    # Every envelope after the first rode the leader's
                    # upstream tick instead of its own root connection.
                    self._m_absorbed.inc(sum(
                        _wire_size(it) for _r, it in items[1:]))
            except (ConnectionError, EOFError, OSError) as e:
                batch["error"] = str(e)
            finally:
                batch["done"].set()
        else:
            batch["done"].wait(180.0)
        if batch["error"] is not None or rank not in batch["out"]:
            raise ConnectionError(
                batch["error"] or "relay batch lost this rank's response")
        return batch["out"][rank]

    # -- ring barriers

    def _relay_barrier(self, kind: str, msg: dict) -> dict:
        """Local-host barrier for ring_hello / ring_confirm: gather the
        host's full complement, one upstream batch, shared verdict out."""
        rank = int(msg["rank"])
        item = {k: v for k, v in msg.items() if k != "kind"}
        with self._state:
            bar = self._barrier.get(kind)
            if bar is None or bar["closed"]:
                bar = self._barrier[kind] = {
                    "items": {}, "shared": None, "closed": False,
                    "error": None, "done": threading.Event()}
            bar["items"][rank] = item
            leader = len(bar["items"]) == 1
            self._state.notify_all()
            if leader:
                # Wait for the host's declared complement; on timeout ship
                # what arrived — the coordinator's own 120 s world barrier
                # resolves stragglers (or fails establishment world-wide,
                # exactly as flat mode would).
                deadline = 115.0
                while (len(bar["items"]) < self._local
                       and not self._stop.is_set() and deadline > 0):
                    self._state.wait(0.2)
                    deadline -= 0.2
                bar["closed"] = True
                if self._barrier.get(kind) is bar:
                    del self._barrier[kind]
                items = [bar["items"][r] for r in sorted(bar["items"])]
        if leader:
            try:
                resp = self._upstream({"kind": "batch_" + kind,
                                       "items": items})
                bar["shared"] = resp["shared"]
                if len(items) > 1:
                    self._m_absorbed.inc(sum(
                        _wire_size(it) for it in items[1:]))
            except (ConnectionError, EOFError, OSError) as e:
                bar["error"] = str(e)
            finally:
                bar["done"].set()
        else:
            bar["done"].wait(150.0)
        if bar["error"] is not None or bar["shared"] is None:
            raise ConnectionError(
                bar["error"] or f"relay {kind} barrier did not resolve")
        return bar["shared"]
