"""Authenticated TCP service layer for the cluster launcher: the port's own
copy of ``horovod_tpu.runner.network``, with the same frames bit for bit,
so a client of either package talks to a service of the other.

Design taken from the reference's Spark network layer
(horovod/spark/util/network.py:44-117) — HMAC-SHA256 over pickled bodies,
verified before unpickling — hardened beyond it against replay:

- Per-connection handshake: the server sends a random session nonce; both
  sides derive a session key = HMAC(secret, nonce). A message captured on
  one connection fails authentication on every other connection.
- Per-message sequence numbers and a direction byte inside the MAC: a
  message replayed (or reflected) WITHIN its own connection also fails.
  (The reference's digest covers only the payload, so a passive observer
  who can inject TCP traffic could replay captured requests verbatim.)

The channel remains unencrypted: anyone on the network path can READ
messages (the reference's trust model too). Secrets therefore never ride
it — the per-job worker secret is derived independently on each side
(derive_key), not transmitted. Run agents only on networks where
eavesdropping is acceptable, exactly as you would treat rsh.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import pickle
import secrets as _secrets
import socket
import struct
import threading
import time
from typing import Any, Optional

from ..common import resilience


def make_secret() -> bytes:
    """Random shared secret (reference horovod/spark/secret.py)."""
    return _secrets.token_bytes(32)


def derive_key(key: bytes, purpose: bytes) -> bytes:
    """One-block HKDF-style derivation: a purpose-bound subkey of `key`.
    Used to mint per-job worker secrets from the agent secret on BOTH ends
    (driver and agent) so the job secret never crosses the unencrypted
    agent channel."""
    return hmac.new(key, b"hvd-derive:" + purpose, hashlib.sha256).digest()


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    # resilience.recv_exact: recv_into a preallocated buffer (the naive
    # bytes-+= loop is quadratic on MB-sized ring frames) PLUS the
    # escalation ladder's bottom rung — on sockets with a timeout set, each
    # idle deadline costs one retry from the HOROVOD_NETWORK_RETRIES budget
    # before the op fails; sockets without a timeout keep blocking forever
    # (idle request servers must). Returns the bytearray itself — hmac,
    # pickle.loads and np.frombuffer all take buffers.
    return resilience.recv_exact(sock, n)


# Unauthenticated bytes are buffered before the digest check; cap the claimed
# length so a secretless peer can't force unbounded allocation.
MAX_PAYLOAD = 256 * 1024 * 1024

_MAGIC = b"HVD2"
_NONCE_LEN = 16


class Channel:
    """One authenticated connection: session-keyed, sequence-numbered.

    Construction performs the handshake (server sends `HVD2` + nonce;
    both sides derive session_key = HMAC(secret, "hvd-session:"+nonce)).
    Each direction numbers its messages from 0 and the MAC covers
    (direction, seq, payload), so neither cross-connection replay nor
    in-connection replay/reflection authenticates.

    ``scope`` names what the channel carries ("ctl" control traffic,
    "ring" the eager engine's data-plane links) — it selects which
    channels the env-triggered network chaos hooks target
    (elastic/fault.py, HOROVOD_FAULT_NET) and costs nothing when injection
    is unarmed. ``send_bytes``/``recv_bytes`` move raw buffers (the eager
    ring's chunks) under the same session key and sequence numbers."""

    def __init__(self, sock: socket.socket, key: bytes, server: bool,
                 scope: str = "ctl") -> None:
        self.sock = sock
        self.scope = scope
        # Fault-injection hook (the chaos harness): resolved ONCE per
        # channel — None in production (one env check at construction), the
        # fault module when HOROVOD_FAULT_NET arms this process. Lazy
        # import: the elastic package imports the launcher, which imports
        # this module — at Channel-construction time the cycle is long
        # resolved.
        self._fault = None
        if os.environ.get("HOROVOD_FAULT_NET"):
            from ..elastic import fault as _fault_mod

            if _fault_mod.net_fault_armed():
                self._fault = _fault_mod
        # Tracing IO hook: when set, every raw frame's wire time is reported
        # as io_hook(direction, nbytes, t0_ns, t1_ns), direction "send" or
        # "recv". Measured around the socket calls, because the eager ring
        # sends from a queue and a thread. None costs one attribute check.
        self.io_hook = None
        # Wire accounting (the telemetry and control trees): every frame's
        # full on-the-wire size (MAC + length word + payload, plus the
        # handshake) is tallied so services can report ingest/egress bytes.
        # Two plain int adds per frame; no locking (a Channel is
        # single-owner per side).
        self.bytes_sent = 0
        self.bytes_received = 0
        if server:
            nonce = _secrets.token_bytes(_NONCE_LEN)
            sock.sendall(_MAGIC + nonce)
            self.bytes_sent += len(_MAGIC) + _NONCE_LEN
        else:
            try:
                head = _recv_exact(sock, len(_MAGIC) + _NONCE_LEN)
            except (TimeoutError, socket.timeout) as e:
                # An old (pre-HVD2) server sends nothing until it gets a
                # request, so a version-skewed peer surfaces as this read
                # timing out — name the likely cause instead of a bare
                # "timed out" (a non-hvd peer that sends bytes hits the
                # magic check below instead).
                raise ConnectionError(
                    "no session handshake from peer (timed out): it is "
                    "either not an hvd service or an older build without "
                    "replay protection — upgrade both ends") from e
            if head[: len(_MAGIC)] != _MAGIC:
                raise PermissionError(
                    "bad handshake magic: peer is not an hvd service")
            self.bytes_received += len(head)
            nonce = head[len(_MAGIC):]
        self._key = hmac.new(key, b"hvd-session:" + nonce,
                             hashlib.sha256).digest()
        self._send_dir = b"S" if server else b"C"
        self._recv_dir = b"C" if server else b"S"
        self._send_seq = 0
        self._recv_seq = 0

    def _mac(self, direction: bytes, seq: int, payload) -> bytes:
        # Incremental update: `payload` may be a large buffer — concatenating
        # would copy it just to hash it. Digest is identical to hashing
        # direction+seq+payload in one shot.
        h = hmac.new(self._key, None, hashlib.sha256)
        h.update(direction + struct.pack("!Q", seq))
        h.update(payload)
        return h.digest()

    def _inject_fault(self, nbytes: int = 0) -> Optional[str]:
        """Chaos hook (HOROVOD_FAULT_NET): decide and pre-apply this frame's
        injected fault. Returns "drop" when the frame must be swallowed
        (before the sequence number advances — the receiver then sees the
        NEXT frame early and fails the link, the broken-middlebox model);
        "corrupt" when the caller should flip a MAC byte; None otherwise.
        "delay" sleeps here (``nbytes`` feeds the bytes-proportional
        HOROVOD_FAULT_NET_DELAY_PER_MB term); "reset" abort-closes the
        socket (RST to the peer) and raises."""
        action = self._fault.net_fault(self.scope)
        if action == "delay":
            time.sleep(self._fault.net_fault_delay_s(nbytes))
            return None
        if action == "reset":
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                     struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass
            raise ConnectionResetError(
                "injected connection reset (HOROVOD_FAULT_NET=reset)")
        return action

    def send(self, obj: Any) -> None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        corrupt = False
        if self._fault is not None:
            action = self._inject_fault(len(payload))
            if action == "drop":
                # The dropped frame still consumes a sequence number — the
                # receiver authenticates the NEXT frame against the dropped
                # frame's seq and rejects it (a swallowed frame must surface
                # as a detected link fault, never as a silent substitution).
                self._send_seq += 1
                return
            corrupt = action == "corrupt"
        mac = self._mac(self._send_dir, self._send_seq, payload)
        if corrupt:
            mac = bytes([mac[0] ^ 0xFF]) + mac[1:]
        self._send_seq += 1
        resilience.send_all(
            self.sock, mac + struct.pack("!Q", len(payload)) + payload)
        self.bytes_sent += 32 + 8 + len(payload)

    def recv(self) -> Any:
        digest = _recv_exact(self.sock, 32)
        (n,) = struct.unpack("!Q", _recv_exact(self.sock, 8))
        if n > MAX_PAYLOAD:
            raise PermissionError(f"payload length {n} exceeds cap {MAX_PAYLOAD}")
        payload = _recv_exact(self.sock, n)
        if not hmac.compare_digest(
                digest, self._mac(self._recv_dir, self._recv_seq, payload)):
            resilience.frames_rejected_counter().inc()
            raise PermissionError(
                "HMAC digest mismatch: unauthenticated, replayed, or "
                "reordered message")
        self._recv_seq += 1
        self.bytes_received += 32 + 8 + n
        return pickle.loads(payload)

    # Raw-buffer frames: the eager ring's chunk bytes, whose shape and dtype
    # follow from protocol position, so pickling them buys nothing. Same
    # session key, sequence numbers and MAC, but a lower-case direction tag
    # separates raw frames from pickled ones: a captured raw frame never
    # authenticates where an object is expected, and raw frames are never
    # unpickled.

    def send_bytes(self, data) -> None:
        view = memoryview(data).cast("B")
        corrupt = False
        if self._fault is not None:
            action = self._inject_fault(len(view))
            if action == "drop":
                # Seq still advances, as in send().
                self._send_seq += 1
                return
            corrupt = action == "corrupt"
        mac = self._mac(self._send_dir.lower(), self._send_seq, view)
        if corrupt:
            mac = bytes([mac[0] ^ 0xFF]) + mac[1:]
        self._send_seq += 1
        hook = self.io_hook
        t0 = time.monotonic_ns() if hook else 0
        resilience.send_all(self.sock, mac + struct.pack("!Q", len(view)))
        resilience.send_all(self.sock, view)
        self.bytes_sent += 32 + 8 + len(view)
        if hook:
            hook("send", len(view), t0, time.monotonic_ns())

    def recv_bytes(self) -> bytearray:
        hook = self.io_hook
        t0 = time.monotonic_ns() if hook else 0
        digest = _recv_exact(self.sock, 32)
        (n,) = struct.unpack("!Q", _recv_exact(self.sock, 8))
        if n > MAX_PAYLOAD:
            raise PermissionError(f"payload length {n} exceeds cap {MAX_PAYLOAD}")
        payload = _recv_exact(self.sock, n)
        if not hmac.compare_digest(
                digest,
                self._mac(self._recv_dir.lower(), self._recv_seq, payload)):
            resilience.frames_rejected_counter().inc()
            raise PermissionError(
                "HMAC digest mismatch: unauthenticated, replayed, or "
                "reordered message")
        self._recv_seq += 1
        self.bytes_received += 32 + 8 + n
        if hook:
            hook("recv", n, t0, time.monotonic_ns())
        return payload

class BasicService:
    """Threaded request/response TCP server (reference BasicService,
    network.py:79-143). Subclasses implement handle(request) -> response."""

    def __init__(self, key: bytes, host: str = "0.0.0.0", port: int = 0) -> None:
        self.key = key
        self.server = socket.create_server((host, port))
        self.port = self.server.getsockname()[1]
        self._stop = threading.Event()
        # Service-level wire accounting (the telemetry and control trees):
        # totals across all connections, flushed from each Channel's
        # per-frame counters after every served request. stats() deltas
        # taken around a collection tick give the root's actual ingest per
        # tick.
        self._stats_lock = threading.Lock()
        self._bytes_in = 0
        self._bytes_out = 0
        self._connections_total = 0
        self._requests_total = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stats(self) -> dict:
        """Wire totals since construction: ``bytes_in``/``bytes_out`` (full
        frame sizes incl. MAC + length word + handshake), ``connections_total``
        accepted, ``requests_total`` served."""
        with self._stats_lock:
            return {
                "bytes_in": self._bytes_in,
                "bytes_out": self._bytes_out,
                "connections_total": self._connections_total,
                "requests_total": self._requests_total,
            }

    def addresses(self) -> list[tuple[str, int]]:
        """All reachable (ip, port) pairs for this service (reference probes
        every NIC, network.py:145-169)."""
        addrs = []
        hostname = socket.gethostname()
        try:
            for info in socket.getaddrinfo(hostname, None, socket.AF_INET):
                addrs.append((info[4][0], self.port))
        except socket.gaierror:
            pass
        addrs.append(("127.0.0.1", self.port))
        # dedupe, keep order
        seen = set()
        out = []
        for a in addrs:
            if a not in seen:
                seen.add(a)
                out.append(a)
        return out

    def handle(self, request: Any, client_addr) -> Any:  # pragma: no cover
        raise NotImplementedError

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self.server.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn, addr), daemon=True).start()

    def _serve(self, conn: socket.socket, addr) -> None:
        ch = None
        flushed_in = flushed_out = 0

        def _flush_stats() -> None:
            nonlocal flushed_in, flushed_out
            with self._stats_lock:
                self._bytes_in += ch.bytes_received - flushed_in
                self._bytes_out += ch.bytes_sent - flushed_out
            flushed_in = ch.bytes_received
            flushed_out = ch.bytes_sent

        try:
            ch = Channel(conn, self.key, server=True)
            with self._stats_lock:
                self._connections_total += 1
            while not self._stop.is_set():
                req = ch.recv()
                if isinstance(req, dict) and req.get("kind") == "clock_probe":
                    # Built-in NTP responder (tracing/clock.py): EVERY
                    # authenticated service answers its monotonic clock so
                    # the client side can align timestamps without each
                    # subclass re-implementing the exchange.
                    resp = {"ok": True, "t": time.monotonic_ns()}
                else:
                    resp = self.handle(req, addr)
                ch.send(resp)
                with self._stats_lock:
                    self._requests_total += 1
                _flush_stats()
        except (ConnectionError, OSError, EOFError, PermissionError):
            pass
        finally:
            if ch is not None:
                _flush_stats()
            try:
                conn.close()
            except OSError:
                pass
            self.on_disconnect(addr)

    def on_disconnect(self, client_addr) -> None:
        """Hook: called when an authenticated client's connection closes.
        The host agent uses this to tie job lifetime to the driver's
        connection — driver gone means its workers are reaped."""

    def stop(self) -> None:
        self._stop.set()
        try:
            self.server.close()
        except OSError:
            pass


class BasicClient:
    """Blocking request/response client with retry-capable connect.

    ``connect_retry_s`` > 0 keeps re-trying the full address list with the
    shared decorrelated-jitter backoff (common/resilience.py Backoff,
    capped at HOROVOD_NETWORK_BACKOFF_MAX_MS) for up to that many seconds
    before giving up — a cold-starting pod's workers register while the
    driver service may still be a few hundred ms from listening, and one
    refused connection must not kill the worker. A whole pod retrying in
    lockstep would hammer the driver at the same instants; the jitter
    decorrelates them."""

    def __init__(self, addresses, key: bytes, timeout: float = 60.0,
                 connect_retry_s: float = 0.0) -> None:
        self.key = key
        # One request = one send + one recv on the session channel, so a
        # client shared across threads must serialize whole requests —
        # interleaved sends would desequence the MAC.
        self._lock = threading.Lock()
        deadline = time.monotonic() + max(connect_retry_s, 0.0)
        backoff = resilience.Backoff(base_s=0.05)
        last: Optional[Exception] = None
        while True:
            for host, port in addresses:
                sock = None
                try:
                    sock = socket.create_connection((host, port), timeout=timeout)
                    sock.settimeout(timeout)
                    # The handshake does I/O: a failure here (bad magic from a
                    # non-hvd peer, timeout) must close the already-connected
                    # socket before trying the next address, or it leaks.
                    self._ch = Channel(sock, key, server=False)
                    self.sock = sock
                    return
                except OSError as e:
                    if sock is not None:
                        try:
                            sock.close()
                        except OSError:
                            pass
                    last = e
            if time.monotonic() >= deadline:
                break
            backoff.sleep()
        raise ConnectionError(f"cannot reach service at {addresses}: {last}")

    def request(self, obj: Any) -> Any:
        with self._lock:
            self._ch.send(obj)
            return self._ch.recv()

    def request_counted(self, obj: Any) -> tuple[Any, int, int]:
        """``request`` plus this exchange's on-the-wire byte counts
        ``(response, bytes_out, bytes_in)`` — the control tree's
        ``horovod_ctrl_bytes_total`` accounting reads them per upstream
        call instead of re-estimating frame overhead."""
        with self._lock:
            sent0 = self._ch.bytes_sent
            recv0 = self._ch.bytes_received
            self._ch.send(obj)
            resp = self._ch.recv()
            return (resp, self._ch.bytes_sent - sent0,
                    self._ch.bytes_received - recv0)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
