"""Per-host control leader for the runner plane: the port's own copy of
``horovod_tpu.ctrl.agent``, with the same protocol.

:class:`ControlAgent` is a transparent, aggregating proxy between a
host's ranks and the driver: ranks speak the EXACT driver protocol to
it (``register``/``rendezvous``, ``wait_assignment``, ``elastic_poll``,
``clock_probe``, anything else verbatim), and the agent folds that
traffic into one upstream connection:

- **register/rendezvous** arriving within one ``HOROVOD_CTRL_BATCH_S``
  window ride a single ``host_register`` request.
- **wait_assignment** waiters are grouped per target generation; ONE
  upstream ``host_wait_assignment`` long-poll resolves the whole
  host's waiters (latecomers trigger a follow-up for the remainder).
- **elastic_poll** is answered from a verdict cached for
  ``HOROVOD_CTRL_POLL_S``: the root sees one ``host_elastic_poll``
  per host per interval instead of one per rank per interval.
- **clock_probe** never leaves the host (BasicService built-in).
- **ckpt_manifest/ckpt_fetch** serve the latest committed checkpoint
  shards to streaming cold-starters (ckpt_async/stream.py).

Because every aggregated request routes through the driver's OWN
per-rank handlers (runner/service.py ``host_*`` kinds loop the flat
handlers), the tree preserves the flat protocol's semantics: removed
slots still answer ``{"ok": False, "removed": True}``, stale
generations still bounce, and a rank that skips the tree entirely
behaves identically.

Like the telemetry agent, it is normally hosted by the runner
HostAgent under the job-derived secret (``kind="ctrl"`` command), so
the ranks' existing ``HOROVOD_SECRET`` authenticates them to it.

``horovod_ctrl_bytes_total{dir=...}`` counts the tree's economics:
``up_out``/``up_in`` are measured upstream wire bytes, ``absorbed`` is
the flat-equivalent wire size of rank requests answered at this leader
without an upstream exchange — the savings the O(hosts) claim is made
of.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
import zlib
from typing import Any, Optional

from ..metrics.registry import MetricsRegistry, registry
from ..runner.network import BasicClient, BasicService
from .tree import ctrl_batch_s, ctrl_poll_s

#: per-frame wire overhead of one request/response pair on the
#: authenticated channel (2 × (32 B MAC + 8 B length)) — used to price
#: locally-absorbed requests in flat-equivalent bytes.
FRAME_OVERHEAD = 2 * (32 + 8)


def _flat_bytes(req: Any, resp: Any = None) -> int:
    """Flat-equivalent wire size of a request (+ optional response) had
    it crossed to the root directly."""
    n = len(pickle.dumps(req, protocol=pickle.HIGHEST_PROTOCOL))
    if resp is not None:
        n += len(pickle.dumps(resp, protocol=pickle.HIGHEST_PROTOCOL))
    return n + FRAME_OVERHEAD


class ControlAgent(BasicService):
    """One host's control-plane leader (see module docstring)."""

    def __init__(self, key: bytes, host_name: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 ckpt_dir: Optional[str] = None,
                 batch_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 reg: Optional[MetricsRegistry] = None) -> None:
        super().__init__(key, host=host, port=port)
        from ..runner.service import host_hash

        self.host_name = host_name or host_hash()
        self.ckpt_dir = ckpt_dir if ckpt_dir is not None \
            else os.environ.get("HOROVOD_CKPT_STREAM_DIR", "")
        self.batch_s = float(batch_s) if batch_s is not None else ctrl_batch_s()
        self.poll_s = float(poll_s) if poll_s is not None else ctrl_poll_s()
        self.reg = reg or registry()
        # upstream (leader → root). TWO connections per leader — still
        # O(hosts) at the root: the wait client carries only the blocking
        # grouped assignment polls, so a register batch or elastic poll is
        # never queued behind a wait that needs that very registration to
        # resolve (requests on one BasicClient serialize).
        self._root_lock = threading.Lock()
        self._root_client: Optional[BasicClient] = None
        self._wait_client: Optional[BasicClient] = None
        self._up_requests = 0
        # rank indices this leader has seen (register/hello/wait) — the
        # index set one cached elastic poll answers for.
        self._known_lock = threading.Lock()
        self._known_indices: set[int] = set()
        # register micro-batch (one in flight at a time; next opens fresh)
        self._reg_lock = threading.Lock()
        self._reg_batch: Optional[dict] = None
        # wait_assignment groups keyed by min_generation (None = static)
        self._wait_lock = threading.Lock()
        self._wait_cv = threading.Condition(self._wait_lock)
        self._wait_groups: dict = {}
        # elastic-poll verdict cache
        self._poll_lock = threading.Lock()
        self._poll_fetch_lock = threading.Lock()
        self._poll_cache: Optional[dict] = None
        # Engine-plane relay (ctrl/relay.py), keyed as the workers' engines
        # key their coordinator frames: with the text of HOROVOD_SECRET,
        # which the launcher sets to this job secret's hex (the JAX package
        # keys its relay with the raw secret, which no worker's engine
        # frame authenticates under). Started by the first relay_port(): the
        # hvd-agent calls it when a ctrl start asks for the relay, as the
        # launcher and the elastic driver do for every job on the tree.
        self._relay_lock = threading.Lock()
        self._relay: Optional[Any] = None

    def relay_port(self) -> int:
        """Start (once) and return the engine coordinator relay's port."""
        with self._relay_lock:
            if self._relay is None:
                from .relay import CoordRelay

                self._relay = CoordRelay(self.key.hex().encode())
            return self._relay.port

    def relay_running(self) -> bool:
        """Whether :meth:`relay_port` has started the relay."""
        with self._relay_lock:
            return self._relay is not None

    # -- upstream ------------------------------------------------------------

    def attach_root(self, addresses, key: Optional[bytes] = None) -> None:
        """Connect this leader to the driver service. Socket timeout must
        out-wait the driver's 120 s assignment window (TaskAgent uses the
        same margin)."""
        client = BasicClient(addresses, key or self.key, timeout=180.0,
                             connect_retry_s=30.0)
        wait_client = BasicClient(addresses, key or self.key, timeout=180.0,
                                  connect_retry_s=30.0)
        with self._root_lock:
            old = (self._root_client, self._wait_client)
            self._root_client, self._wait_client = client, wait_client
        for c in old:
            if c is not None:
                try:
                    c.close()
                except Exception:
                    pass

    def has_root(self) -> bool:
        """True once :meth:`attach_root` connected this leader upstream —
        the gate HostAgent._spawn uses before pointing workers here."""
        with self._root_lock:
            return self._root_client is not None

    def _bytes_c(self, direction: str):
        return self.reg.counter(
            "horovod_ctrl_bytes_total",
            help="control-tree wire accounting: measured leader-to-root "
                 "bytes (up_out/up_in), flat-equivalent bytes answered at "
                 "a host leader without an upstream exchange (absorbed), "
                 "and per-host response fields hoisted out of batched "
                 "coordinator replies (hoisted)",
            dir=direction)

    def _upstream(self, req: Any, wait: bool = False) -> Any:
        """One upstream exchange. ``wait=True`` routes over the dedicated
        blocking-wait connection (see __init__)."""
        with self._root_lock:
            client = self._wait_client if wait else self._root_client
        if client is None:
            return {"ok": False, "error": "control agent has no root "
                                          "attached"}
        resp, out_b, in_b = client.request_counted(req)
        self._bytes_c("up_out").inc(out_b)
        self._bytes_c("up_in").inc(in_b)
        with self._root_lock:
            self._up_requests += 1
        return resp

    def upstream_requests(self) -> int:
        with self._root_lock:
            return self._up_requests

    # -- protocol ------------------------------------------------------------

    def handle(self, req: Any, client_addr) -> Any:
        kind = req.get("kind")
        if kind == "ctrl_hello":
            if req.get("index") is not None:
                with self._known_lock:
                    self._known_indices.add(int(req["index"]))
            return {"ok": True, "host": self.host_name,
                    "poll_s": self.poll_s, "batch_s": self.batch_s}
        if kind in ("register", "rendezvous"):
            return self._register(req)
        if kind == "wait_assignment":
            return self._wait_assignment(req)
        if kind == "elastic_poll":
            return self._elastic_poll(req)
        if kind == "ctrl_stats":
            return {"ok": True, "host": self.host_name,
                    "stats": self.stats(),
                    "upstream_requests": self.upstream_requests()}
        if kind == "ckpt_manifest":
            from ..ckpt_async import stream

            return stream.serve_manifest(self.ckpt_dir)
        if kind == "ckpt_fetch":
            from ..ckpt_async import stream

            return stream.serve_chunk(self.ckpt_dir, req)
        # Everything else — results, metrics pushes, get_fn, telemetry —
        # passes through verbatim on the shared upstream connection, so a
        # worker pointed at the tree never needs a second address.
        return self._upstream(req)

    # -- register micro-batch ------------------------------------------------

    def _register(self, req: dict) -> Any:
        if req.get("index") is not None:
            with self._known_lock:
                self._known_indices.add(int(req["index"]))
        with self._reg_lock:
            batch = self._reg_batch
            leader = batch is None
            if leader:
                batch = self._reg_batch = {"entries": [],
                                           "done": threading.Event(),
                                           "result": None}
            batch["entries"].append(dict(req))
        if not leader:
            batch["done"].wait(timeout=self.batch_s + 120.0)
            resp = batch["result"]
            # This rank's request never crossed to the root itself.
            self._bytes_c("absorbed").inc(_flat_bytes(req, {"ok": True}))
            return dict(resp) if isinstance(resp, dict) \
                else {"ok": False, "error": "batched register failed"}
        time.sleep(self.batch_s)
        with self._reg_lock:
            self._reg_batch = None   # snapshot + close in one critical section
            entries = list(batch["entries"])
        resp = self._upstream(self._pack_register(entries))
        batch["result"] = resp if isinstance(resp, dict) else {"ok": False}
        batch["done"].set()
        return dict(batch["result"])

    def _pack_register(self, entries: list) -> dict:
        """One host's registrations are highly redundant (same host_hash,
        same address prefixes, same field names), so the batch ships
        zlib-compressed when that wins; the driver re-inflates
        (service.py host_register). The eliminated bytes land in
        ``horovod_ctrl_bytes_total{dir="hoisted"}``."""
        raw = pickle.dumps(entries, protocol=pickle.HIGHEST_PROTOCOL)
        z = zlib.compress(raw, 6)
        if len(z) >= len(raw):
            return {"kind": "host_register", "entries": entries}
        self._bytes_c("hoisted").inc(len(raw) - len(z))
        return {"kind": "host_register", "entries_z": z}

    # -- grouped assignment waits --------------------------------------------

    def _wait_assignment(self, req: dict) -> Any:
        index = int(req["index"])
        min_gen = req.get("min_generation")
        timeout = float(req.get("timeout", 120.0))
        deadline = time.monotonic() + timeout
        with self._known_lock:
            self._known_indices.add(index)
        with self._wait_cv:
            g = self._wait_groups.get(min_gen)
            if g is None or g.get("closed"):
                g = self._wait_groups[min_gen] = {
                    "indices": set(), "results": {}, "closed": False,
                    "deadline": deadline, "running": False,
                }
            g["indices"].add(index)
            g["deadline"] = max(g["deadline"], deadline)
            if not g["running"]:
                g["running"] = True
                threading.Thread(target=self._wait_leader,
                                 args=(min_gen, g),
                                 name="hvd_ctrl_wait", daemon=True).start()
            else:
                self._bytes_c("absorbed").inc(_flat_bytes(req))
            while index not in g["results"] \
                    and time.monotonic() < deadline and not g["closed"]:
                self._wait_cv.wait(0.2)
            res = g["results"].get(index)
        if res is None:
            return {"ok": False,
                    "error": "timed out waiting for assignment via the "
                             "control tree"}
        return res

    #: Upstream poll bound for grouped assignment waits. The waits ride a
    #: dedicated connection (so a straggler's register batch never queues
    #: behind a wait that needs that registration to resolve), and each
    #: poll is additionally bounded so a driver that dies mid-formation
    #: is noticed within seconds, not at the 120 s assignment window.
    WAIT_POLL_S = 2.0

    def _wait_leader(self, min_gen, g: dict) -> None:
        """One upstream poll resolves every local waiter; loops while
        unresolved indices remain (latecomers within the group's window)."""
        time.sleep(self.batch_s)   # let the host's other ranks join
        try:
            while True:
                with self._wait_cv:
                    pend = sorted(g["indices"] - set(g["results"]))
                    remaining = g["deadline"] - time.monotonic()
                if not pend or remaining <= 0:
                    return
                up: dict = {"kind": "host_wait_assignment", "indices": pend,
                            "timeout": min(remaining, self.WAIT_POLL_S),
                            "z": True}
                if min_gen is not None:
                    up["min_generation"] = min_gen
                resp = self._upstream(up, wait=True)
                got: dict = {}
                if isinstance(resp, dict):
                    if resp.get("assignments_z") is not None:
                        # compressed batch reply (service.py) — the
                        # per-rank assignments share topology fields and
                        # coordinator addresses, so the batch deflates
                        # well below flat per-rank responses.
                        raw = zlib.decompress(resp["assignments_z"])
                        got = pickle.loads(raw)
                        self._bytes_c("hoisted").inc(
                            len(raw) - len(resp["assignments_z"]))
                    else:
                        got = resp.get("assignments") or {}
                adopted = 0
                with self._wait_cv:
                    for i, a in got.items():
                        # Only terminal answers reach waiters: an
                        # assignment, or a definitive removal. A per-index
                        # poll timeout ("ok": False without "removed") just
                        # means the world hasn't formed within this short
                        # poll — retry, don't fail the rank.
                        if isinstance(a, dict) and (a.get("ok")
                                                    or a.get("removed")):
                            g["results"][int(i)] = a
                            adopted += 1
                    self._wait_cv.notify_all()
                if not adopted:
                    time.sleep(min(0.5, self.batch_s * 2))
        finally:
            with self._wait_cv:
                g["closed"] = True
                if self._wait_groups.get(min_gen) is g:
                    del self._wait_groups[min_gen]
                self._wait_cv.notify_all()

    # -- cached elastic polls ------------------------------------------------

    def _elastic_poll(self, req: dict) -> Any:
        index = int(req["index"])
        gen = req.get("generation", 0)
        with self._known_lock:
            self._known_indices.add(index)
            indices = sorted(self._known_indices)
        now = time.monotonic()
        with self._poll_lock:
            c = self._poll_cache
            fresh = (c is not None and c["generation"] == gen
                     and now - c["t"] < self.poll_s)
        if not fresh:
            with self._poll_fetch_lock:
                with self._poll_lock:   # another thread may have refreshed
                    c = self._poll_cache
                    fresh = (c is not None and c["generation"] == gen
                             and time.monotonic() - c["t"] < self.poll_s)
                if not fresh:
                    resp = self._upstream({"kind": "host_elastic_poll",
                                           "indices": indices,
                                           "generation": gen})
                    if not (isinstance(resp, dict) and resp.get("ok")):
                        # Root unreachable: report "no change" like the flat
                        # path's error handling (elastic/run.py) does.
                        return {"ok": False,
                                "error": "control-tree poll failed"}
                    c = {"t": time.monotonic(), "generation": gen,
                         "reset": bool(resp.get("reset_required")),
                         "removed": set(resp.get("removed") or ())}
                    with self._poll_lock:
                        self._poll_cache = c
        else:
            self._bytes_c("absorbed").inc(
                _flat_bytes(req, {"ok": True, "reset_required": False}))
        return {"ok": True,
                "reset_required": bool(c["reset"] or index in c["removed"])}

    def stop(self) -> None:
        with self._relay_lock:
            relay, self._relay = self._relay, None
        if relay is not None:
            try:
                relay.stop()
            except Exception:
                pass
        with self._root_lock:
            clients = (self._root_client, self._wait_client)
            self._root_client = self._wait_client = None
        for client in clients:
            if client is not None:
                try:
                    client.close()
                except Exception:
                    pass
        super().stop()
