"""Driver/task services for cluster launch: the port's own copy of
``horovod_tpu.runner.service``, speaking the same protocol.

The reference's Spark launcher (SURVEY.md §2.6, §3.4) is a driver TCP service
that collects task registrations, assigns ranks by host, and ships a pickled
function to each task; task services run the command and report results
(horovod/spark/driver/driver_service.py, horovod/spark/task/task_service.py).
Here the same protocol launches training without Spark or mpirun: one
task agent per worker registers with the driver; the driver assigns
ranks (barrel-shift so rank 0 lands on the first host, reference
spark/__init__.py:143-152), distributes the coordinator address, and
collects per-rank results. The coordinator address it hands out is where
rank 0 binds the ``torch.distributed`` rendezvous store (``init`` reads
``HOROVOD_COORD_ADDR``).
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import threading
import time
import zlib
from typing import Any, Callable, Optional

from .network import BasicClient, BasicService


def worker_addresses() -> list:
    """The control-plane address list a spawned worker should dial:
    ``HOROVOD_CTRL_ADDRS`` — the host's ControlAgent leader, injected by
    HostAgent._spawn when the job runs a control tree — when present, else
    ``HOROVOD_DRIVER_ADDRS`` (the driver directly, the flat star). Empty
    list when neither is set (not a launched worker)."""
    raw = os.environ.get("HOROVOD_CTRL_ADDRS") \
        or os.environ.get("HOROVOD_DRIVER_ADDRS")
    return [tuple(a) for a in json.loads(raw)] if raw else []


class WorkerRemovedError(RuntimeError):
    """This worker's slot was dropped from the elastic membership (dead
    slot replaced, host blacklisted, or scale-down): exit instead of
    waiting for an assignment that will never come."""


def ship_fn(fn: Optional[Callable], args: tuple, kwargs: dict) -> bytes:
    """``(fn, args, kwargs)`` pickled for the workers: by value with
    cloudpickle where it is installed (reference CodeRequest +
    horovod/spark/codec.py), else with pickle, which sends a function by
    its import path only. Raises ``TypeError`` naming the cause when
    neither can ship ``fn``."""
    try:
        import cloudpickle as _pickler
    except ImportError:
        _pickler = None
    try:
        return (_pickler or pickle).dumps((fn, args, kwargs))
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        if _pickler is not None:
            raise TypeError(f"cannot ship the launched function {fn!r} "
                            f"with cloudpickle: {e}") from e
        raise TypeError(
            f"cannot ship the launched function {fn!r}: cloudpickle is not "
            "installed, so run(fn)/run_elastic(fn) send it with pickle, "
            "which sends a function by its import path only. Pass a "
            "module-level function of a module the workers can import (on "
            f"their PYTHONPATH), not a closure or a lambda ({e})") from e


class DriverService(BasicService):
    """Rank-assignment + function-distribution service (reference
    driver_service.py:98-234). ``fn`` is pickled here, once, so a function
    that cannot be shipped fails the launch before any worker starts."""

    def __init__(self, num_proc: int, key: bytes, fn: Optional[Callable] = None,
                 args: tuple = (), kwargs: Optional[dict] = None) -> None:
        self.num_proc = num_proc
        self.fn = fn
        self.args = args
        self.kwargs = kwargs or {}
        self._fn_payload = ship_fn(fn, self.args, self.kwargs)
        super().__init__(key)
        # Reentrant: wait_results holds the condition's lock while polling
        # liveness(), and the liveness closure reads driver state through
        # result_pending_index — a plain Lock would self-deadlock there.
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._registrations: dict[int, dict] = {}   # index -> {host_hash, addresses}
        self._ranks: Optional[dict[int, int]] = None  # index -> rank
        self._results: dict[int, Any] = {}
        # rank -> latest metrics snapshot (pushed mid-run via the `metrics`
        # request or attached to the final result payload); rank 0 of the
        # control plane — this driver — merges them into the pod view.
        self._metrics: dict[int, dict] = {}
        # Telemetry-tree root: host leaders push MERGED host partials via
        # `host_metrics` instead of every rank pushing its own snapshot —
        # root connections and bytes per tick become O(hosts). Created
        # lazily on the first leader push so flat (tree-less) jobs pay
        # nothing.
        self._telemetry: Optional[Any] = None
        self.coord_addr: Optional[str] = None

    def telemetry_root(self):
        """The tree root aggregator (telemetry/root.py), created on first
        use — also the launcher's handle for staleness/coverage views."""
        with self._lock:
            if self._telemetry is None:
                from ..telemetry.root import RootAggregator

                self._telemetry = RootAggregator()
            return self._telemetry

    # -- protocol

    def handle(self, req: Any, client_addr) -> Any:
        kind = req.get("kind")
        if kind == "register":
            with self._cv:
                self._registrations[req["index"]] = {
                    "host_hash": req["host_hash"],
                    "addresses": req["addresses"],
                    "coord_port": req.get("coord_port", 0),
                }
                if len(self._registrations) == self.num_proc:
                    self._assign_ranks()
                self._cv.notify_all()
            return {"ok": True}
        if kind == "wait_assignment":
            with self._cv:
                deadline = time.monotonic() + req.get("timeout", 120.0)
                while self._ranks is None and time.monotonic() < deadline:
                    self._cv.wait(0.5)
                if self._ranks is None:
                    return {"ok": False, "error": "timed out waiting for all tasks"}
                rank = self._ranks[req["index"]]
                topo = self._topology(req["index"], rank)
                return {"ok": True, "rank": rank, "topology": topo,
                        "coord_addr": self.coord_addr}
        if kind == "get_fn":
            return {"ok": True, "fn": self._fn_payload}
        if kind == "result":
            with self._cv:
                self._results[req["rank"]] = req["value"]
                value = req["value"]
                if isinstance(value, dict) and isinstance(
                        value.get("metrics"), dict):
                    self._metrics[req["rank"]] = value["metrics"]
                self._cv.notify_all()
            return {"ok": True}
        if kind == "metrics":
            # Mid-run snapshot push (TaskAgent.report_metrics): latest wins.
            with self._cv:
                self._metrics[req["rank"]] = req["snapshot"]
            return {"ok": True}
        if kind == "host_metrics":
            # Telemetry-tree leader push: one MERGED host partial (delta-
            # compressed) per host per collection tick (telemetry/agent.py
            # push_to_root_once → telemetry/root.py ingest).
            return self.telemetry_root().ingest(req)
        if kind == "clock_probe":
            # Distributed-tracing clock alignment (tracing/clock.py): one
            # NTP-style round trip — the caller brackets this response with
            # its own monotonic readings and estimates its offset to the
            # driver clock. Stateless, so it needs no lock.
            return {"ok": True, "t": time.monotonic_ns()}
        # Control-tree leader requests (ctrl/agent.py): one host leader
        # carries its ranks' registrations and assignment waits in a single
        # request, so root connections and control bytes stay O(hosts).
        # Each entry routes through the SAME per-rank handlers (subclass
        # dispatch included), so the tree path cannot drift from the flat
        # protocol's semantics.
        if kind == "host_register":
            entries = req.get("entries") or []
            if req.get("entries_z") is not None:
                # Compressed batch (ctrl/agent.py _pack_register). Nested
                # pickle adds no new trust surface: the outer frame is
                # already pickle under the same HMAC key.
                entries = pickle.loads(zlib.decompress(req["entries_z"]))
            for e in entries:
                self.handle(dict(e, kind=e.get("kind", "register")),
                            client_addr)
            return {"ok": True, "count": len(entries)}
        if kind == "host_wait_assignment":
            out: dict[int, Any] = {}
            sub_base: dict[str, Any] = {"kind": "wait_assignment"}
            if req.get("min_generation") is not None:
                sub_base["min_generation"] = req["min_generation"]
            # Sequential per-index waits share one formation event AND one
            # deadline: the first blocks until ranks are assigned, the rest
            # return immediately (removed indices answer without waiting at
            # all). The shared deadline bounds the WHOLE request to the
            # leader's timeout — per-index budgets would stack when the
            # world hasn't formed, holding the leader's serialized upstream
            # connection for indices × timeout.
            deadline = time.monotonic() + float(req.get("timeout", 120.0))
            for index in req.get("indices") or []:
                out[int(index)] = self.handle(
                    dict(sub_base, index=index,
                         timeout=max(0.0, deadline - time.monotonic())),
                    client_addr)
            if req.get("z"):
                # The host's assignments repeat topology fields and
                # coordinator addresses — deflate the batch when it wins
                # (the leader re-inflates and counts the saving).
                raw = pickle.dumps(out, protocol=pickle.HIGHEST_PROTOCOL)
                z = zlib.compress(raw, 6)
                if len(z) < len(raw):
                    return {"ok": True, "assignments_z": z}
            return {"ok": True, "assignments": out}
        return {"ok": False, "error": f"unknown request {kind}"}

    # -- rank assignment (reference spark/__init__.py:143-152)

    def _assign_ranks(self) -> None:
        by_host: dict[str, list[int]] = {}
        for index in sorted(self._registrations):
            by_host.setdefault(self._registrations[index]["host_hash"], []).append(index)
        # barrel shift: hosts ordered by hash, rank 0 on the first host
        ranks: dict[int, int] = {}
        rank = 0
        for host in sorted(by_host):
            for index in by_host[host]:
                ranks[index] = rank
                rank += 1
        self._ranks = ranks
        # Coordinator = rank-0's host on the port that task probed free
        # locally. Prefer a non-loopback address when the job spans hosts
        # (127.x from /etc/hosts would be unreachable from other machines).
        rank0_index = next(i for i, r in ranks.items() if r == 0)
        reg = self._registrations[rank0_index]
        addrs = [a for a, _ in reg["addresses"]]
        multi_host = len(by_host) > 1
        host = next((a for a in addrs if not a.startswith("127.")), addrs[0]) \
            if multi_host else next((a for a in addrs if a.startswith("127.")), addrs[0])
        port = reg["coord_port"] or _free_port()
        self.coord_addr = f"{host}:{port}"

    def _topology(self, index: int, rank: int) -> dict:
        host = self._registrations[index]["host_hash"]
        local = [i for i in sorted(self._registrations)
                 if self._registrations[i]["host_hash"] == host]
        hosts = sorted({r["host_hash"] for r in self._registrations.values()})
        return {
            "rank": rank,
            "size": self.num_proc,
            "local_rank": local.index(index),
            "local_size": len(local),
            "cross_rank": hosts.index(host),
            "cross_size": len(hosts),
        }

    # -- driver-side helpers

    def wait_results(self, timeout: float = 600.0,
                     liveness: Optional[Callable[[], Optional[str]]] = None
                     ) -> dict[int, Any]:
        """Collect one result per rank. ``liveness`` (if given) is polled each
        tick and may return an error string to abort early (dead worker)."""
        def raise_failures(results: dict) -> None:
            failures = {r: v["error"] for r, v in results.items()
                        if isinstance(v, dict) and not v.get("ok", True)}
            if failures:
                rank, tb = sorted(failures.items())[0]
                raise RuntimeError(
                    f"task on rank {rank} failed"
                    f" (and {len(failures) - 1} more):\n{tb}")

        with self._cv:
            deadline = time.monotonic() + timeout
            while len(self._results) < self.num_proc:
                # Fail fast WITH the remote traceback: a failed rank reports
                # its error result before exiting, so check results before
                # the liveness poll — otherwise the poll wins the race and
                # reports a bare "exited with code 1", discarding the
                # traceback the worker already delivered.
                raise_failures(self._results)
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"only {len(self._results)}/{self.num_proc} results arrived")
                if liveness is not None:
                    dead = liveness()
                    if dead:
                        raise RuntimeError(dead)
                self._cv.wait(0.5)
            results = dict(self._results)
        raise_failures(results)
        return {r: (v["value"] if isinstance(v, dict) and "value" in v else v)
                for r, v in results.items()}

    def pod_metrics(self) -> Optional[dict]:
        """Pod-wide merge of the telemetry collected so far — host partials
        pushed by telemetry-tree leaders (``host_metrics``) plus per-rank
        snapshots pushed directly (``metrics`` / final result payloads);
        None when nothing has reported. A rank covered by a host partial is
        never double-counted against its own direct push, and because the
        merge is associative with exact sums (metrics/aggregate.py), the
        result is bitwise what the flat all-ranks merge would produce."""
        with self._lock:
            snaps = {r: s for r, s in self._metrics.items()
                     if 0 <= r < self.num_proc}
            telemetry = self._telemetry
        host_parts: list = []
        covered: set = set()
        if telemetry is not None:
            covered = telemetry.covered_ranks()
            host_parts = telemetry.partials()
            # Readers drive staleness refresh: a host that went silent only
            # ages through here (its own pushes obviously stopped).
            telemetry.publish()
        if not snaps and not host_parts:
            return None
        from ..metrics.aggregate import (
            finalize_partial,
            lift_snapshot,
            merge_partials,
        )

        # Combine in global rank order (host partials slot in at their
        # lowest member rank) so bucket first-seen order matches the flat
        # merge exactly.
        keyed = [(min((int(r) for r in p.get("rank_ids", [])),
                      default=self.num_proc), p) for p in host_parts]
        keyed += [(r, lift_snapshot(r, s)) for r, s in sorted(snaps.items())
                  if r not in covered]
        keyed.sort(key=lambda kv: kv[0])
        part = merge_partials([p for _, p in keyed])
        part["ranks"] = max(int(self.num_proc), int(part["ranks"]))
        return finalize_partial(part)

    def result_pending_index(self, index: int) -> bool:
        """True while no result has arrived for the worker at task ``index``
        — the liveness check uses this to catch a worker that exits with
        code 0 WITHOUT reporting (previously invisible: ``rc not in (None,
        0)`` never flags a clean exit, so the driver blocked for the full
        timeout)."""
        with self._lock:
            if self._ranks is None:
                return True  # exited before the world even formed
            rank = self._ranks.get(index)
            return rank is None or rank not in self._results


class ElasticDriverService(DriverService):
    """Driver service for elastic jobs: membership is a
    sequence of *generations* instead of one fixed world.

    Protocol deltas over :class:`DriverService`:

    - ``register``/``rendezvous`` (same fields) record a registration for
      the generation being *formed*; the launcher declares the expected
      member set with :meth:`begin_reset` and the service assigns ranks the
      moment every expected member has (re-)registered.
    - ``wait_assignment`` blocks until this index's registration was
      consumed into a formed generation, and the response carries the
      ``generation`` counter; an index dropped from membership (dead slot,
      blacklisted host) gets ``{"ok": False, "removed": True}`` so the
      worker can exit instead of waiting forever.
    - ``result`` is accepted only for the current generation (a worker
      failing mid-reset with a stale view must not poison the new world);
      payloads carry the worker's task ``index`` alongside its rank.
    - ``elastic_poll`` is the cheap commit-time check workers use to learn
      that membership changed (host added/removed by discovery) and a
      reset is wanted even though no collective failed.

    Rank assignment orders members oldest-generation-first, so rank 0 is
    always a survivor carrying the last committed state — the root of the
    post-reset state broadcast (elastic/state.py sync())."""

    def __init__(self, key: bytes, fn: Optional[Callable] = None,
                 args: tuple = (), kwargs: Optional[dict] = None) -> None:
        super().__init__(0, key, fn=fn, args=args, kwargs=kwargs)
        self.generation = 0                 # formed generations so far
        self._forming = False               # begin_reset called, not yet formed
        self._expected: set[int] = set()    # indices the forming gen waits for
        self._pending: dict[int, dict] = {}   # fresh registrations by index
        self._reg_waiting: set[int] = set()   # registered, not yet assigned
        self._assign: dict[int, dict] = {}    # index -> current assignment
        self._member_since: dict[int, int] = {}   # index -> first generation
        self._removed: set[int] = set()     # indices dropped from membership

    # -- protocol

    def handle(self, req: Any, client_addr) -> Any:
        kind = req.get("kind")
        if kind in ("register", "rendezvous"):
            with self._cv:
                self._pending[req["index"]] = {
                    "host_hash": req["host_hash"],
                    "addresses": req["addresses"],
                    "coord_port": req.get("coord_port", 0),
                }
                self._reg_waiting.add(req["index"])
                self._removed.discard(req["index"])  # re-admitted slot
                self._maybe_form()
                self._cv.notify_all()
            return {"ok": True}
        if kind == "wait_assignment":
            index = req["index"]
            min_gen = req.get("min_generation", 1)
            with self._cv:
                deadline = time.monotonic() + req.get("timeout", 120.0)
                while time.monotonic() < deadline:
                    if index in self._removed:
                        return {"ok": False, "removed": True,
                                "error": f"task {index} was removed from the "
                                         "elastic job (dead slot or "
                                         "blacklisted host)"}
                    a = self._assign.get(index)
                    if a is not None and index not in self._reg_waiting \
                            and a["generation"] >= min_gen:
                        return a
                    self._cv.wait(0.5)
                return {"ok": False,
                        "error": "timed out waiting for elastic rendezvous"}
        if kind == "result":
            with self._cv:
                gen = req.get("generation", 0)
                if gen == self.generation and not self._forming:
                    self._results[req["rank"]] = req["value"]
                    value = req["value"]
                    if isinstance(value, dict) and isinstance(
                            value.get("metrics"), dict):
                        self._metrics[req["rank"]] = value["metrics"]
                    self._cv.notify_all()
                # stale-generation results are dropped: that worker is about
                # to rendezvous (or be removed) — its view of ranks is dead
            return {"ok": True}
        if kind == "elastic_poll":
            with self._cv:
                reset = (self._forming
                         or req.get("generation", 0) != self.generation
                         or req["index"] in self._removed)
            return {"ok": True, "reset_required": reset}
        if kind == "host_elastic_poll":
            # Control-tree batched poll: one request answers a whole host's
            # commit-time membership checks. The leader caches this verdict
            # for HOROVOD_CTRL_POLL_S, so the root sees one poll per host
            # per interval instead of one per rank.
            with self._cv:
                gen = self.generation
                reset = self._forming or req.get("generation", 0) != gen
                removed = sorted(i for i in (req.get("indices") or [])
                                 if i in self._removed)
            return {"ok": True, "reset_required": bool(reset),
                    "generation": gen, "removed": removed}
        return super().handle(req, client_addr)

    # -- membership (launcher side)

    def begin_reset(self, expected: set) -> None:
        """Open the next generation: wait for a fresh registration from every
        index in ``expected``; everything previously known but absent from
        ``expected`` is marked removed. Idempotent per membership set."""
        with self._cv:
            expected = set(expected)
            gone = (set(self._member_since) | set(self._pending)) - expected
            self._removed |= gone
            for i in gone:
                self._pending.pop(i, None)
                self._reg_waiting.discard(i)
            self._expected = expected
            self._forming = True
            self._maybe_form()
            self._cv.notify_all()

    def _maybe_form(self) -> None:
        # caller holds self._cv
        if not self._forming or not self._expected:
            return
        if not self._expected <= set(self._pending):
            return
        gen = self.generation + 1
        members = sorted(self._expected)
        for i in members:
            self._member_since.setdefault(i, gen)
        # Oldest members first: rank 0 must be a survivor that holds the
        # last committed state (it roots the post-reset broadcast).
        order = sorted(members, key=lambda i: (self._member_since[i], i))
        ranks = {index: r for r, index in enumerate(order)}
        self.num_proc = len(members)
        # Reuse the parent's coordinator-address / topology logic on this
        # generation's registrations.
        self._registrations = {i: self._pending[i] for i in members}
        self._ranks = ranks
        by_host: dict[str, list] = {}
        for i in members:
            by_host.setdefault(self._registrations[i]["host_hash"], []).append(i)
        rank0_index = order[0]
        reg = self._registrations[rank0_index]
        addrs = [a for a, _ in reg["addresses"]]
        multi_host = len(by_host) > 1
        host = next((a for a in addrs if not a.startswith("127.")), addrs[0]) \
            if multi_host else next((a for a in addrs if a.startswith("127.")), addrs[0])
        self.coord_addr = f"{host}:{reg['coord_port'] or _free_port()}"
        for i in members:
            self._assign[i] = {
                "ok": True,
                "rank": ranks[i],
                "generation": gen,
                "topology": self._topology(i, ranks[i]),
                "coord_addr": self.coord_addr,
            }
        self.generation = gen
        self._forming = False
        self._expected = set()
        self._reg_waiting.clear()
        self._pending.clear()
        self._results = {}   # results are per generation
        if self._telemetry is not None:
            # Membership changed: drop telemetry-tree state for hosts that
            # left the world, so an orphaned staleness gauge can't age into
            # a spurious `telemetry_lag` firing (root.forget_host).
            try:
                self._telemetry.keep_only(by_host)
            except Exception:
                pass

    # -- launcher accessors

    def membership(self) -> dict:
        """Snapshot for the supervision loop: current generation, whether a
        reset is in flight, member indices, the indices registered for the
        next generation, and per-rank results so far."""
        with self._lock:
            return {
                "generation": self.generation,
                "forming": self._forming,
                "members": dict(self._member_since),
                "ranks": dict(self._ranks or {}),
                "removed": set(self._removed),
                "pending": set(self._pending),
                "results": dict(self._results),
            }


def host_hash() -> str:
    """Host identity for rank grouping (reference horovod/spark/host_hash.py:
    hostname + container namespace so two containers on one VM differ)."""
    uniq = os.environ.get("HOROVOD_HOSTNAME") or socket.gethostname()
    cgroup = ""
    try:
        with open("/proc/self/cgroup") as f:
            cgroup = f.read()[:64]
    except OSError:
        pass
    import hashlib

    return hashlib.sha1((uniq + cgroup).encode()).hexdigest()[:16]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("0.0.0.0", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TaskAgent:
    """Per-process agent: register with the driver, learn rank/topology,
    fetch and run the function, report the result (reference
    mpirun_exec_fn.py:34-48 without the mpirun/orted hop)."""

    def __init__(self, index: int, driver_addresses, key: bytes) -> None:
        self.index = index
        # Socket timeout > the driver's 120 s wait_assignment window, so a
        # slow straggler elsewhere doesn't kill punctual workers; the
        # jittered connect-retry window covers a driver that is still a
        # moment away from listening when a cold-starting pod's workers
        # come up (runner/network.py BasicClient).
        self.client = BasicClient(driver_addresses, key, timeout=180.0,
                                  connect_retry_s=30.0)

    @staticmethod
    def _my_addresses() -> list[tuple[str, int]]:
        addrs: list[tuple[str, int]] = []
        try:
            for info in socket.getaddrinfo(socket.gethostname(), None, socket.AF_INET):
                addrs.append((info[4][0], 0))
        except socket.gaierror:
            pass
        addrs.append(("127.0.0.1", 0))
        seen: set = set()
        return [a for a in addrs if not (a in seen or seen.add(a))]

    def register(self) -> dict:
        self.client.request({
            "kind": "register",
            "index": self.index,
            "host_hash": host_hash(),
            "addresses": self._my_addresses(),
            # Ports probed free on THIS host: if this task becomes rank 0 the
            # driver advertises host:port as the coordinator address (the
            # driver's own host can't probe ports for another machine).
            "coord_port": _free_port(),
        })
        assignment = self.client.request({"kind": "wait_assignment",
                                          "index": self.index})
        if not assignment["ok"]:
            raise RuntimeError(assignment["error"])
        self._export_assignment(assignment)
        return assignment

    def rendezvous(self, min_generation: int, timeout: float = 300.0) -> dict:
        """Elastic re-registration after a membership change (elastic/run.py
        reset path): register fresh coordinator ports, wait for the next
        generation's assignment, export the new HOROVOD_* env. Raises
        :class:`WorkerRemovedError` when the driver dropped this slot."""
        self.client.request({
            "kind": "rendezvous",
            "index": self.index,
            "host_hash": host_hash(),
            "addresses": self._my_addresses(),
            "coord_port": _free_port(),
        })
        assignment = self.client.request({
            "kind": "wait_assignment", "index": self.index,
            "min_generation": min_generation, "timeout": timeout,
        })
        if not assignment["ok"]:
            if assignment.get("removed"):
                raise WorkerRemovedError(assignment.get("error", "removed"))
            raise RuntimeError(assignment["error"])
        self._export_assignment(assignment)
        return assignment

    @staticmethod
    def _export_assignment(assignment: dict) -> None:
        topo = assignment["topology"]
        os.environ["HOROVOD_RANK"] = str(topo["rank"])
        os.environ["HOROVOD_SIZE"] = str(topo["size"])
        os.environ["HOROVOD_LOCAL_RANK"] = str(topo["local_rank"])
        os.environ["HOROVOD_LOCAL_SIZE"] = str(topo["local_size"])
        os.environ["HOROVOD_CROSS_RANK"] = str(topo["cross_rank"])
        os.environ["HOROVOD_CROSS_SIZE"] = str(topo["cross_size"])
        os.environ["HOROVOD_COORD_ADDR"] = assignment["coord_addr"]
        if "generation" in assignment:
            os.environ["HOROVOD_ELASTIC_GENERATION"] = str(assignment["generation"])

    def report_metrics(self) -> None:
        """Push this rank's current metrics snapshot to the driver (mid-run;
        the final snapshot rides the result payload automatically)."""
        from ..metrics import snapshot

        self.client.request({"kind": "metrics",
                             "rank": int(os.environ["HOROVOD_RANK"]),
                             "snapshot": snapshot()})

    def estimate_clock_offset_ns(self, rounds: int = 8) -> tuple[int, int]:
        """(offset_ns, error_bound_ns) of the DRIVER clock relative to this
        worker's monotonic clock — the runner-level trace alignment path for
        multi-host pods (tracing/clock.py; single-host ranks usually align
        over the engine coordinator channel instead)."""
        from ..tracing.clock import estimate_offset_ns

        return estimate_offset_ns(
            lambda: self.client.request({"kind": "clock_probe"})["t"],
            rounds=rounds)

    @staticmethod
    def _final_snapshot() -> Optional[dict]:
        """This rank's metrics snapshot for the result payload. Collected
        even on failure (the snapshot of a crashed rank is exactly the
        interesting one); never lets telemetry break result delivery."""
        try:
            from ..metrics import snapshot

            return snapshot()
        except Exception:
            return None

    def run(self) -> Any:
        self.register()  # registers, waits for assignment, exports HOROVOD_* env
        import traceback

        fn_resp = self.client.request({"kind": "get_fn"})
        fn, args, kwargs = pickle.loads(fn_resp["fn"])
        try:
            value = fn(*args, **kwargs) if fn is not None else None
            payload = {"ok": True, "value": value}
        except BaseException:
            payload = {"ok": False, "error": traceback.format_exc()}
        payload["metrics"] = self._final_snapshot()
        self.client.request({"kind": "result",
                             "rank": int(os.environ["HOROVOD_RANK"]),
                             "index": self.index,
                             # Elastic jobs tag results with the generation
                             # they belong to (stale ones are dropped by the
                             # ElasticDriverService); 0 for static jobs.
                             "generation": int(os.environ.get(
                                 "HOROVOD_ELASTIC_GENERATION", "0")),
                             "value": payload})
        if not payload["ok"]:
            raise RuntimeError("task function failed")
        return payload["value"]
