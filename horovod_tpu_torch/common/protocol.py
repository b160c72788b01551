"""The eager engines' shared protocol core: the port of
``horovod_tpu/common/protocol.py``.

Every protocol fact the engines must agree on lives here as data or a pure
function:

- **Id spaces and wire shapes**: ``OPS``/``DTYPES``/``STATUS_NAMES``/
  ``WIRE_FORMATS``, the field orders of the native control messages, the
  response cache's signature facets, and ``COORD_WIRE_KINDS``, the
  coordinator's dispatch alphabet that ``ctrl/relay.py`` checks itself
  against. They equal the JAX package's tables entry by entry: the two
  packages' native engines speak one wire.
- **Canonical reduction semantics**: :func:`chunk_bounds`,
  :func:`fold_start`, :func:`reduce_plan`. Chunk c folds contributions in
  ring order from rank (c+1) % world; the accumulator runs at the payload's
  ring width (f32 for f32); 16-bit payloads round at every hop; compressed
  folds round the finished partial once more before the average divide.
- **The state machine**: :class:`Machine`, a pure validator of
  negotiation/cache/demote transition traces.

:func:`verify_spec` checks these tables against ``protocol_spec.json``
beside this module, the spec machine-extracted from the port's own C++ core
(``cc/src``) and engines by ``tools/analyze/protocol.py``'s ``extract``,
and names the first divergent entry.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import numpy as np

from ..compression import is_16bit_float, np_dtype

# --------------------------------------------------------------- id spaces

# Collective op ids, the native core's OpType order.
OPS = {"allreduce": 0, "allgather": 1, "broadcast": 2,
       "reducescatter": 3, "alltoall": 4}

# DataType id -> dtype name, the native core's DataType order.
DTYPES = ["uint8", "int8", "int32", "int64", "float16", "bfloat16",
          "float32", "float64", "bool"]

# Non-OK StatusType values of the native core.
STATUS_NAMES = {1: "UnknownError", 2: "PreconditionError", 3: "Aborted",
                4: "InvalidArgument"}

# Request.wire_fmt values: the sparse-wire tag. Dense formats ride
# the dtype/orig_dtype pair (native) or the `wire` dtype tag (python);
# `topk` changes the FRAME, not the dtype, so it needs its own wire field.
WIRE_FORMATS = {"none": 0, "topk": 1}

# ------------------------------------------------------- wire field orders

# Serialized field order of each native control message.
REQUEST_WIRE_ORDER = ["rank", "op", "dtype", "orig_dtype", "wire_fmt",
                      "name", "root_rank", "average", "trace_seq", "shape"]
TICK_WIRE_ORDER = ["rank", "shutdown", "reqs", "cache_bits"]
RESPONSE_LIST_WIRE_ORDER = ["shutdown", "knob_version", "fusion_threshold",
                            "cycle_time_ms", "hier_allreduce",
                            "hier_allgather", "stall_warnings", "entries",
                            "cache_evict", "cache_assign"]

# Response-cache signature facets, both spellings. A bit bound under one
# engine's rules must invalidate under the other's: the two lists name the
# same facets through the dtype/orig_dtype <-> dtype/wire shift.
NATIVE_CACHE_KEY_FIELDS = ["name", "op", "dtype", "orig_dtype", "wire_fmt",
                           "average", "root_rank", "shape"]
PY_REQUEST_KEY_FIELDS = ["name", "op", "dtype", "root", "shape", "average",
                         "wire"]

# Python full-request dict keys (base + optional), the python half of the
# native Request struct.
PY_REQUEST_FIELDS = ["name", "op", "shape", "dtype", "root", "average"]
PY_REQUEST_OPTIONAL_FIELDS = ["wire", "trace", "ke"]

# The coordinator's control-socket dispatch alphabet, in the source order
# of _Coordinator._serve. The per-host relay (ctrl/relay.py) special-cases
# a subset of these and forwards the rest verbatim; it asserts its subset
# against this list at import, so a kind added or renamed in the
# coordinator cannot silently bypass the tree's batching.
COORD_WIRE_KINDS = ["exchange", "batch_exchange", "ring_hello",
                    "ring_confirm", "batch_ring_hello",
                    "batch_ring_confirm", "relay_hello", "peer_lost",
                    "plane_fault", "knob_change", "clock_probe", "bye"]

SPEC_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "protocol_spec.json")


def load_spec(path: Optional[str] = None) -> dict:
    with open(path or SPEC_PATH, encoding="utf-8") as f:
        return json.load(f)


def verify_spec(spec: Optional[dict] = None,
                path: Optional[str] = None) -> list[str]:
    """Check this module against the machine-extracted protocol spec.

    Returns a list of human-readable mismatch strings (empty = conformant),
    each naming the first divergent entry of its table."""
    if spec is None:
        spec = load_spec(path)
    native = spec.get("native", {})
    py = spec.get("python", {})
    out: list[str] = []

    def _pair(what: str, theirs, mine) -> None:
        """``theirs``: the spec's entry; ``mine``: this module's."""
        if mine == theirs:
            return
        if isinstance(mine, list) and isinstance(theirs, list):
            for i, (a, b) in enumerate(zip(mine, theirs)):
                if a != b:
                    out.append(f"{what}[{i}]: protocol.py has {a!r}, "
                               f"spec has {b!r}")
                    return
            out.append(f"{what}: length {len(mine)} (protocol.py) != "
                       f"{len(theirs)} (spec)")
            return
        out.append(f"{what}: protocol.py has {mine!r}, spec has {theirs!r}")

    enums = native.get("enums", {})
    _pair("OpType", {k.lower(): v for k, v in
                     enums.get("OpType", {}).items()}, OPS)
    _pair("DataType-count", len(enums.get("DataType", {})), len(DTYPES))
    _pair("StatusNames",
          {int(k): v for k, v in py.get("status_names", {}).items()},
          STATUS_NAMES)
    msgs = native.get("messages", {})
    _pair("Request.wire_order",
          msgs.get("Request", {}).get("wire_order", []), REQUEST_WIRE_ORDER)
    _pair("TickRequest.wire_order",
          msgs.get("TickRequest", {}).get("wire_order", []), TICK_WIRE_ORDER)
    _pair("ResponseList.wire_order",
          msgs.get("ResponseList", {}).get("wire_order", []),
          RESPONSE_LIST_WIRE_ORDER)
    _pair("native cache_key", native.get("cache_key_fields", []),
          NATIVE_CACHE_KEY_FIELDS)
    _pair("python request_key", py.get("request_key_fields", []),
          PY_REQUEST_KEY_FIELDS)
    _pair("python request fields", py.get("request_fields", []),
          PY_REQUEST_FIELDS)
    _pair("python optional request fields",
          py.get("request_optional_fields", []), PY_REQUEST_OPTIONAL_FIELDS)
    _pair("python dtypes", py.get("dtypes", []), DTYPES)
    _pair("python ops", py.get("ops", {}), OPS)
    _pair("coordinator wire kinds", py.get("coord_wire_kinds", []),
          COORD_WIRE_KINDS)
    return out


# ------------------------------------------- canonical reduction semantics

def chunk_bounds(n: int, world: int) -> list[int]:
    """np.array_split boundaries of a flat n-element buffer into `world`
    ring chunks: the first n % world chunks carry one extra element.
    The native ring's split_counts/offsets_of."""
    base, rem = divmod(int(n), int(world))
    bounds = [0]
    for i in range(world):
        bounds.append(bounds[-1] + base + (1 if i < rem else 0))
    return bounds


def fold_start(chunk: int, world: int) -> int:
    """The rank whose contribution seeds chunk ``chunk``'s fold: the ring
    reduce-scatter's natural start (chunk + 1) % world — after world-1
    hops the chunk lands fully reduced on rank ``chunk``."""
    return (chunk + 1) % world


def fold_order(chunk: int, world: int) -> list[int]:
    """Full fold order for one chunk: the add sequence every plane (star
    oracle, flat ring, hier stages, native ring) must reproduce."""
    s = fold_start(chunk, world)
    return [(s + k) % world for k in range(world)]


def reduce_plan(dtype, wire_dtype=None) -> dict:
    """Canonical allreduce arithmetic for a payload ``dtype`` under an
    optional explicit wire format.

    Returns ``{"acc": np.dtype, "hop": np.dtype | "topk" | None,
    "storage_round": bool}``:

    - ``hop`` is the dtype every inter-rank hop carries (None = native
      width, no rounding); ``acc`` is the accumulator width each add runs
      at.  Uncompressed floats accumulate at NATIVE ring width — f32 adds
      for f32 payloads, what the native ring computes — and 16-bit
      payloads implicitly hop at their own width with per-hop rounding
      (storage on both engines is 16-bit between adds).
    - ``storage_round``: compressed folds round the finished reduce-scatter
      partial to the hop dtype BEFORE the average divide (the partial is
      stored at wire width on the native ring); the allgather rounds once
      more after it.  Identities for f32 hops.
    """
    dtype = np_dtype(dtype)
    if isinstance(wire_dtype, str) and wire_dtype == "topk":
        return {"acc": np.dtype(np.float32), "hop": "topk",
                "storage_round": False}
    if wire_dtype is not None:
        return {"acc": np.dtype(np.float32), "hop": np_dtype(wire_dtype),
                "storage_round": True}
    if is_16bit_float(dtype):
        # Implicit wire = self: the native engine stores and forwards the
        # 16-bit value after every add.
        return {"acc": np.dtype(np.float32), "hop": dtype,
                "storage_round": True}
    return {"acc": dtype, "hop": None, "storage_round": False}


# ------------------------------------------------------- the state machine

class ProtocolViolation(AssertionError):
    """A transition trace broke the protocol; the message names the event
    index and the rule it violated."""

    def __init__(self, index: int, event: tuple, why: str) -> None:
        self.index = index
        self.event = event
        self.why = why
        super().__init__(f"event[{index}] {event!r}: {why}")


class Machine:
    """Pure validator of the eager engines' shared state machine.

    Events are ``(kind, *args)`` tuples, the vocabulary both engines'
    observable transitions map onto:

    - ``("tick_full", rank, key)``      — a full request for signature key
    - ``("tick_cached", rank, key)``    — a cache-bit negotiation
    - ``("assign", bit, key)``          — coordinator binds key -> bit
    - ``("evict", bit)``                — coordinator invalidates a bit
    - ``("flush", rank)``               — a rank drops its mirror
    - ``("execute", key)``              — the collective runs
    - ``("demote", rank)``              — rung 2: peer plane -> star
    - ``("redo", key)``                 — demotion replay of a collective
    - ``("repromote", rank)``           — cooldown rebuilt the peer plane

    Rules enforced (the cross-engine contract):

    - a cached tick requires the key bound AND the rank's mirror to have
      learned the binding after its last flush;
    - an assign may re-announce the same (bit, key) pair (mirror re-heal)
      but must evict before re-binding either half differently;
    - an execute requires every live rank to have contributed the key
      since its last execute;
    - a redo is only legal while demoted, and a demoted rank negotiates
      star-only until re-promotion.
    """

    def __init__(self, world: int) -> None:
        self.world = world
        self.bit_of: dict = {}        # key -> bit
        self.key_of: dict = {}        # bit -> key
        self.learned: dict = {r: set() for r in range(world)}  # rank mirrors
        self.contributed: dict = {}   # key -> set of ranks this round
        self.plane: dict = {r: "peer" for r in range(world)}

    def feed(self, i: int, ev: tuple) -> None:
        kind = ev[0]
        if kind == "tick_full":
            _, rank, key = ev
            self.contributed.setdefault(key, set()).add(rank)
        elif kind == "tick_cached":
            _, rank, key = ev
            if key not in self.bit_of:
                raise ProtocolViolation(
                    i, ev, "cached tick for a signature with no bound bit")
            if key not in self.learned[rank]:
                raise ProtocolViolation(
                    i, ev, "cached tick before this rank's mirror learned "
                           "the binding (flushed mirrors must re-learn "
                           "from a full request + re-announcement)")
            self.contributed.setdefault(key, set()).add(rank)
        elif kind == "assign":
            _, bit, key = ev
            if self.key_of.get(bit, key) != key:
                raise ProtocolViolation(
                    i, ev, f"bit {bit} already bound to "
                           f"{self.key_of[bit]!r} without an evict")
            if self.bit_of.get(key, bit) != bit:
                raise ProtocolViolation(
                    i, ev, f"key already bound to bit {self.bit_of[key]} "
                           "without an evict")
            self.bit_of[key] = bit
            self.key_of[bit] = key
            for r in range(self.world):
                self.learned[r].add(key)  # announcement reaches every rank
        elif kind == "evict":
            _, bit = ev
            key = self.key_of.pop(bit, None)
            if key is None:
                raise ProtocolViolation(i, ev, f"evict of unbound bit {bit}")
            self.bit_of.pop(key, None)
            for r in range(self.world):
                self.learned[r].discard(key)
        elif kind == "flush":
            _, rank = ev
            self.learned[rank] = set()
        elif kind == "execute":
            _, key = ev
            got = self.contributed.pop(key, set())
            if len(got) < self.world:
                raise ProtocolViolation(
                    i, ev, f"executed with contributions from {sorted(got)} "
                           f"only (world {self.world})")
        elif kind == "demote":
            self.plane[ev[1]] = "star"
        elif kind == "redo":
            _, key = ev
            if all(p == "peer" for p in self.plane.values()):
                raise ProtocolViolation(
                    i, ev, "redo replay outside a demotion epoch")
        elif kind == "repromote":
            _, rank = ev
            if self.plane[rank] != "star":
                raise ProtocolViolation(
                    i, ev, "re-promotion of a rank that never demoted")
            self.plane[rank] = "peer"
        else:
            raise ProtocolViolation(i, ev, f"unknown event kind {kind!r}")

    def replay(self, events: Iterable[tuple]) -> int:
        """Validate a whole trace; returns the number of events consumed.
        Raises :class:`ProtocolViolation` naming the first bad one."""
        n = 0
        for i, ev in enumerate(events):
            self.feed(i, ev)
            n += 1
        return n


def replay(events: Iterable[tuple], world: int) -> int:
    """Convenience: validate ``events`` on a fresh :class:`Machine`."""
    return Machine(world).replay(events)
