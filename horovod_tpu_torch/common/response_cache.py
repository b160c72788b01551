"""Response cache for the eager engine, the steady-state fast path: the
port of ``horovod_tpu/common/response_cache.py``.

After a tensor's first full negotiation, every rank remembers the
coordinator's response under a small integer *bit*, and later ticks
exchange per-rank bitvectors of pending bits instead of full request
lists, so the per-tick control frame stays a handful of bytes however many
tensors a step re-submits.

- :class:`ResponseCache` is the *authority*, owned by the rank-0
  coordinator. It assigns bits to validated signatures, bounds the table at
  ``HOROVOD_CACHE_CAPACITY`` entries with LRU eviction (never evicting a
  bit whose tensor is mid-negotiation), and records evictions so they can
  be broadcast to every rank.
- :class:`CacheMirror` is the per-rank follower: it only inserts what the
  coordinator announced and drops what it evicted, so it is bounded by the
  authority's capacity and can be flushed at any time (the coordinator
  re-announces assignments with every result, so a flushed rank heals).

A cache *key* is the full request signature ``(name, op, shape, dtype,
root, average, wire)``: a shape, dtype or wire-format change produces a
different key, which misses, falls back to a full request, and makes the
authority evict the stale bit for that name. Elastic resets rebuild the
engine, and with it both halves, so no response outlives a membership.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Optional

DEFAULT_CACHE_CAPACITY = 1024


def cache_capacity_from_env() -> int:
    """HOROVOD_CACHE_CAPACITY: max cached signatures (0 disables)."""
    v = os.environ.get("HOROVOD_CACHE_CAPACITY")
    if v in (None, ""):
        return DEFAULT_CACHE_CAPACITY
    try:
        return max(0, int(v))
    except ValueError:
        return DEFAULT_CACHE_CAPACITY


def request_key(req: dict) -> tuple:
    """Signature tuple for a request dict (engine wire shape). The trailing
    element is the wire FORMAT — a wire dtype name ('bfloat16'/'float16'),
    the sparse 'topk' tag, or '' for uncompressed — so a cache bit bound
    under one format invalidates when HOROVOD_COMPRESSION (or an
    adaptive-policy resolution) changes, exactly like a shape change —
    mirroring PyEngine._entry_key."""
    return (req["name"], req["op"], tuple(req["shape"]), req["dtype"],
            req.get("root", 0), bool(req.get("average", True)),
            str(req.get("wire") or ""))


class ResponseCache:
    """Coordinator-side bit table: signature -> bit, LRU-bounded.

    Single-threaded by contract (the coordinator mutates it under its own
    lock).  ``assign`` returns the new bit plus any bits evicted to make
    room; the caller is responsible for broadcasting both.
    """

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = (cache_capacity_from_env()
                         if capacity is None else max(0, int(capacity)))
        # bit -> (key, meta); OrderedDict doubles as the LRU order
        # (oldest first).
        self._bits: "OrderedDict[int, tuple[tuple, Any]]" = OrderedDict()
        self._key_to_bit: dict[tuple, int] = {}
        self._name_to_bit: dict[str, int] = {}
        self._next_bit = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- lookups

    def __len__(self) -> int:
        return len(self._bits)

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def bit_for(self, key: tuple) -> Optional[int]:
        return self._key_to_bit.get(key)

    def lookup_bit(self, bit: int) -> Optional[tuple]:
        """(key, meta) for a live bit, refreshing its LRU position."""
        entry = self._bits.get(bit)
        if entry is None:
            return None
        self._bits.move_to_end(bit)
        return entry

    def bit_for_name(self, name: str) -> Optional[int]:
        return self._name_to_bit.get(name)

    # -- mutation

    def assign(self, key: tuple, meta: Any,
               in_use: Optional[set] = None) -> tuple[Optional[int], list]:
        """Bind ``key`` to a fresh bit; returns ``(bit, evicted)`` where
        ``evicted`` is a list of ``(bit, key, meta)`` triples (the caller
        broadcasts them and keeps tombstones until every rank has seen the
        eviction).

        Evicts first any stale bit held by the same tensor *name* under a
        different signature (shape/dtype change), then the LRU entry if at
        capacity.  Bits named in ``in_use`` (mid-negotiation) are never
        evicted; if nothing is evictable the assignment is skipped
        (``bit=None``) and the tensor simply stays on the full-request
        path.
        """
        if not self.enabled:
            return None, []
        evicted: list = []
        name = key[0]
        stale = self._name_to_bit.get(name)
        if stale is not None and self._bits[stale][0] != key:
            evicted.append(self._drop(stale))
            self.evictions += 1
        if key in self._key_to_bit:  # already assigned (idempotent)
            return self._key_to_bit[key], evicted
        while len(self._bits) >= self.capacity:
            victim = self._lru_victim(in_use or set())
            if victim is None:
                return None, evicted
            evicted.append(self._drop(victim))
            self.evictions += 1
        bit = self._next_bit
        self._next_bit += 1
        self._bits[bit] = (key, meta)
        self._key_to_bit[key] = bit
        self._name_to_bit[name] = bit
        return bit, evicted

    def evict_name(self, name: str) -> list:
        """Evict the bit bound to ``name``; returns [(bit, key, meta)]."""
        bit = self._name_to_bit.get(name)
        if bit is None:
            return []
        self.evictions += 1
        return [self._drop(bit)]

    def flush(self) -> list:
        """Drop everything; returns the evicted (bit, key, meta) triples
        (broadcast as evictions so every mirror follows)."""
        return [self._drop(bit) for bit in list(self._bits)]

    def _lru_victim(self, in_use: set) -> Optional[int]:
        for bit, (key, _meta) in self._bits.items():  # oldest first
            if key[0] not in in_use:
                return bit
        return None

    def _drop(self, bit: int) -> tuple:
        key, meta = self._bits.pop(bit)
        self._key_to_bit.pop(key, None)
        if self._name_to_bit.get(key[0]) == bit:
            self._name_to_bit.pop(key[0], None)
        return (bit, key, meta)

    def stats(self) -> dict:
        return {"size": len(self._bits), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


class CacheMirror:
    """Rank-side follower table: key <-> bit, updated only from the
    coordinator's assign/evict announcements."""

    def __init__(self) -> None:
        self._key_to_bit: dict[tuple, int] = {}
        self._bit_to_key: dict[int, tuple] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._key_to_bit)

    def lookup(self, key: tuple) -> Optional[int]:
        bit = self._key_to_bit.get(key)
        if bit is not None:
            self.hits += 1
        else:
            self.misses += 1
        return bit

    def peek(self, key: tuple) -> Optional[int]:
        """Lookup without touching the hit/miss stats (re-polls)."""
        return self._key_to_bit.get(key)

    def apply(self, assign, evict) -> None:
        """Apply one response's announcements (evictions first)."""
        for bit in evict or ():
            key = self._bit_to_key.pop(bit, None)
            if key is not None and self._key_to_bit.get(key) == bit:
                self._key_to_bit.pop(key, None)
        for bit, key in assign or ():
            key = tuple(key)
            key = ((key[0], key[1], tuple(key[2]), key[3], key[4],
                    bool(key[5])) + tuple(str(k) for k in key[6:]))
            old = self._key_to_bit.get(key)
            if old is not None:
                self._bit_to_key.pop(old, None)
            self._key_to_bit[key] = bit
            self._bit_to_key[bit] = key

    def flush(self) -> None:
        self._key_to_bit.clear()
        self._bit_to_key.clear()

    def stats(self) -> dict:
        return {"size": len(self._key_to_bit), "hits": self.hits,
                "misses": self.misses}
