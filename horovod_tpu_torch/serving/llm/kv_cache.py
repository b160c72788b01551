"""Paged KV-cache allocator — memory as the serving plane's admission
currency (vLLM-style; Kwon et al., SOSP '23) — plus radix prefix sharing
(SGLang RadixAttention; Zheng et al., arXiv:2312.07104). The port's
counterpart of ``horovod_tpu.serving.llm.kv_cache``: the allocator and the
trie are its host logic, copied; the K/V pool lives on the replica's
device as torch tensors.

The device KV cache is carved into ``num_blocks`` fixed-size blocks of
``block_size`` token slots each. A sequence owns an ordered *block table*
(block ids, one per ``block_size`` tokens of context); token position
``p`` lives in ``table[p // block_size]`` at slot ``p % block_size``.
Because any free block can serve any sequence, there is no external
fragmentation: capacity freed by a retiring sequence is usable by the
next admission immediately, whatever the interleaving history.

Two-tier availability policy:

- **admission allocations** (:meth:`BlockAllocator.alloc` /
  :meth:`BlockAllocator.admit`) must leave the *watermark reserve*
  untouched — ``ceil(num_blocks * watermark)`` blocks held back so
  sequences already running can keep growing;
- **growth allocations** (:meth:`BlockAllocator.extend`) may dip into the
  reserve. When even the reserve is exhausted the caller preempts the
  newest running sequence and requeues it (scheduler.py) — preemption
  instead of OOM is the whole point of paging.

**Prefix sharing** (:class:`RadixPrefixCache`): blocks carry reference
counts — one per block table holding them plus one per radix-trie node
retaining them — and a block returns to the free list only at refcount 0.
The trie is keyed by full-block token tuples, so a block is registered
only once every one of its slots is written; TinyLM's K/V at a position
depend only on ``(token, position)`` (serving/model.py), which makes a
token-and-position-aligned cached block bitwise valid for any sequence
whose context starts with the same tokens. Writes into a block with
refcount > 1 copy-on-write first (:meth:`PagedKVCache.write`), so a
divergent suffix can never corrupt a sibling — in practice the scheduler
shares only full, immutable prompt blocks and partial tail matches are
copied *at admission*, so the COW path is a safety net the property
tests hammer. Trie-retained blocks with no table reference are the
evictable tier: the allocator's ``reclaimer`` hook evicts them LRU-leaf
first when an allocation would otherwise refuse.

The allocator is pure bookkeeping (block ids, no tensor data) so the
property tests can hammer it standalone; :class:`PagedKVCache` pairs it
with the actual K/V block storage (float32 tensors on the replica's
device) and the gather/scatter used by the block-table decode step
(serving/model.py).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` of context."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // block_size)


class BlockAllocator:
    """Free-list allocator for fixed-size KV blocks with per-sequence
    block tables, per-block reference counts, and a watermark reserve.
    NOT thread-safe: the owning scheduler/engine serializes access under
    its own lock."""

    def __init__(self, num_blocks: int, block_size: int,
                 watermark: float = 0.05) -> None:
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got "
                f"{num_blocks}/{block_size}")
        if not 0.0 <= watermark < 1.0:
            raise ValueError(f"watermark must be in [0, 1), got {watermark}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.reserve = int(np.ceil(num_blocks * watermark))
        self._free: deque[int] = deque(range(num_blocks))
        self._tables: dict[object, list[int]] = {}
        # refcount per NON-free block: number of tables listing it plus
        # its external retention count (the radix trie). A block leaves
        # the free list at refs 1 and returns only when refs hits 0.
        self._refs: dict[int, int] = {}
        self._retained: dict[int, int] = {}
        self.preemptions_total = 0
        # Called with a block deficit before an allocation refuses:
        # ``reclaimer(need) -> int`` frees up to ``need`` retained-only
        # blocks (the radix trie's LRU eviction). None = nothing to evict.
        self.reclaimer = None
        # Serving tracer (tracing/serve.py; set by the owning scheduler):
        # block-pressure events are emitted on the EDGE — the first refused
        # allocation of a pressure episode — so a queue waiting out a long
        # generation does not spam one event per scheduler iteration.
        self.tracer = None
        self._pressure = False

    # -- views ---------------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - len(self._free)

    def table(self, seq_id) -> list[int]:
        """The sequence's block table (a copy; ordered by token position)."""
        return list(self._tables[seq_id])

    def owned(self, seq_id) -> int:
        t = self._tables.get(seq_id)
        return len(t) if t is not None else 0

    def capacity(self, seq_id) -> int:
        """Token positions the sequence's current table can hold."""
        return self.owned(seq_id) * self.block_size

    def refs(self, block: int) -> int:
        """Current reference count of a block (0 = free)."""
        return self._refs.get(block, 0)

    def can_alloc(self, n_blocks: int) -> bool:
        """Would an ADMISSION allocation of ``n_blocks`` succeed (i.e.
        without dipping into the watermark reserve)?"""
        return len(self._free) - self.reserve >= n_blocks

    # -- the mutations --------------------------------------------------------

    def _pop_fresh(self) -> int:
        b = self._free.popleft()
        self._refs[b] = 1
        return b

    def _deref(self, block: int) -> bool:
        """Drop one reference; True when the block returned to the free
        list (refcount reached 0)."""
        n = self._refs.get(block)
        if n is None:
            raise ValueError(f"deref of free block {block} (double free?)")
        if n > 1:
            self._refs[block] = n - 1
            return False
        del self._refs[block]
        self._retained.pop(block, None)
        self._free.append(block)
        return True

    def _reclaim_to(self, deficit: int) -> None:
        """Ask the reclaimer (trie eviction) to cover a block deficit."""
        if self.reclaimer is not None and deficit > 0:
            self.reclaimer(deficit)

    def alloc(self, seq_id, n_tokens: int) -> Optional[list[int]]:
        """Admission-time allocation: a table for ``n_tokens`` of context.
        None when granting it would eat into the reserve (the caller keeps
        the sequence queued or preempts). A sequence id may hold at most
        one table."""
        return self.admit(seq_id, n_tokens, ())

    def admit(self, seq_id, n_tokens: int,
              shared: tuple = ()) -> Optional[list[int]]:
        """Admission with a shared prefix: the first ``len(shared)`` table
        entries reference already-cached blocks (each gains a reference —
        nothing is popped for them), the remainder come fresh from the
        free list. Only the FRESH need counts against the watermark. On
        refusal nothing is referenced or popped.

        The shared blocks take their reference BEFORE the reclaimer runs:
        it evicts only blocks that nothing but the trie holds, which the
        matched prefix may be, and the JAX package's ``admit``, which
        references them after reclaiming, then raises "shared block ...
        is not allocated" on the block it just evicted."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already holds a table "
                             f"(alloc after alloc without free/preempt)")
        shared = list(shared)
        need = blocks_for(n_tokens, self.block_size) - len(shared)
        if need < 0:
            raise ValueError(
                f"shared prefix ({len(shared)} blocks) exceeds the "
                f"table for {n_tokens} tokens")
        for b in shared:
            if b not in self._refs:
                raise ValueError(f"shared block {b} is not allocated")
        for b in shared:
            self._refs[b] += 1
        if not self.can_alloc(need):
            self._reclaim_to(need - (len(self._free) - self.reserve))
        if not self.can_alloc(need):
            for b in shared:
                self._refs[b] -= 1
            self._pressure_event("admission", seq_id, need)
            return None
        table = shared + [self._pop_fresh() for _ in range(need)]
        self._tables[seq_id] = table
        self._pressure = False
        return list(table)

    def extend(self, seq_id, n_tokens: int) -> bool:
        """Grow the table so it can hold ``n_tokens`` of context. Growth
        MAY consume the watermark reserve (that is what the reserve is
        for); False when the free list is empty — the caller preempts."""
        table = self._tables.get(seq_id)
        if table is None:
            raise ValueError(f"extend of unknown sequence {seq_id!r}")
        need = blocks_for(n_tokens, self.block_size) - len(table)
        if need <= 0:
            return True
        if len(self._free) < need:
            self._reclaim_to(need - len(self._free))
        if len(self._free) < need:
            self._pressure_event("growth", seq_id, need)
            return False
        for _ in range(need):
            table.append(self._pop_fresh())
        self._pressure = False
        return True

    def free(self, seq_id) -> int:
        """Drop the sequence's reference on every block it owns (retire
        path); returns how many blocks actually came back to the free
        list — blocks the radix trie (or a sibling table) still holds
        stay allocated. Double-free raises — a block on the free list
        twice would silently hand one sequence's KV to two owners."""
        table = self._tables.pop(seq_id, None)
        if table is None:
            raise ValueError(f"free of unknown sequence {seq_id!r} "
                             f"(double free?)")
        return sum(1 for b in table if self._deref(b))

    def preempt(self, seq_id) -> int:
        """Free-with-intent-to-requeue: identical block motion to
        :meth:`free`, counted separately (``preemptions_total`` feeds
        ``horovod_serve_llm_preemptions_total``)."""
        n = self.free(seq_id)
        self.preemptions_total += 1
        return n

    # -- sharing primitives (the radix trie drives these) ---------------------

    def retain(self, block: int) -> None:
        """External (trie) reference on an allocated block: the block now
        survives its owning tables — it returns to the free list only
        after a matching :meth:`release`."""
        if block not in self._refs:
            raise ValueError(f"retain of free block {block}")
        self._refs[block] += 1
        self._retained[block] = self._retained.get(block, 0) + 1

    def release(self, block: int) -> bool:
        """Drop one external reference; True when the block freed."""
        if self._retained.get(block, 0) < 1:
            raise ValueError(f"release of unretained block {block}")
        self._retained[block] -= 1
        if not self._retained[block]:
            del self._retained[block]
        n = self._refs[block]
        if n > 1:
            self._refs[block] = n - 1
            return False
        del self._refs[block]
        self._free.append(block)
        return True

    def cow(self, seq_id, idx: int) -> Optional[int]:
        """Copy-on-write: replace the shared block at ``table[idx]`` with
        a fresh private one (the caller copies the tensor rows). Growth
        tier — may dip into the reserve, tries the reclaimer; None when
        no block can be found (the caller preempts)."""
        table = self._tables[seq_id]
        old = table[idx]
        if self._refs.get(old, 0) < 2:
            raise ValueError(f"cow of unshared block {old} (refs="
                             f"{self._refs.get(old, 0)})")
        if not self._free:
            self._reclaim_to(1)
        if not self._free:
            self._pressure_event("growth", seq_id, 1)
            return None
        new = self._pop_fresh()
        table[idx] = new
        self._refs[old] -= 1
        self._pressure = False
        return new

    def _pressure_event(self, kind: str, seq_id, need: int) -> None:
        if self._pressure or self.tracer is None:
            self._pressure = True
            return
        self._pressure = True
        self.tracer.point(f"req:gen:{seq_id}", "kv_pressure", kind=kind,
                          need=need, free=len(self._free),
                          reserve=self.reserve, used=self.used_count)

    def check_invariants(self) -> None:
        """Every block is EITHER free or referenced, and its refcount is
        exactly (tables listing it) + (trie retentions) — the no-leak /
        no-double-own invariant the property tests assert after every
        random operation."""
        want: dict[int, int] = dict(self._retained)
        for t in self._tables.values():
            for b in t:
                want[b] = want.get(b, 0) + 1
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError(f"free list holds duplicates: "
                                 f"{sorted(self._free)}")
        if free & set(want):
            raise AssertionError(
                f"blocks both free and referenced: {sorted(free & set(want))}")
        if want != self._refs:
            raise AssertionError(
                f"refcount drift: counted {want} vs tracked {self._refs}")
        if len(free) + len(want) != self.num_blocks or \
                (free | set(want)) != set(range(self.num_blocks)):
            raise AssertionError(
                f"block accounting broken: free={len(free)} + "
                f"referenced={len(want)} of {self.num_blocks}")


class RadixPrefixCache:
    """Trie over full-block token prefixes — each node pins one KV block
    whose ``block_size`` slots hold exactly the node's token chunk at the
    node's depth (token AND position aligned, which is what makes a hit
    bitwise-valid KV for TinyLM). Registration retains the block
    (refcount +1); eviction releases LRU leaves whose block has no table
    reference left (refcount == retention), installed as the allocator's
    ``reclaimer`` so pressure evicts cold prefixes before refusing."""

    class _Node:
        __slots__ = ("key", "block", "parent", "children", "touch")

        def __init__(self, key, block, parent):
            self.key = key              # block_size-token tuple
            self.block = block
            self.parent = parent
            self.children: dict = {}
            self.touch = 0

    def __init__(self, alloc: BlockAllocator) -> None:
        self.alloc = alloc
        self.block_size = alloc.block_size
        self._root = self._Node((), -1, None)
        self._clock = 0
        self._nodes = 0
        self.hit_tokens_total = 0
        self.lookup_tokens_total = 0
        self.recovered_blocks_total = 0

    def __len__(self) -> int:
        return self._nodes

    def _chunks(self, tokens) -> list[tuple]:
        n = len(tokens) // self.block_size
        return [tuple(int(t) for t in
                      tokens[i * self.block_size:(i + 1) * self.block_size])
                for i in range(n)]

    def lookup(self, tokens) -> tuple:
        """Longest cached prefix of ``tokens``: a list of full-block ids
        plus an optional partial tail match ``(block_id, n_rows)`` — the
        first ``n_rows`` slots of one further cached block whose chunk
        shares those tokens (the caller copies the rows, it must not
        reference a partially-matching block). Touches matched nodes MRU."""
        self.lookup_tokens_total += len(tokens)
        node, blocks = self._root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            self._clock += 1
            child.touch = self._clock
            blocks.append(child.block)
            node = child
        rest = list(tokens[len(blocks) * self.block_size:])
        partial = None
        if rest:
            best = 0
            for key, child in node.children.items():
                n = 0
                while n < len(rest) and n < len(key) and key[n] == rest[n]:
                    n += 1
                if n > best:
                    best, partial = n, (child.block, n)
        self.hit_tokens_total += len(blocks) * self.block_size + (
            partial[1] if partial else 0)
        return blocks, partial

    def register(self, tokens, table) -> int:
        """Insert every full block of ``tokens`` (KV already materialized
        in ``table``) into the trie, retaining newly pinned blocks.
        Chunks already present just refresh LRU — the sequence's table
        holds the SAME block ids there (it admitted through
        :meth:`lookup`), so there is nothing to insert. Returns how many
        blocks were newly retained."""
        node, added = self._root, 0
        for i, chunk in enumerate(self._chunks(tokens)):
            child = node.children.get(chunk)
            if child is None:
                child = self._Node(chunk, table[i], node)
                self.alloc.retain(table[i])
                node.children[chunk] = child
                self._nodes += 1
                added += 1
            self._clock += 1
            child.touch = self._clock
            node = child
        return added

    def evict(self, need: int) -> int:
        """Release up to ``need`` LRU leaf blocks that no table references
        (refcount == 1, the trie's own retention) back to the free list.
        Interior nodes free bottom-up as their children go. Installed as
        ``BlockAllocator.reclaimer``."""
        freed = 0
        while freed < need:
            victim = None
            stack = [self._root]
            while stack:
                node = stack.pop()
                for child in node.children.values():
                    if child.children:
                        stack.append(child)
                    elif self.alloc.refs(child.block) == 1 and (
                            victim is None or child.touch < victim.touch):
                        victim = child
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self._nodes -= 1
            self.alloc.release(victim.block)
            freed += 1
        self.recovered_blocks_total += freed
        return freed


class PagedKVCache:
    """Block allocator + the K/V block storage + the gather/scatter the
    paged decode step uses.

    Storage is ``[num_blocks, block_size, dim]`` float32 per tensor, on the
    replica's device; a sequence's contiguous-context view is the
    concatenation of its table's blocks truncated to its token count —
    :meth:`gather` materializes exactly that, as fresh contiguous tensors,
    which is what makes paged decode bitwise identical to decode over a
    contiguous cache (same values, same order, same reduction).

    With ``model_shards > 1`` each simulated chip of the replica's model
    axis persistently holds a *dim-slice* of every page: storage becomes
    ``model_shards`` tensors of ``[num_blocks, block_size, dim //
    model_shards]`` (all on the replica's one card), the block TABLE is
    shared (one admission decision for the group), and :meth:`gather`
    reassembles the full ``[length, dim]`` view by concatenating the
    per-shard slices in shard order, which is bitwise the unsharded
    tensor. ``model_shards=1`` keeps the single-tensor layout
    (``self.k``/``self.v``).

    ``prefix_cache=True`` attaches a :class:`RadixPrefixCache`: admission
    goes through :meth:`admit_prefix` (shared full-block prefix + a
    row-copied partial tail), prefixes are published with
    :meth:`register_prefix`, and :meth:`write` copies-on-write before
    touching any block a sibling or the trie still references. Sharing
    composes with sharding because it lives entirely in the block TABLE."""

    def __init__(self, num_blocks: int, block_size: int, dim: int,
                 watermark: float = 0.05, dtype=torch.float32,
                 model_shards: int = 1, prefix_cache: bool = False,
                 device=None) -> None:
        from ...common.basics import resolve_device

        if model_shards < 1 or dim % model_shards:
            raise ValueError(
                f"model_shards must be >= 1 and divide dim, got "
                f"model_shards={model_shards} dim={dim}")
        self.device = resolve_device(device)
        self.alloc = BlockAllocator(num_blocks, block_size, watermark)
        self.block_size = block_size
        self.dim = dim
        self.model_shards = model_shards
        self.prefix: Optional[RadixPrefixCache] = None
        self.cow_copies_total = 0
        if prefix_cache:
            self.prefix = RadixPrefixCache(self.alloc)
            self.alloc.reclaimer = self.prefix.evict
        d = dim // model_shards
        self.k_shards = [torch.zeros((num_blocks, block_size, d),
                                     dtype=dtype, device=self.device)
                         for _ in range(model_shards)]
        self.v_shards = [torch.zeros((num_blocks, block_size, d),
                                     dtype=dtype, device=self.device)
                         for _ in range(model_shards)]
        if model_shards == 1:
            # Unsharded view: the historical attributes ARE the storage.
            self.k = self.k_shards[0]
            self.v = self.v_shards[0]

    def per_chip_nbytes(self) -> int:
        """Persistent KV bytes ONE chip of the group holds (the whole
        cache when unsharded) — counted by the chip-budget gate alongside
        ``ShardedLMParams.per_chip_nbytes``."""
        t = self.k_shards[0]
        return int(2 * t.numel() * t.element_size())

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device,
                                     dtype=self.k_shards[0].dtype)

    def _shards_of(self, x) -> list:
        """A K (or V) payload as per-shard dim-slices on this cache's
        device: either a full ``[..., dim]`` tensor/array or a pre-sliced
        list of ``model_shards`` pieces (a sharded handoff page arrives
        pre-sliced); a list of another length is joined and re-split."""
        if isinstance(x, (list, tuple)):
            if len(x) == self.model_shards:
                return [self._on_device(p) for p in x]
            x = torch.cat([self._on_device(p) for p in x], dim=-1)
        x = self._on_device(x)
        if self.model_shards == 1:
            return [x]
        return list(torch.chunk(x, self.model_shards, dim=-1))

    def _copy_rows(self, dst: int, src: int, n_rows: int) -> None:
        """Copy the first ``n_rows`` slots of block ``src`` into ``dst``
        on EVERY shard (sharing decisions are per-table, so all chips
        copy their own dim-slice of the same rows)."""
        for r in range(self.model_shards):
            self.k_shards[r][dst, :n_rows] = self.k_shards[r][src, :n_rows]
            self.v_shards[r][dst, :n_rows] = self.v_shards[r][src, :n_rows]

    def write(self, seq_id, pos: int, k_vec, v_vec) -> None:
        """Scatter one token's K/V into the sequence's block for position
        ``pos`` (the table must already cover it — ensure/extend first).
        A block the trie or a sibling still references is copied-on-write
        first, so a writer can never corrupt a shared prefix. Under
        sharding each chip scatters its own dim-slice."""
        table = self.alloc._tables[seq_id]
        idx = pos // self.block_size
        b = table[idx]
        s = pos % self.block_size
        if self.alloc.refs(b) > 1:
            nb = self.alloc.cow(seq_id, idx)
            if nb is None:
                raise RuntimeError(
                    f"copy-on-write for {seq_id!r} pos {pos} found no free "
                    f"block (caller must preempt before writing)")
            self._copy_rows(nb, b, s)
            self.cow_copies_total += 1
            b = nb
        for r, (kp, vp) in enumerate(zip(self._shards_of(k_vec),
                                         self._shards_of(v_vec))):
            self.k_shards[r][b, s] = kp
            self.v_shards[r][b, s] = vp

    def write_span(self, seq_id, start: int, k_rows, v_rows) -> None:
        """Positions ``start .. start + n - 1`` from ``[n, dim]`` rows (or
        per-shard slice lists): one copy per block and shard where the
        block is the sequence's own, :meth:`write` row by row (with its
        copy-on-write) where it is shared. Bitwise the same pool as
        ``n`` calls of :meth:`write`."""
        ks, vs = self._shards_of(k_rows), self._shards_of(v_rows)
        n = ks[0].shape[0]
        table = self.alloc._tables[seq_id]
        bs = self.block_size
        pos = start
        while pos < start + n:
            idx, s0 = divmod(pos, bs)
            end = min((idx + 1) * bs, start + n)
            b = table[idx]
            if self.alloc.refs(b) > 1:
                for p in range(pos, end):
                    self.write(seq_id, p, [k[p - start] for k in ks],
                               [v[p - start] for v in vs])
            else:
                for r in range(self.model_shards):
                    self.k_shards[r][b, s0:s0 + end - pos] = \
                        ks[r][pos - start:end - start]
                    self.v_shards[r][b, s0:s0 + end - pos] = \
                        vs[r][pos - start:end - start]
            pos = end

    # -- prefix sharing --------------------------------------------------------

    def admit_prefix(self, seq_id, tokens) -> Optional[int]:
        """Admission-allocate a table for ``len(tokens)`` of context,
        sharing the longest cached prefix: matched full blocks enter the
        table by reference (no copy, no recompute), a partial tail match
        row-copies into the sequence's own fresh block. Returns the number
        of prefix positions whose K/V is already materialized (0 when the
        prefix cache is off or cold), or None when blocks are unavailable
        (caller keeps the sequence queued). The copy happens HERE, at
        admission, so decode-time writes never land on a shared block."""
        if self.prefix is None:
            return None if self.alloc.alloc(seq_id, len(tokens)) is None \
                else 0
        blocks, partial = self.prefix.lookup(tokens)
        if self.alloc.admit(seq_id, len(tokens), blocks) is None:
            return None
        shared = len(blocks) * self.block_size
        if partial is not None:
            src, n_rows = partial
            self._copy_rows(self.alloc._tables[seq_id][len(blocks)],
                            src, n_rows)
            shared += n_rows
        return shared

    def register_prefix(self, seq_id, tokens) -> int:
        """Publish the sequence's full-block prefix of ``tokens`` into the
        radix trie (call once its K/V is materialized). No-op when the
        prefix cache is off."""
        if self.prefix is None:
            return 0
        return self.prefix.register(tokens, self.alloc._tables[seq_id])

    def prefix_stats(self) -> dict:
        """Prefix/COW counters for the scheduler's stats() mirror."""
        p = self.prefix
        return {
            "prefix_hit_tokens_total": p.hit_tokens_total if p else 0,
            "prefix_lookup_tokens_total": p.lookup_tokens_total if p else 0,
            "recovered_blocks_total": p.recovered_blocks_total if p else 0,
            "cow_copies_total": self.cow_copies_total,
        }

    # -- gather / handoff ------------------------------------------------------

    def gather_sharded(self, seq_id, length: int) -> tuple:
        """The first ``length`` context positions as per-model-shard page
        slices: two lists of ``model_shards`` fresh tensors, each
        ``[length, dim // model_shards]``, in token order."""
        table = self.alloc._tables[seq_id]
        need = blocks_for(length, self.block_size)
        d = self.k_shards[0].shape[-1]
        idx = torch.tensor(table[:need], dtype=torch.long,
                           device=self.device)
        ks = [a.index_select(0, idx).reshape(-1, d)[:length]
              for a in self.k_shards]
        vs = [a.index_select(0, idx).reshape(-1, d)[:length]
              for a in self.v_shards]
        return ks, vs

    def gather(self, seq_id, length: int) -> tuple:
        """The first ``length`` context positions as fresh contiguous
        ``[length, dim]`` K and V tensors, in token order (the per-shard
        slices concatenated back — bitwise the unsharded gather)."""
        ks, vs = self.gather_sharded(seq_id, length)
        if self.model_shards == 1:
            return ks[0], vs[0]
        return torch.cat(ks, dim=-1), torch.cat(vs, dim=-1)

    @staticmethod
    def handoff_tokens(k_arr) -> int:
        """Token count of a handoff K (or V) payload — a full
        ``[n, dim]`` array or a list of per-shard ``[n, dim/s]`` slices."""
        if isinstance(k_arr, (list, tuple)):
            return len(k_arr[0])
        return len(k_arr)

    def load(self, seq_id, k_arr, v_arr, tokens=None) -> bool:
        """Handoff restore: admission-allocate a table for the payload's
        token count and scatter the prefilled K/V into it — full arrays
        or per-model-shard page-slice lists, tensors or host arrays,
        whatever this cache's own sharding. With ``tokens`` (the context
        the payload prefilled) and the prefix cache on, cached prefix
        positions admit by reference and their rows are NOT re-scattered
        — the payload rows are bitwise identical by model determinism.
        False when the allocation would dip under the watermark (caller
        keeps the sequence queued)."""
        n = self.handoff_tokens(k_arr)
        if tokens is not None and self.prefix is not None:
            shared = self.admit_prefix(seq_id, list(tokens)[:n])
            if shared is None:
                return False
        else:
            shared = 0
            if self.alloc.alloc(seq_id, n) is None:
                return False
        if shared < n:
            if isinstance(k_arr, (list, tuple)):
                k_rows = [p[shared:] for p in k_arr]
                v_rows = [p[shared:] for p in v_arr]
            else:
                k_rows, v_rows = k_arr[shared:], v_arr[shared:]
            self.write_span(seq_id, shared, k_rows, v_rows)
        return True
