"""Elastic training state over torch — commit / restore / broadcast-on-reset.

The counterpart of ``horovod_tpu.elastic.state`` (upstream Horovod's
``hvd.elastic.State``) for the port's training state:

    state = hvd.elastic.ElasticState(model=model, opt=opt, step=0)
    ...
    loss = train_step(tokens)        # updates model and opt in place
    state.step += 1
    state.commit()            # host snapshot (+ optional checkpoint)

A value is a tensor, an ``nn.Module`` (its state dict), a ``torch.optim``
optimizer or a ``DistributedOptimizer`` (the wrapped optimizer's state
dict), a numpy array, or a Python scalar or container of these.

- ``commit()`` copies every value to host memory (a device tensor is
  copied to the host, a host tensor cloned, a module or an optimizer taken
  as its state dict), so a committed snapshot survives the teardown of the
  world and the next optimizer step alike. With ``checkpoint_dir`` set,
  every ``checkpoint_every``-th commit also writes a rank-0 checkpoint
  through the port's ``checkpoint.save``, or its ``AsyncCheckpointer``
  under ``HOROVOD_CKPT_ASYNC`` (default on).
- ``restore()`` rolls the live values back to the last commit IN PLACE:
  each tensor, each parameter and buffer of a module and each state tensor
  of an optimizer keeps its storage and takes the committed value (the
  optimizer holds its parameters' addresses; a fresh optimizer with no
  state yet takes new state tensors through ``load_state_dict``). Where the
  JAX package rebinds each value to a new copy, the port writes into the
  live objects. A ``DistributedOptimizer``'s exchange is reset: no bucket
  in flight, plan order, its launch order agreed again.
- ``sync()`` makes the world consistent after a re-rendezvous: rank 0 (by
  elastic rank assignment always a *survivor* holding the newest commit)
  broadcasts its committed snapshot — its structure as one object, its
  tensors by ``broadcast`` over the world on this rank's device — and every
  rank, including workers that just joined with no history, adopts it in
  place.

``commit()`` doubles as the elastic heartbeat: it fires the env-triggered
fault hooks (fault.py) and polls the driver for membership changes,
raising :class:`HostsUpdatedInterrupt` so the training loop re-enters
rendezvous at a step boundary instead of waiting for a failure.
"""

from __future__ import annotations

import copy
import os
from datetime import timedelta
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..metrics import registry as _registry


class HostsUpdatedInterrupt(Exception):
    """Membership changed (discovery added/removed hosts, or a reset is
    already forming): re-rendezvous at the next step boundary. State is
    already committed when this is raised — the reset path syncs without
    rolling back."""


def _optimizer(x) -> Optional[torch.optim.Optimizer]:
    """The ``torch.optim`` optimizer that ``x`` is or wraps, else None."""
    from ..optimizer import DistributedOptimizer

    if isinstance(x, torch.optim.Optimizer):
        return x
    return x.optimizer if isinstance(x, DistributedOptimizer) else None


def _seq(like, items: list):
    """``items`` in the sequence type of ``like`` (namedtuples included)."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*items)
    return type(like)(items)


def _snapshot(x: Any) -> Any:
    """``x`` copied to host memory: tensors to compact host copies, a module
    or an optimizer to its state dict, anything else deep-copied."""
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return _seq(x, [_snapshot(v) for v in x])
    if torch.is_tensor(x):
        x = x.detach()
        return x.cpu() if x.device.type != "cpu" else x.clone()
    if isinstance(x, torch.nn.Module):
        return _snapshot(x.state_dict())
    opt = _optimizer(x)
    if opt is not None:
        return _snapshot(opt.state_dict())
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True)
    return copy.deepcopy(x)


def _fresh(snap: Any, like: Any = None) -> Any:
    """A new live value holding ``snap``: a copy, placed like ``like`` (a
    tensor goes to ``like``'s device, and becomes numpy where ``like`` is
    numpy)."""
    if isinstance(snap, dict):
        return {k: _fresh(v) for k, v in snap.items()}
    if isinstance(snap, (list, tuple)):
        return _seq(snap, [_fresh(v) for v in snap])
    if torch.is_tensor(snap):
        if isinstance(like, np.ndarray):
            return snap.numpy().copy()
        dev = like.device if torch.is_tensor(like) else snap.device
        return snap.to(dev, copy=True)
    if isinstance(snap, np.ndarray):
        return np.array(snap, copy=True)
    return copy.deepcopy(snap)


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    return tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype


def _load_module(module: torch.nn.Module, snap: dict, where: str) -> None:
    live = module.state_dict()
    if not isinstance(snap, dict) or set(live) != set(snap):
        raise ValueError(
            f"elastic state {where}: the module's state dict keys differ "
            f"from the committed ones")
    with torch.no_grad():
        for k, t in live.items():
            if not torch.is_tensor(snap[k]) or not _same_layout(t, snap[k]):
                raise ValueError(f"elastic state {where}.{k}: {tuple(t.shape)} "
                                 f"{t.dtype} live, committed {snap[k]!r:.80}")
            t.copy_(snap[k])


def _load_optimizer(opt: torch.optim.Optimizer, snap: dict) -> None:
    """The optimizer takes its committed state dict: in place where its
    state has the committed tensors' keys and layouts, else (a fresh
    optimizer, or state the commit did not have) through
    ``load_state_dict`` of a copy, which places each state tensor as the
    optimizer places its own."""
    live = opt.state_dict()
    if [len(g["params"]) for g in live["param_groups"]] != \
            [len(g["params"]) for g in snap["param_groups"]]:
        raise ValueError(
            f"elastic state: the optimizer's param groups hold "
            f"{[len(g['params']) for g in live['param_groups']]} parameters, "
            f"the committed ones {[len(g['params']) for g in snap['param_groups']]}")
    same = live["state"].keys() == snap["state"].keys() and all(
        live["state"][i].keys() == st.keys() and all(
            not torch.is_tensor(v) or (torch.is_tensor(live["state"][i][k])
                                       and _same_layout(live["state"][i][k], v))
            for k, v in st.items())
        for i, st in snap["state"].items())
    if not same:
        opt.load_state_dict(_fresh(snap))
        return
    with torch.no_grad():
        # state_dict() holds the optimizer's own per-parameter state dicts.
        for i, st in snap["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    live["state"][i][k].copy_(v)
                else:
                    live["state"][i][k] = copy.deepcopy(v)
        for group, saved in zip(opt.param_groups, snap["param_groups"]):
            for k, v in saved.items():
                if k == "params":
                    continue
                if torch.is_tensor(group.get(k)):
                    group[k].copy_(torch.as_tensor(v))
                else:
                    group[k] = copy.deepcopy(v)


def _write_back(live: Any, snap: Any, where: str = "") -> Any:
    """``snap`` (a snapshot, or a checkpoint read back) written into the
    live value ``live``; returns the value to keep, which is ``live``
    itself wherever the two have the same structure and layouts."""
    from ..optimizer import DistributedOptimizer

    if isinstance(live, torch.nn.Module):
        _load_module(live, snap, where)
        return live
    opt = _optimizer(live)
    if opt is not None:
        _load_optimizer(opt, snap)
        if isinstance(live, DistributedOptimizer):
            live.reset_exchange()
        return live
    if isinstance(live, dict) and isinstance(snap, dict):
        for k in [k for k in live if k not in snap]:
            del live[k]
        for k, v in snap.items():
            live[k] = _write_back(live.get(k), v, f"{where}.{k}")
        return live
    if isinstance(live, (list, tuple)) and isinstance(snap, (list, tuple)) \
            and len(live) == len(snap):
        items = [_write_back(a, b, f"{where}[{i}]")
                 for i, (a, b) in enumerate(zip(live, snap))]
        if isinstance(live, list):
            live[:] = items
            return live
        return _seq(live, items)
    if torch.is_tensor(live) and torch.is_tensor(snap) and _same_layout(live, snap):
        with torch.no_grad():
            live.copy_(snap)
        return live
    return _fresh(snap, like=live)


class _TensorSpec(NamedTuple):
    """A tensor's place in a broadcast tree's structure."""
    index: int
    shape: tuple
    dtype: torch.dtype


# How long a member of a new generation waits for the others to reach
# ``sync``, and for the driver's next generation (``elastic.run``): a
# respawned worker starts a process and builds its model first.
RENDEZVOUS_TIMEOUT_S = 300.0


def _arrival_barrier() -> None:
    """Wait, on keys of the rendezvous store, until every rank of the world
    has reached ``sync``: under HOROVOD_ELASTIC a collective waits at most
    the stall time, and a joiner that is slow to start is not a stalled
    collective. Each rank sets its own key and waits for every rank's, at
    most ``RENDEZVOUS_TIMEOUT_S``."""
    from ..common import basics

    seq = basics.world_sequence()
    store = basics.store()
    store.set(f"elastic.sync.{seq}.{basics.rank()}", "1")
    try:
        store.wait([f"elastic.sync.{seq}.{r}" for r in range(basics.size())],
                   timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    except RuntimeError as exc:
        raise basics.HorovodInternalError(
            f"not every rank reached ElasticState.sync within "
            f"{RENDEZVOUS_TIMEOUT_S:.0f}s") from exc


def _broadcast_tree(tree: Any, root_rank: int) -> Any:
    """Root's ``tree`` (host tensors and plain values) on every rank: its
    structure with each tensor's shape and dtype in one object broadcast,
    then each tensor by ``broadcast`` over the world on this rank's device
    (NCCL moves device memory only)."""
    from ..common import basics
    from ..parallel import collectives

    tensors: list = []

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return _seq(x, [strip(v) for v in x])
        if torch.is_tensor(x):
            tensors.append(x)
            return _TensorSpec(len(tensors) - 1, tuple(x.shape), x.dtype)
        return x

    root = basics.rank() == root_rank
    skeleton = collectives.broadcast_object(strip(tree) if root else None,
                                            root_rank=root_rank)

    def collect(x):
        if isinstance(x, _TensorSpec):
            tensors.append(torch.empty(x.shape, dtype=x.dtype))
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    if not root:
        collect(skeleton)
    dev = basics.device()
    for t in tensors:
        buf = t.to(dev)
        collectives.broadcast(buf, root_rank)
        if buf is not t:
            t.copy_(buf)

    def fill(x):
        if isinstance(x, _TensorSpec):
            return tensors[x.index]
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return _seq(x, [fill(v) for v in x])
        return x

    return fill(skeleton)


class ElasticState:
    """Named training values with commit/restore/sync semantics. Values are
    attributes (``state.model``), the names are the keys you passed to the
    constructor; assignment replaces the live value, never the commit."""

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, **values: Any) -> None:
        object.__setattr__(self, "_checkpoint_dir", checkpoint_dir)
        object.__setattr__(self, "_checkpoint_every", max(int(checkpoint_every), 1))
        object.__setattr__(self, "_values", dict(values))
        object.__setattr__(self, "_committed", None)
        object.__setattr__(self, "_commits", 0)
        # Async checkpoint writer, created on first checkpointing commit
        # when HOROVOD_CKPT_ASYNC is on. Rank-gated there, not here: rank is
        # unknown until the world initializes.
        object.__setattr__(self, "_async_writer", None)
        # The construction-time values are the first commit: restore() and
        # sync() are well-defined before the loop's first explicit commit.
        self.commit(checkpoint=False, check_host_updates=False)

    # -- attribute routing ---------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(f"ElasticState has no value {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._values[name] = value

    def to_dict(self) -> dict:
        """The live values (not copies)."""
        return dict(self._values)

    def committed_dict(self) -> dict:
        """The last committed snapshot (not copies; treat as read-only)."""
        return dict(self._committed or {})

    # -- commit / restore ----------------------------------------------------

    def commit(self, checkpoint: Optional[bool] = None,
               check_host_updates: bool = True) -> None:
        """Snapshot the live values as the new rollback point. Also runs the
        fault-injection hook and (in an elastic worker) the membership poll
        — see module docstring."""
        object.__setattr__(self, "_committed", _snapshot(self._values))
        object.__setattr__(self, "_commits", self._commits + 1)
        _registry().counter(
            "horovod_elastic_commits_total",
            help="ElasticState.commit() calls").inc()
        if checkpoint is None:
            checkpoint = (self._checkpoint_dir is not None
                          and self._commits % self._checkpoint_every == 0)
        if checkpoint and self._checkpoint_dir:
            self._write_checkpoint()
        from . import fault

        if fault.armed():
            step = self._values.get("step", self._values.get("batch"))
            if step is not None:
                fault.maybe_die(step)
        if check_host_updates:
            from .run import poll_host_updates

            if poll_host_updates():
                raise HostsUpdatedInterrupt(
                    "elastic membership changed; re-rendezvous requested")

    def _write_checkpoint(self) -> None:
        from .. import checkpoint as ckpt
        from ..ckpt_async import AsyncCheckpointer, async_enabled
        from ..common import basics

        if not async_enabled():
            ckpt.save(self._checkpoint_dir, self._committed)
            return
        # Off the step path: rank 0 hands the writer thread the snapshot,
        # which submit() copies before it returns. No completion barrier:
        # the commit pipeline keeps the on-disk state crash-consistent at
        # every instant, so the other ranks need not wait (they never read
        # the directory outside cold start).
        if basics.is_initialized() and basics.rank() != 0:
            return
        writer = self._async_writer
        if writer is None or writer.path != self._checkpoint_dir:
            if writer is not None:
                writer.close()
            writer = AsyncCheckpointer(self._checkpoint_dir)
            object.__setattr__(self, "_async_writer", writer)
        writer.submit(self._committed)

    def checkpoint_wait(self, timeout: float = 120.0) -> bool:
        """Block until any in-flight background checkpoint commit lands
        (True), or ``timeout`` passes (False). No-op without a writer."""
        writer = self._async_writer
        return True if writer is None else writer.wait(timeout)

    def restore(self) -> None:
        """Roll the live values back to the last commit, in place
        (uncommitted steps are discarded)."""
        if self._committed is None:  # pragma: no cover - commit() in __init__
            raise RuntimeError("nothing committed yet")
        object.__setattr__(self, "_values",
                           _write_back(self._values, self._committed))
        _registry().counter(
            "horovod_elastic_restores_total",
            help="rollbacks to the last committed elastic state").inc()

    def load_checkpoint(self) -> bool:
        """Cold-start restore from ``checkpoint_dir`` (full-job restart, or
        a respawned worker; not the in-memory reset path), in place into
        the live values. Returns False when no checkpoint exists.
        Single-rank read (``verify=False``): callers sync() afterwards, and
        the broadcast is the consistency guarantee."""
        from .. import checkpoint as ckpt
        from ..ckpt_async import drain

        # A cold start in the same process must see every commit already
        # submitted to a background writer — flush before looking at the
        # filesystem.
        if self._checkpoint_dir:
            drain(self._checkpoint_dir)
        if not self._checkpoint_dir or not os.path.isdir(self._checkpoint_dir):
            return False
        loaded = ckpt.restore(self._checkpoint_dir, verify=False, device="cpu")
        object.__setattr__(self, "_values", _write_back(self._values, loaded))
        self.commit(checkpoint=False, check_host_updates=False)
        return True

    # -- reset-path consistency ---------------------------------------------

    def sync(self, root_rank: int = 0) -> None:
        """Adopt rank ``root_rank``'s committed snapshot everywhere (the
        post-rendezvous broadcast; new workers join with whatever state they
        constructed and leave with the survivors' commit), in place. The
        count of commits comes along, so every rank checkpoints at the same
        commits (``save`` waits for rank 0's) however many it made. Under
        HOROVOD_ELASTIC every rank first waits on the rendezvous store
        until all have arrived, so the broadcast's stall clock starts only
        then."""
        from ..common import basics

        if basics.is_initialized() and basics.size() > 1:
            if basics.config().elastic:
                _arrival_barrier()
            root = _broadcast_tree(
                {"commits": self._commits, "state": self._committed}, root_rank)
            object.__setattr__(self, "_committed", root["state"])
            object.__setattr__(self, "_commits", root["commits"])
        object.__setattr__(self, "_values",
                           _write_back(self._values, self._committed))
