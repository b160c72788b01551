"""Checkpoint and resume: the rank-0-writes, restore-everywhere contract of
``horovod_tpu.checkpoint``, on ``torch.save``.

    hvd.checkpoint.save(path, {"model": model.state_dict(), "opt": opt,
                               "step": step}, step=step)     # rank 0 writes
    state = hvd.checkpoint.restore(path, template=live, step=step)
    # every rank reads; restore() compares a digest of what each rank read
    # and raises if any rank read other state. On a filesystem the ranks
    # do not share: restore(path, verify=False) on rank 0 only, then
    # broadcast_parameters / broadcast_optimizer_state /
    # broadcast_resume_state.

The commit pipeline is the JAX package's, copied as it is: every save
stages into a sibling ``<target>.tmp.<pid>``, fsyncs it, marks it complete
with a sibling ``.ok`` file, and swaps it into place with renames, so a
writer killed at any point leaves the old checkpoint, the new one, or a
complete stage that the next save or restore adopts
(``_heal_interrupted``). The layout on disk is the same
(``<path>/step_N/``, ``.tmp.<pid>``, ``.ok``, ``.trash.*``); only the
serialization differs: one ``torch.save`` file, ``state.pt``, inside the
staged directory, in place of orbax's tree.

That file holds host copies only. ``torch.save`` of a view writes its
whole storage (a fusion bucket, say), and a file written from device
tensors names the ``cuda:N`` it came from, so every tensor is copied to
compact host memory first; numpy arrays and scalars are lifted to tensors,
so the file loads under ``torch.load(weights_only=True)``. A state is
nested dicts, lists and tuples whose leaves are tensors, numpy numbers,
Python ints, floats, bools, strings and None, and optimizers: a
``torch.optim`` optimizer, or a ``DistributedOptimizer`` wrapping one, is
saved as its ``state_dict()``.

``restore(..., template=...)`` copies each loaded tensor into the
template's tensor in place, after checking its shape and dtype: the
parameters, the optimizer state and a data counter keep their storage,
which is the only form of restore that a captured CUDA graph sees
(``optimizer.load_state_dict`` puts new tensors in, and a graph replayed
afterwards reads the old ones). An optimizer leaf of the template takes
its state tensors in place and every hyperparameter of its param groups
(lr, momentum, ...): a state dict in its place would take the tensors but
leave the live groups at the constructor's values. A ``torch.optim``
optimizer creates its state at its first step; ``init_optimizer_state``
creates it before a restore into a fresh run.

Importing the module initializes nothing: ``load_for_inference`` runs in
a process that never calls ``init()``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from datetime import timedelta
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .common import basics
from .common.basics import HorovodInternalError
from .optimizer import DistributedOptimizer
from .parallel import collectives
from .parallel import sharded as sh

STATE_FILE = "state.pt"

# Leaves that load under torch.load(weights_only=True) as they are.
_PLAIN = (bool, int, float, complex, str, bytes, type(None), torch.dtype,
          torch.device, torch.Size)


# -- crash-consistent commits -------------------------------------------------
#
# Copied from the JAX package as they are. A worker killed mid-commit must
# never leave a half-written directory where the last good checkpoint stood:
# every save stages into a sibling temp directory, fsyncs it, marks it
# complete (a sibling ``.ok`` file, written after the data is durable), and
# swaps it into place with renames — the only atomic primitive POSIX gives
# for directories.


def _fsync_tree(path: str) -> None:
    """Best-effort fsync of every file and directory under ``path`` — the
    rename below publishes the commit, so the data must be durable first.
    Filesystems that reject directory fsync (some network mounts) are
    tolerated: the rename ordering still bounds the damage to 'old or new'."""
    for root, dirs, files in os.walk(path, topdown=False):
        for name in files + [os.curdir]:
            try:
                fd = os.open(os.path.join(root, name) if name != os.curdir
                             else root, os.O_RDONLY)
            except OSError:
                continue
            try:
                os.fsync(fd)
            except OSError:
                pass
            finally:
                os.close(fd)


def _test_pause(point: str) -> None:
    """Deterministic kill window for the crash-consistency tests: when
    ``HOROVOD_CKPT_TEST_STALL`` names this pipeline point (``stage`` —
    staged copy exists but carries no ``.ok`` yet; ``rename`` — between
    the swap's two renames, the brief no-target window), the commit holds
    for ``HOROVOD_CKPT_TEST_STALL_S`` so the test can SIGKILL the writer
    exactly there. No-op unless explicitly armed."""
    if os.environ.get("HOROVOD_CKPT_TEST_STALL", "") == point:
        import time

        time.sleep(float(os.environ.get("HOROVOD_CKPT_TEST_STALL_S", "30")))


def _heal_interrupted(target: str) -> None:
    """Adopt or discard leftovers of an interrupted commit next to
    ``target``: a complete staged copy (``.tmp.* + .ok``) replaces a missing
    target (the crash hit between the two swap renames); incomplete stages
    and displaced old checkpoints (``.trash.*``) are deleted. Races between
    ranks healing a shared filesystem are benign — every rename is wrapped,
    and whoever wins leaves a valid target."""
    parent, base = os.path.split(target)
    try:
        names = os.listdir(parent or os.curdir)
    except OSError:
        return
    stale: list[str] = []
    for n in sorted(names):
        p = os.path.join(parent, n)
        if n.startswith(base + ".tmp.") and not n.endswith(".ok"):
            if os.path.exists(p + ".ok") and not os.path.exists(target):
                try:
                    os.rename(p, target)
                    os.unlink(p + ".ok")
                    continue
                except OSError:  # another rank adopted first
                    pass
            stale.append(p)
        elif n.startswith(base + ".trash."):
            stale.append(p)
    for p in stale:
        shutil.rmtree(p, ignore_errors=True)
        try:
            os.unlink(p + ".ok")
        except OSError:
            pass


def _swap_into_place(tmp: str, target: str) -> None:
    """Atomic publish: mark the staged copy complete, move any existing
    checkpoint aside, rename the stage in, then clean up. A kill at ANY
    point leaves a restorable state (the ``.ok`` marker makes the stage
    adoptable during the brief no-target window)."""
    ok = tmp + ".ok"
    with open(ok, "w") as f:
        f.write("complete\n")
        f.flush()
        os.fsync(f.fileno())
    trash = f"{target}.trash.{os.path.basename(tmp).rsplit('.', 1)[-1]}"
    if os.path.exists(target):
        os.rename(target, trash)
    _test_pause("rename")
    os.rename(tmp, target)
    try:  # publish the renames before declaring the commit durable
        fd = os.open(os.path.dirname(target) or os.curdir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass
    try:
        os.unlink(ok)
    except OSError:
        pass
    shutil.rmtree(trash, ignore_errors=True)


# -- the state tree -----------------------------------------------------------


def _map(fn, tree, path: str = ""):
    """``fn(leaf, path)`` over the leaves of nested dicts, lists and
    tuples, in order."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{path}/{i}") for i, v in enumerate(tree))
    return fn(tree, path)


def _leaves(tree) -> list:
    out = []
    _map(lambda x, _: out.append(x), tree)
    return out


def _optimizer(x) -> Optional[torch.optim.Optimizer]:
    """The ``torch.optim`` optimizer that ``x`` is or wraps (a
    ``DistributedOptimizer``), else None."""
    if isinstance(x, torch.optim.Optimizer):
        return x
    return x.optimizer if isinstance(x, DistributedOptimizer) else None


def host_copy(state: Any, snapshot: bool = True) -> Any:
    """``state`` with every tensor in compact host memory, every numpy
    number lifted to a tensor and every optimizer replaced by its state
    dict: what ``save_local`` writes. ``snapshot``
    copies host tensors too, so that the result never changes when the
    caller's tensors do; without it a host tensor that owns exactly its
    storage is kept as it is (a device tensor is always copied). Raises
    ``TypeError`` on a leaf that ``torch.load(weights_only=True)`` would
    refuse."""
    def one(x, path):
        opt = _optimizer(x)
        if opt is not None:
            return _map(one, opt.state_dict(), path)
        if torch.is_tensor(x):
            x = x.detach()
            if x.device.type != "cpu":
                return x.cpu()
            compact = (x.is_contiguous() and x.storage_offset() == 0
                       and x.untyped_storage().nbytes() == x.numel() * x.element_size())
            return x.clone(memory_format=torch.contiguous_format) \
                if snapshot or not compact else x
        if isinstance(x, (np.ndarray, np.generic)):
            if x.dtype.kind not in "biufc":
                raise TypeError(f"checkpoint leaf {path or '/'}: numpy dtype "
                                f"{x.dtype} has no tensor form")
            return torch.from_numpy(np.array(x, copy=True))
        if isinstance(x, _PLAIN):
            return x
        raise TypeError(f"checkpoint leaf {path or '/'}: {type(x).__name__} is "
                        "not a tensor, a numpy number or a plain Python value")

    return _map(one, state)


def _fill(template, loaded, path: str = "", shard=None):
    """``loaded`` written into ``template``: each template tensor takes the
    loaded tensor's value in place (same shape and dtype, or ValueError),
    an optimizer its state dict (``_fill_optimizer``), a numpy leaf becomes
    the loaded value as numpy, and any other leaf the loaded value. ``shard = (plan, shard_rank)``: a ``ShardedBuckets`` of
    the template takes that shard rank's rows of the loaded full leaves
    (fresh zero pad)."""
    where = path or "/"
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(template) != set(loaded):
            raise ValueError(
                f"checkpoint {where}: template keys {sorted(map(str, template))} "
                f"!= checkpoint keys "
                f"{sorted(map(str, loaded)) if isinstance(loaded, dict) else type(loaded).__name__}")
        return {k: _fill(v, loaded[k], f"{path}/{k}", shard) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(template):
            raise ValueError(f"checkpoint {where}: template holds {len(template)} "
                             f"entries, the checkpoint {loaded!r:.80}")
        return type(template)(_fill(t, v, f"{path}/{i}", shard)
                              for i, (t, v) in enumerate(zip(template, loaded)))
    if isinstance(template, sh.ShardedBuckets):
        if shard is None:
            raise ValueError(f"checkpoint {where}: a ShardedBuckets template "
                             "restores through restore_sharded")
        plan, shard_rank = shard
        want = sh._leaves(plan)
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(want):
            raise ValueError(f"checkpoint {where}: expected the plan's "
                             f"{len(want)} full leaves")
        for i, (d, t) in enumerate(zip(want, loaded)):
            _check(f"{where}/{i}", t, tuple(d.shape), getattr(torch, d.dtype))
        with torch.no_grad():
            for row, new in zip(template, sh.shard_params(loaded, plan, shard_rank)):
                row.copy_(new)
        return template
    if torch.is_tensor(template):
        _check(where, loaded, tuple(template.shape), template.dtype)
        with torch.no_grad():
            template.copy_(loaded)
        return template
    opt = _optimizer(template)
    if opt is not None:
        _fill_optimizer(opt, loaded, path)
        return template
    if isinstance(template, (np.ndarray, np.generic)):
        _check(where, loaded, np.shape(template),
               torch.from_numpy(np.zeros(0, template.dtype)).dtype)
        return loaded.numpy()
    return loaded


def _fill_optimizer(opt: torch.optim.Optimizer, loaded, path: str) -> None:
    """``opt`` takes the saved state dict ``loaded`` as ``load_state_dict``
    would, but in place: each state tensor is copied into the live one, and
    each param group takes every key of the saved group but ``params`` (a
    tensor hyperparameter copied in place)."""
    where = path or "/"
    if not isinstance(loaded, dict) or set(loaded) != {"state", "param_groups"}:
        raise ValueError(f"checkpoint {where}: the template holds an optimizer, "
                         f"the checkpoint no optimizer state dict")
    live = opt.state_dict()
    if loaded["state"] and not live["state"]:
        raise ValueError(f"checkpoint {where}: the optimizer has no state yet; "
                         "call init_optimizer_state before the restore")
    _fill(live["state"], loaded["state"], f"{path}/state")
    saved = loaded["param_groups"]
    if [len(g["params"]) for g in saved] != [len(g["params"]) for g in opt.param_groups]:
        raise ValueError(f"checkpoint {where}: param groups of "
                         f"{[len(g['params']) for g in saved]} parameters in the "
                         f"checkpoint, {[len(g['params']) for g in opt.param_groups]} "
                         "in the optimizer")
    with torch.no_grad():
        for group, new in zip(opt.param_groups, saved):
            for k, v in new.items():
                if k == "params":
                    continue
                if torch.is_tensor(group.get(k)):
                    group[k].copy_(torch.as_tensor(v))
                else:
                    group[k] = v


def _check(where: str, loaded, shape: tuple, dtype) -> None:
    if not torch.is_tensor(loaded):
        raise ValueError(f"checkpoint {where}: template holds a tensor, the "
                         f"checkpoint {type(loaded).__name__}")
    if tuple(loaded.shape) != tuple(shape) or loaded.dtype != dtype:
        raise ValueError(f"checkpoint {where}: {tuple(loaded.shape)} "
                         f"{loaded.dtype} in the checkpoint, {tuple(shape)} "
                         f"{dtype} in the template")


def _target(path: str, step: Optional[int]) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step}") \
        if step is not None else os.path.abspath(path)


def _load(target: str):
    """The state saved at ``target``, on the host. Raises
    ``FileNotFoundError`` when there is none."""
    file = os.path.join(target, STATE_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(f"no checkpoint at {target}")
    return torch.load(file, map_location="cpu", weights_only=True)


def _read(path: str, step: Optional[int], verify: bool):
    """What every rank's restore starts with: heal, load to the host,
    compare the ranks' digests."""
    target = _target(path, step)
    if not os.path.exists(target):
        # The writer may have been killed between the commit's two renames:
        # adopt a complete staged copy if one is waiting.
        _heal_interrupted(target)
    loaded = _load(target)
    if verify:
        _verify_cross_rank_digest(loaded, f"{path}.{step}")
    return loaded


# -- save and restore ---------------------------------------------------------


def save_local(path: str, state: Any, step: Optional[int] = None) -> None:
    """The single-writer commit pipeline — stage, fsync, ``.ok``, atomic
    rename — with NO rank gate and NO completion barrier. This is the core
    :func:`save` wraps, and what the background writer
    (:class:`horovod_tpu_torch.ckpt_async.AsyncCheckpointer`) runs off the
    step path: collectives may only run on the training thread."""
    target = _target(path, step)
    state = host_copy(state, snapshot=False)
    # Adopt or clean the leftovers of an earlier kill first.
    _heal_interrupted(target)
    os.makedirs(os.path.dirname(target) or os.curdir, exist_ok=True)
    tmp = f"{target}.tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    _test_pause("stage")
    _fsync_tree(tmp)
    _swap_into_place(tmp, target)


def _barrier() -> None:
    dev = basics.device()
    with collectives.backend_errors("checkpoint barrier"):
        if dev.type == "cuda":
            dist.barrier(device_ids=[dev.index])
        else:
            dist.barrier()


def _verify_timeout() -> float:
    return float(os.environ.get("HOROVOD_CKPT_VERIFY_TIMEOUT", "120"))


def _store_barrier() -> None:
    """``save``'s completion wait under HOROVOD_ELASTIC, where the process
    group's timeout is the stall time, which a large commit may outlast:
    rank 0 sets a key of the rendezvous store once its commit is done, and
    the other ranks wait for it at most ``HOROVOD_CKPT_VERIFY_TIMEOUT``
    seconds (default 120)."""
    key = f"ckpt.saved.{basics.world_sequence()}"
    store = basics.store()
    if basics.rank() == 0:
        store.set(key, "1")
        return
    timeout = _verify_timeout()
    try:
        store.wait([key], timedelta(seconds=timeout))
    except RuntimeError as exc:
        raise HorovodInternalError(
            f"rank 0's checkpoint commit did not complete within "
            f"{timeout:.0f}s (HOROVOD_CKPT_VERIFY_TIMEOUT)") from exc


def save(path: str, state: Any, step: Optional[int] = None, force: bool = True) -> None:
    """Write a checkpoint from rank 0 only; the other ranks wait until rank
    0's commit is done (the reference's contract: 'save checkpoints only on
    worker 0 to prevent other workers from corrupting them'): in a barrier
    of the world, or under HOROVOD_ELASTIC on a key of the rendezvous store
    (``_store_barrier``). Not initialized means a process of its own, which
    writes. ``force`` is accepted as the JAX package's is: a commit always
    replaces the checkpoint at ``path``."""
    if not basics.is_initialized() or basics.rank() == 0:
        save_local(path, state, step)
    if basics.is_initialized() and basics.size() > 1:
        if basics.config().elastic:
            _store_barrier()
        else:
            _barrier()


def _device(device) -> torch.device:
    if device is None and basics.is_initialized():
        return basics.device()
    return basics.resolve_device(device)


def restore(path: str, template: Any = None, step: Optional[int] = None,
            verify: bool = True, device=None) -> Any:
    """Read a checkpoint on every rank (the ranks share the filesystem).

    With ``template`` (the live state: the same nesting, tensors of the
    same shapes and dtypes, the optimizers themselves), each loaded tensor
    is copied into the template's tensor in place, each optimizer takes
    its state and param-group hyperparameters in place, and the template's
    structure is returned holding the template's own tensors and
    optimizers (its other leaves replaced by the loaded values). Without it, the loaded state is returned with its
    tensors on ``device`` (None: this rank's device, or the card when not
    initialized; ``"cpu"`` keeps them on the host).

    With ``verify=True`` (default) every rank hashes what it read and the
    digests are compared before anything is written, so ranks that read
    divergent files (stale NFS caches, filesystems not shared) fail loudly
    instead of training from inconsistent state. The check is collective:
    every rank must call restore(). If you restore on rank 0 only and
    broadcast, pass ``verify=False``. A missing checkpoint raises
    ``FileNotFoundError``."""
    loaded = _read(path, step, verify)
    if template is not None:
        return _fill(template, loaded)
    dev = _device(device)
    return _map(lambda x, _: x.to(dev) if torch.is_tensor(x) else x, loaded)


def _digest(state: Any) -> str:
    """SHA-256 over every leaf in order: dtype, shape and bytes of a tensor
    (bf16 through a byte view), and type and ``repr`` of any other leaf."""
    h = hashlib.sha256()
    for leaf in _leaves(state):
        if torch.is_tensor(leaf):
            t = leaf.detach().cpu().contiguous()
            h.update(str(t.dtype).encode())
            h.update(str(tuple(t.shape)).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy())   # no copy
        elif isinstance(leaf, (np.ndarray, np.generic)):
            arr = np.ascontiguousarray(leaf)
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.reshape(-1).view(np.uint8))
        else:
            h.update(f"{type(leaf).__name__}:{leaf!r}".encode())
    return h.hexdigest()


def _verify_cross_rank_digest(state: Any, tag: str) -> None:
    """Every rank's SHA-256 of the restored state, exchanged through the
    world's rendezvous store (``basics.store``) with a wait bounded by
    ``HOROVOD_CKPT_VERIFY_TIMEOUT`` (default 120 s); raises if a rank does
    not take part in time or read other state than rank 0. A collective on
    the device would hang until the process group's timeout instead. Not
    initialized, or a world of one: nothing to compare."""
    if not basics.is_initialized() or basics.size() == 1:
        return
    mine = _digest(state)
    base = f"ckpt.digest.{basics.world_sequence()}.{tag}"
    keys = [f"{base}.{r}" for r in range(basics.size())]
    store = basics.store()
    store.set(keys[basics.rank()], mine)
    timeout = _verify_timeout()
    try:
        store.wait(keys, timedelta(seconds=timeout))
    except RuntimeError as exc:
        raise HorovodInternalError(
            f"checkpoint digest verification did not complete within "
            f"{timeout:.0f}s — restore(verify=True) is collective and every "
            f"rank must call it; if you restore on rank 0 only and "
            f"broadcast, pass verify=False"
        ) from exc
    digests = [store.get(k) for k in keys]
    bad = [r for r, d in enumerate(digests) if d != digests[0]]
    if bad:
        raise HorovodInternalError(
            f"checkpoint restore diverged across ranks: ranks {bad} read "
            f"different state than rank 0 (non-shared or stale filesystem?); "
            f"restore on rank 0 only and broadcast, or fix the filesystem"
        )


def init_optimizer_state(optimizer) -> None:
    """Create the per-parameter state of a ``torch.optim`` optimizer (or
    of a ``DistributedOptimizer``'s) that has not stepped yet, as its first
    step would: one step of the wrapped optimizer with zero gradients, the
    parameters' own gradients put back after. From zero state, Adam's and
    SGD's (momentum) update of a zero gradient is zero, so no parameter
    moves; the state's counters advance, which a restore into it then
    overwrites. Weight decay would move the parameters, so it raises."""
    opt = getattr(optimizer, "optimizer", optimizer)
    params = [p for g in opt.param_groups for p in g["params"]]
    if all(opt.state.get(p) for p in params):
        return
    if any(g.get("weight_decay", 0) for g in opt.param_groups):
        raise ValueError("weight decay moves the parameters on a zero "
                         "gradient: create the optimizer state another way")
    grads = [p.grad for p in params]
    try:
        for p in params:
            p.grad = torch.zeros_like(p)
        opt.step()
    finally:
        for p, g in zip(params, grads):
            p.grad = g


# -- sharded state ------------------------------------------------------------


def _shard_rank(plan, layout) -> int:
    if layout is None:
        if plan.shard_size != 1:
            raise ValueError(f"a plan sharded over {plan.shard_size} ranks "
                             "needs layout= (the optimizer's ShardedLayout)")
        return 0
    if layout.shard_size != plan.shard_size:
        raise ValueError(f"plan shards over {plan.shard_size} ranks, the "
                         f"layout's shard group has {layout.shard_size}")
    return layout.shard_rank


def _consolidate(state: Any, plan, layout=None) -> Any:
    """The full state of a sharded one: each :class:`ShardedBuckets`
    becomes the plan's full leaves (every shard rank's rows gathered over
    the shard group, the pad tail dropped: ``sharded.unshard_tree``), every
    other leaf stays. Collective over the shard group."""
    n = plan.shard_size
    _shard_rank(plan, layout)
    rows_of = {}

    def gather(x, _):
        if isinstance(x, sh.ShardedBuckets) and n > 1:
            full = [collectives.all_gather_into(r.detach(), layout.shard_group).view(n, -1)
                    for r in x]
            rows_of[id(x)] = [sh.ShardedBuckets([f[s] for f in full]) for s in range(n)]
        return x

    _map(gather, state)
    trees = [_map(lambda x, _: rows_of[id(x)][s] if id(x) in rows_of else x, state)
             for s in range(n)]
    return sh.unshard_tree(trees, plan)


def save_sharded(path: str, state: Any, plan, step: Optional[int] = None,
                 layout=None) -> None:
    """Checkpoint a SHARDED training state: ``state`` holds
    :class:`horovod_tpu_torch.parallel.sharded.ShardedBuckets` where it is
    sharded (the parameter rows, Adam's moments of them), ``plan`` is the
    :class:`ShardPlan` they were cut with and ``layout`` the
    ``ShardedLayout`` they live on (None at shard size 1). The checkpoint
    holds the CONSOLIDATED full leaves, with no pad (every shard rank's rows
    gathered over the shard group), so it does not depend on the mesh: it
    restores into any ('batch', 'shard') layout, or into the flat
    data-parallel state with :func:`restore`. Every rank calls; rank 0 writes, as :func:`save`."""
    save(path, _consolidate(state, plan, layout), step)


def restore_sharded(path: str, template: Any, plan, step: Optional[int] = None,
                    verify: bool = True, layout=None) -> Any:
    """Restore a checkpoint written by :func:`save_sharded` (or a plain
    :func:`save` of the full leaves) INTO a sharded layout: where
    ``template`` (the live sharded state) holds a ``ShardedBuckets``, this
    rank's rows of the full leaves are cut to ``plan`` with a fresh zero pad
    and copied into the template's rows in place; every other leaf as
    :func:`restore`. ``plan`` and ``layout`` may differ from the ones the
    checkpoint was written under. Same digest contract as :func:`restore`."""
    shard_rank = _shard_rank(plan, layout)
    return _fill(template, _read(path, step, verify), shard=(plan, shard_rank))


# -- inference export ---------------------------------------------------------


def merge_stacked_stats(stats: Any, axis: int = 0) -> Any:
    """Consolidate batch statistics that carry a leading device dimension
    into single-replica values by averaging over ``axis``."""
    return _map(lambda t, _: t.mean(dim=axis) if torch.is_tensor(t)
                else np.mean(t, axis=axis), stats)


def average_stats_across_ranks(stats: Any) -> Any:
    """Consolidate per-rank batch statistics (each rank tracked its own
    BatchNorm running statistics, reference-style) by averaging them over
    the world in float64, each leaf cast back to its dtype and place.
    Every leaf's allreduce is started before the first is waited for.
    Collective: every rank must call."""
    if _world_size() == 1:
        return stats
    dev = basics.device()
    leaves = _leaves(stats)
    bufs = [torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x.detach())
            .to(dev, torch.float64, copy=True) for x in leaves]
    works = [dist.all_reduce(b, async_op=True) for b in bufs]
    for w in works:
        w.wait()
    avg = iter(b.div_(basics.size()) for b in bufs)

    def back(x, _):
        a = next(avg)
        if torch.is_tensor(x):
            return a.to(x.device, x.dtype)
        return a.cpu().numpy().astype(np.asarray(x).dtype)

    return _map(back, stats)


def _world_size() -> int:
    return basics.size() if basics.is_initialized() else 1


def export_for_inference(path: str, state: Any, *,
                         drop: tuple = ("opt_state",),
                         stats_key: str = "batch_stats",
                         stacked_stats_axis: Optional[int] = None,
                         cross_rank: Optional[bool] = None) -> Any:
    """Strip the training-only state and write a single-replica serving
    checkpoint (the reference's optimize-for-inference step).

    - ``drop``: top-level keys removed (optimizer state, step counters you
      don't serve with).
    - ``stats_key``: per-rank/per-device batch statistics to consolidate.
      With ``stacked_stats_axis`` the leaves carry a leading device dim and
      are averaged over it; with ``cross_rank`` (default: whenever the
      world is larger than one) each process's stats are averaged over the
      world (collective — every rank must call export_for_inference).
    - Writes on rank 0 only, with the same completion barrier as
      :func:`save`; returns the serving state on every rank.

    The result restores with :func:`load_for_inference` in a process that
    never calls ``init()``.
    """
    if not isinstance(state, dict):
        raise TypeError(f"state must be a dict of top-level keys, got {type(state)}")
    serving = {k: v for k, v in state.items() if k not in set(drop)}
    if stats_key in serving:
        stats = serving[stats_key]
        if stacked_stats_axis is not None:
            stats = merge_stacked_stats(stats, axis=stacked_stats_axis)
        if cross_rank if cross_rank is not None else _world_size() > 1:
            stats = average_stats_across_ranks(stats)
        serving[stats_key] = stats
    save(path, serving)
    return serving


def load_for_inference(path: str, template: Any = None) -> Any:
    """Restore a serving checkpoint written by :func:`export_for_inference`:
    no ``init()``, no collective. With ``template`` its tensors are filled
    in place, as :func:`restore` fills them; without it the state comes
    back on the host."""
    loaded = _load(os.path.abspath(path))
    return _fill(template, loaded) if template is not None else loaded


# -- resume -------------------------------------------------------------------


def latest_step(path: str) -> Optional[int]:
    """Highest step_N subdirectory under ``path`` (resume-epoch discovery,
    as the reference's examples scan for existing checkpoint files)."""
    try:
        steps = [int(d.split("_", 1)[1]) for d in os.listdir(path)
                 if d.startswith("step_") and d.split("_", 1)[1].isdigit()]
    except OSError:
        return None
    return max(steps) if steps else None


def broadcast_resume_state(state: Any, root_rank: int = 0) -> Any:
    """Root's ``state`` (epoch counters, small trees) on every rank, each
    leaf of its own type: a tensor keeps its dtype and device (broadcast
    over the world on this rank's device), any other leaf comes back as
    root pickled it (an ``int`` stays an ``int``), all of them in one
    object broadcast. Every rank passes the same structure and shapes."""
    if basics.size() == 1:
        return state
    dev = basics.device()
    leaves = _leaves(state)
    others = iter(collectives.broadcast_object(
        [x for x in leaves if not torch.is_tensor(x)], root_rank))

    def one(x, _):
        if not torch.is_tensor(x):
            return next(others)
        buf = x.detach().to(dev, copy=True).contiguous()
        collectives.broadcast(buf, root_rank)
        return buf.to(x.device)

    return _map(one, state)
