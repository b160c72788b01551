"""Background checkpoint committer: the counterpart of
``horovod_tpu.ckpt_async.writer``.

A synchronous ``checkpoint.save`` charges the whole commit — serialization,
the fsync walk, the rename swap — to the training step that saves. This
module moves the commit to a writer thread:

- ``submit(state, step)`` takes a host snapshot of ``state`` on the
  calling thread (``checkpoint.host_copy``: device tensors copied to the
  host, host tensors cloned) and hands the snapshot to the writer. Where
  the JAX package hands over its state by reference (JAX arrays never
  change), torch tensors are changed in place by the next optimizer step,
  so the snapshot is complete before ``submit`` returns and the writer
  never reads a tensor the training step writes.
- A step blocks only while the PREVIOUS commit is still in flight — one
  commit in the pipe, never a growing queue, so a slow filesystem applies
  backpressure instead of accumulating snapshots. The blocked wall time is
  observed in ``horovod_ckpt_step_block_seconds`` and the commit itself in
  ``horovod_ckpt_commit_seconds`` (the port's ``metrics.registry()``).
- Crash consistency is unchanged: the writer runs
  ``checkpoint.save_local``, the stage → fsync → ``.ok`` → atomic-rename
  pipeline, and never a collective (collectives belong to the training
  thread).
- A failed commit is not silent: the error is raised again on the next
  submit()/wait()/close() on the training thread.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Optional

from .. import checkpoint as _ckpt
from ..metrics import registry as _registry
from ..utils.logging import log


def async_enabled() -> bool:
    """``HOROVOD_CKPT_ASYNC`` gate, default ON (set 0/false to force the
    synchronous writer)."""
    return os.environ.get("HOROVOD_CKPT_ASYNC", "1") not in ("0", "false")


# In-process writer registry: a reader in the SAME process must observe
# every commit already submitted — drain(path) flushes any live writer for
# that directory before the reader checks the filesystem. Readers in other
# processes need nothing: the commit pipeline keeps the directory
# crash-consistent at every instant.
_writers_lock = threading.Lock()
_writers: dict[str, "AsyncCheckpointer"] = {}


def drain(path: str, timeout: float = 120.0) -> bool:
    """Flush any in-process async writer targeting ``path``. True when no
    writer exists or it drained in time."""
    with _writers_lock:
        writer = _writers.get(os.path.abspath(path))
    return True if writer is None else writer.wait(timeout)


class AsyncCheckpointer:
    """One background writer; at most one commit in flight."""

    def __init__(self, path: str,
                 save_fn: Optional[Callable[..., None]] = None) -> None:
        self.path = path
        self._snapshot = _ckpt.host_copy
        self._save_fn = _ckpt.save_local if save_fn is None else save_fn
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._job: Optional[tuple[Any, Optional[int]]] = None
        self._busy = False
        self._error: Optional[BaseException] = None
        self._commits = 0
        self._closed = False
        reg = _registry()
        self._m_commit = reg.histogram(
            "horovod_ckpt_commit_seconds",
            help="wall time of one background checkpoint commit (stage + "
                 "fsync + atomic rename)")
        self._m_block = reg.histogram(
            "horovod_ckpt_step_block_seconds",
            help="time a training step spent blocked on a previous "
                 "checkpoint commit still in flight")
        self._thread = threading.Thread(
            target=self._run, name="ckpt-async-writer", daemon=True)
        self._thread.start()
        with _writers_lock:
            _writers[os.path.abspath(path)] = self

    # -- training-thread API -------------------------------------------------

    def submit(self, state: Any, step: Optional[int] = None) -> None:
        """Queue one commit of a host snapshot of ``state``, taken before
        this returns. Blocks only while a previous commit is in flight
        (measured); raises any error the writer hit earlier."""
        t0 = time.monotonic()
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncCheckpointer is closed")
            while (self._busy or self._job is not None) and not self._closed:
                self._cv.wait(0.1)
            self._raise_pending_locked()
            blocked = time.monotonic() - t0
            self._job = (self._snapshot(state), step)
            self._cv.notify_all()
        self._m_block.observe(blocked)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Drain: True when no commit is queued or in flight. Re-raises a
        writer error."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._busy or self._job is not None:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._cv.wait(0.1 if rem is None else min(0.1, rem))
            self._raise_pending_locked()
            return True

    def close(self, timeout: float = 120.0) -> None:
        """Finish the in-flight/queued commit, stop the thread, re-raise
        any writer error."""
        self.wait(timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
        with _writers_lock:
            if _writers.get(os.path.abspath(self.path)) is self:
                del _writers[os.path.abspath(self.path)]
        with self._cv:
            self._raise_pending_locked()

    @property
    def commits(self) -> int:
        with self._lock:
            return self._commits

    def _raise_pending_locked(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"background checkpoint commit to {self.path!r} failed"
            ) from err

    # -- writer thread -------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._job is None and not self._closed:
                    self._cv.wait(0.2)
                if self._job is None and self._closed:
                    return
                state, step = self._job  # type: ignore[misc]
                self._job = None
                self._busy = True
            t0 = time.monotonic()
            try:
                self._save_fn(self.path, state, step)
            except BaseException as e:  # noqa: BLE001 - raised on the training thread
                log("warning",
                    f"[ckpt] async commit to {self.path!r} failed: {e}")
                with self._cv:
                    self._error = e
            else:
                self._m_commit.observe(time.monotonic() - t0)
                with self._cv:
                    self._commits += 1
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()
