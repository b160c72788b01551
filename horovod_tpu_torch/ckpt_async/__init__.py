"""Checkpoint commits off the step path: :class:`AsyncCheckpointer`, a
background writer that runs the crash-consistent commit of
``checkpoint.save_local`` (stage → fsync → ``.ok`` → atomic rename) while
training continues, and ``drain``, which flushes a live writer of this
process before a reader looks at its directory.

``HOROVOD_CKPT_ASYNC`` (default on) is the switch callers read through
:func:`async_enabled`. The JAX package's checkpoint streaming
(``ckpt_async/stream.py``) rides its host runtime and is not part of the
port yet.
"""

from .writer import AsyncCheckpointer, async_enabled, drain

__all__ = ["AsyncCheckpointer", "async_enabled", "drain"]
