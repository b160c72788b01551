"""Checkpoint commits off the step path, and checkpoint streaming:

- :mod:`.writer` — :class:`AsyncCheckpointer`, a background writer that
  runs the crash-consistent commit of ``checkpoint.save_local`` (stage →
  fsync → ``.ok`` → atomic rename) while training continues, and
  ``drain``, which flushes a live writer of this process before a reader
  looks at its directory.
- :mod:`.stream` — host leaders (ctrl/agent.py) serve the latest committed
  files to elastic joiners and fresh serving replicas, chunked,
  hash-verified, and landed with the SAME commit discipline, so a fetched
  checkpoint is bitwise identical to a filesystem restore and a kill
  mid-fetch can never publish a torn copy.

Knobs: ``HOROVOD_CKPT_ASYNC`` (default on) is the switch callers read
through :func:`async_enabled`; ``HOROVOD_CKPT_STREAM_CHUNK_MB`` sizes fetch
chunks; ``HOROVOD_CKPT_STREAM_FROM`` points a cold-starting process at
peer host leaders; ``HOROVOD_CKPT_STREAM_DIR`` is the directory a
launcher's leaders export.
"""

from .writer import AsyncCheckpointer, async_enabled, drain
from .stream import fetch_from_peer, serve_chunk, serve_manifest

__all__ = ["AsyncCheckpointer", "async_enabled", "drain", "fetch_from_peer",
           "serve_chunk", "serve_manifest"]
