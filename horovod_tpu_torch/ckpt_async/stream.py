"""Checkpoint streaming: cold-start from a surviving peer. The port's own
copy of ``horovod_tpu.ckpt_async.stream``, speaking the same protocol, so
either package's fetch reads the other's control leader.

An elastic joiner (or a fresh serving replica) on a host with no shared
filesystem view of the latest commit fetches it from a surviving host's
control leader instead of waiting for an operator to copy files:

- The SERVING side is two stateless handlers the ControlAgent dispatches
  under the job secret: :func:`serve_manifest` lists the committed
  checkpoint's files with sizes and SHA-256 digests, and
  :func:`serve_chunk` returns one bounded byte range. Both resolve paths
  strictly INSIDE the exported checkpoint directory (a relative-path
  escape is answered with an error, not a file).
- The FETCHING side (:func:`fetch_from_peer`) downloads every manifest
  file chunk-by-chunk (``HOROVOD_CKPT_STREAM_CHUNK_MB``) into a staged
  sibling directory, verifies each file's digest, then publishes with the
  SAME ``.ok`` + atomic-rename discipline as a local commit
  (checkpoint._swap_into_place) — so a fetched checkpoint is
  indistinguishable from, and bitwise identical to, one restored from the
  filesystem, and a kill mid-fetch leaves nothing adoptable by mistake
  (no ``.ok`` until every digest checked out).

Only COMMITTED state is ever served: the manifest walk skips ``.tmp.*``
and ``.trash.*`` siblings, so an in-flight async commit can never leak a
torn view to a joiner.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from ..utils.logging import log


def stream_chunk_bytes() -> int:
    """Fetch chunk size (``HOROVOD_CKPT_STREAM_CHUNK_MB``, default 4 MiB,
    floor 64 KiB)."""
    try:
        mb = float(os.environ.get("HOROVOD_CKPT_STREAM_CHUNK_MB", "4"))
    except ValueError:
        mb = 4.0
    return max(64 * 1024, int(mb * 1024 * 1024))


def _resolve_inside(root: str, rel: str) -> Optional[str]:
    """``root/rel`` if (and only if) it stays inside ``root``."""
    root = os.path.abspath(root)
    p = os.path.abspath(os.path.join(root, rel))
    if p == root or p.startswith(root + os.sep):
        return p
    return None


def _committed_files(root: str) -> list[str]:
    """Relative paths of every file in the COMMITTED tree — staged
    (``.tmp.*``), displaced (``.trash.*``) and marker (``.ok``) siblings
    never appear in a manifest."""
    out: list[str] = []
    root = os.path.abspath(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if ".tmp." not in d and ".trash." not in d)
        for name in sorted(filenames):
            if ".tmp." in name or ".trash." in name or name.endswith(".ok"):
                continue
            out.append(os.path.relpath(os.path.join(dirpath, name), root))
    return out


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1024 * 1024), b""):
            h.update(block)
    return h.hexdigest()


# -- serving side (runs inside the ControlAgent, under the job secret) -------


def serve_manifest(ckpt_dir: str) -> dict:
    """Answer ``ckpt_manifest``: the committed checkpoint's file list."""
    if not ckpt_dir:
        return {"ok": False, "error": "no checkpoint directory exported "
                                      "(HOROVOD_CKPT_STREAM_DIR unset)"}
    root = os.path.abspath(ckpt_dir)
    if not os.path.isdir(root):
        return {"ok": False, "error": f"no committed checkpoint at {root}"}
    files = []
    for rel in _committed_files(root):
        p = os.path.join(root, rel)
        try:
            files.append({"path": rel, "size": os.path.getsize(p),
                          "sha256": _sha256_file(p)})
        except OSError as e:
            return {"ok": False, "error": f"manifest read failed: {e}"}
    return {"ok": True, "root": root, "files": files,
            "total_bytes": sum(f["size"] for f in files)}


def serve_chunk(ckpt_dir: str, req: dict) -> dict:
    """Answer ``ckpt_fetch``: one byte range of one manifest file."""
    if not ckpt_dir:
        return {"ok": False, "error": "no checkpoint directory exported"}
    rel = str(req.get("path", ""))
    p = _resolve_inside(ckpt_dir, rel)
    if p is None or ".tmp." in rel or ".trash." in rel:
        return {"ok": False, "error": f"path {rel!r} escapes the exported "
                                      "checkpoint directory"}
    offset = max(0, int(req.get("offset", 0)))
    length = min(int(req.get("length", stream_chunk_bytes())),
                 stream_chunk_bytes())
    try:
        with open(p, "rb") as f:
            f.seek(offset)
            data = f.read(length)
            size = os.fstat(f.fileno()).st_size
    except OSError as e:
        return {"ok": False, "error": f"chunk read failed: {e}"}
    return {"ok": True, "data": data, "offset": offset,
            "eof": offset + len(data) >= size}


# -- fetching side -----------------------------------------------------------


def fetch_from_peer(addresses, key: bytes, dest_dir: str,
                    timeout: float = 600.0) -> dict:
    """Stream the latest committed checkpoint from a peer host leader into
    ``dest_dir``, commit-discipline included. Returns the peer manifest.

    ``addresses`` is a ``[(host, port), ...]`` list of ControlAgents (the
    ``HOROVOD_CKPT_STREAM_FROM`` format, ``host:port[,host:port...]``);
    ``key`` is the job secret the ranks already hold (HOROVOD_SECRET)."""
    import shutil
    import time

    from ..checkpoint import _fsync_tree, _swap_into_place
    from ..runner.network import BasicClient

    deadline = time.monotonic() + timeout
    client = BasicClient(list(addresses), key, timeout=60.0,
                         connect_retry_s=min(30.0, timeout))
    try:
        man = client.request({"kind": "ckpt_manifest"})
        if not man.get("ok"):
            raise RuntimeError(f"peer has no streamable checkpoint: "
                               f"{man.get('error', man)}")
        dest = os.path.abspath(dest_dir)
        os.makedirs(os.path.dirname(dest) or os.curdir, exist_ok=True)
        tmp = f"{dest}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        chunk = stream_chunk_bytes()
        fetched = 0
        for entry in man["files"]:
            rel, want_sha = entry["path"], entry["sha256"]
            local = _resolve_inside(tmp, rel)
            if local is None:
                raise RuntimeError(
                    f"peer manifest path {rel!r} escapes the destination")
            os.makedirs(os.path.dirname(local) or os.curdir, exist_ok=True)
            h = hashlib.sha256()
            with open(local, "wb") as f:
                offset = 0
                while True:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"checkpoint streaming exceeded {timeout:.0f}s")
                    resp = client.request({"kind": "ckpt_fetch", "path": rel,
                                           "offset": offset,
                                           "length": chunk})
                    if not resp.get("ok"):
                        raise RuntimeError(f"chunk fetch of {rel!r} failed: "
                                           f"{resp.get('error', resp)}")
                    data = resp["data"]
                    f.write(data)
                    h.update(data)
                    offset += len(data)
                    fetched += len(data)
                    if resp.get("eof") or not data:
                        break
            if h.hexdigest() != want_sha:
                raise RuntimeError(
                    f"digest mismatch streaming {rel!r}: peer advertised "
                    f"{want_sha[:12]}…, received {h.hexdigest()[:12]}… — "
                    "refusing to publish a corrupt checkpoint")
        # Digest-verified: publish with the local commit discipline, so a
        # kill before this instant leaves no adoptable (.ok) stage and a
        # kill after it leaves a complete checkpoint.
        _fsync_tree(tmp)
        _swap_into_place(tmp, dest)
        log("info", f"[ckpt] streamed {len(man['files'])} file(s), "
                    f"{fetched} bytes from peer into {dest}")
        return man
    finally:
        try:
            client.close()
        except Exception:
            pass


def stream_sources_from_env() -> list[tuple[str, int]]:
    """Parse ``HOROVOD_CKPT_STREAM_FROM`` (``host:port[,host:port...]``)."""
    raw = os.environ.get("HOROVOD_CKPT_STREAM_FROM", "")
    out: list[tuple[str, int]] = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        host, port = part.rsplit(":", 1)
        out.append((host, int(port)))
    return out
