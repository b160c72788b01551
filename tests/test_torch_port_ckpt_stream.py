"""The port's checkpoint streaming (``horovod_tpu_torch.ckpt_async.stream``)
against the JAX package's (``horovod_tpu.ckpt_async.stream``): the
manifest of the same directory (files, sizes, SHA-256), the same chunks
and refusals, the chunk-size knob and the source list over the same env;
a streamed checkpoint byte-identical to the committed one and restored to
the same tensors, with the commit discipline (no stage or marker left);
a corrupt peer never published; and the cross-package fetches both ways —
the JAX package's ``fetch_from_peer`` from the port's ``ControlAgent`` and
the port's from the JAX package's — each landing byte-identical files,
over several chunks. Tolerance: none — bytes and digests are compared
exactly."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as ref_checkpoint
from horovod_tpu.ckpt_async import stream as ref_stream
from horovod_tpu.ctrl.agent import ControlAgent as RefControlAgent
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.ckpt_async import (
    fetch_from_peer,
    serve_chunk,
    serve_manifest,
    stream,
)
from horovod_tpu_torch.ctrl.agent import ControlAgent

KEY = b"stream-secret"
LOOP = "127.0.0.1"


def _tree_hash(root):
    """Order-stable digest over every file's relative path + bytes."""
    h = hashlib.sha256()
    for dirpath, dirnames, files in os.walk(root):
        dirnames.sort()
        for name in sorted(files):
            p = os.path.join(dirpath, name)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _port_ckpt(path, n=8):
    checkpoint.save_local(path, {"w": torch.arange(float(n)), "step": 4,
                                 "b": torch.ones(3, dtype=torch.bfloat16)})
    return path


def _jax_ckpt(path):
    ref_checkpoint.save_local(path, {"w": np.arange(8.0), "step": np.int64(4)})
    return path


@pytest.fixture
def two_dirs(tmp_path):
    """A committed checkpoint of each package: the port's one file and the
    JAX package's orbax tree of several files and directories."""
    return {"port": _port_ckpt(str(tmp_path / "port-ck")),
            "jax": _jax_ckpt(str(tmp_path / "jax-ck"))}


@pytest.mark.parametrize("which", ["port", "jax"])
def test_manifest_matches(two_dirs, which):
    got, want = serve_manifest(two_dirs[which]), ref_stream.serve_manifest(two_dirs[which])
    assert got == want and got["ok"] and got["total_bytes"] > 0
    for entry in got["files"]:
        with open(os.path.join(two_dirs[which], entry["path"]), "rb") as f:
            data = f.read()
        assert entry["size"] == len(data)
        assert entry["sha256"] == hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("req", [
    {"path": "state.pt"}, {"path": "state.pt", "offset": 10, "length": 7},
    {"path": "state.pt", "offset": 1 << 30}, {"path": "missing"},
    {"path": "../../etc/passwd"}, {"path": "x.tmp.3/y"}, {"path": ""}])
def test_chunk_matches(two_dirs, req):
    got = serve_chunk(two_dirs["port"], dict(req))
    want = ref_stream.serve_chunk(two_dirs["port"], dict(req))
    if not got["ok"]:
        got["error"] = got["error"].split(":")[0]
        want["error"] = want["error"].split(":")[0]
    assert got == want


def test_chunk_rejects_traversal(two_dirs):
    bad = serve_chunk(two_dirs["port"], {"path": "../../etc/passwd"})
    assert bad["ok"] is False and "escapes" in bad["error"]
    assert serve_manifest("")["ok"] is False
    assert serve_manifest("") == ref_stream.serve_manifest("")
    assert serve_chunk("", {"path": "a"}) == ref_stream.serve_chunk("", {"path": "a"})


@pytest.mark.parametrize("raw", [None, "4", "0.0625", "0", "bogus", "16.5"])
def test_chunk_size_knob_caps_the_chunk(raw, monkeypatch, tmp_path):
    if raw is None:
        monkeypatch.delenv("HOROVOD_CKPT_STREAM_CHUNK_MB", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_CKPT_STREAM_CHUNK_MB", raw)
    cap = stream.stream_chunk_bytes()
    assert cap == ref_stream.stream_chunk_bytes() and cap >= 64 * 1024
    path = tmp_path / "ck"
    path.mkdir()
    (path / "big").write_bytes(os.urandom(min(cap + 5, 70 * 1024)))
    resp = serve_chunk(str(path), {"path": "big", "length": cap * 4})
    assert len(resp["data"]) == min(cap, os.path.getsize(path / "big"))


def test_manifest_skips_uncommitted(tmp_path):
    src = _port_ckpt(str(tmp_path / "ck"))
    os.makedirs(os.path.join(src, "x.tmp.99"))
    with open(os.path.join(src, "x.tmp.99", "torn"), "w") as f:
        f.write("torn")
    with open(os.path.join(src, "y.trash.3"), "w") as f:
        f.write("old")
    with open(src + ".ok", "w") as f:
        f.write("marker")
    man = serve_manifest(src)
    assert man == ref_stream.serve_manifest(src)
    assert [e["path"] for e in man["files"]] == [checkpoint.STATE_FILE]


def test_stream_fetch_bitwise_matches_filesystem(tmp_path):
    """A joiner's streamed checkpoint is byte-identical to the peer's and
    restores to the same tensors as a filesystem restore."""
    src = _port_ckpt(str(tmp_path / "ck"))
    agent = ControlAgent(KEY, ckpt_dir=src)
    dest = str(tmp_path / "fetched")
    try:
        man = fetch_from_peer([(LOOP, agent.port)], KEY, dest)
    finally:
        agent.stop()
    assert man["ok"] and man == serve_manifest(src)
    assert _tree_hash(src) == _tree_hash(dest)
    got = checkpoint.load_for_inference(dest)
    want = checkpoint.load_for_inference(src)
    assert got.keys() == want.keys() and got["step"] == 4
    assert all(torch.equal(got[k], want[k]) for k in ("w", "b"))
    assert sorted(os.listdir(tmp_path)) == ["ck", "fetched"]


def test_stream_dir_from_env(tmp_path, monkeypatch):
    """A leader built without ``ckpt_dir`` exports ``HOROVOD_CKPT_STREAM_DIR``."""
    src = _port_ckpt(str(tmp_path / "ck"))
    monkeypatch.setenv("HOROVOD_CKPT_STREAM_DIR", src)
    agent = ControlAgent(KEY)
    try:
        assert agent.ckpt_dir == src
        fetch_from_peer([(LOOP, agent.port)], KEY, str(tmp_path / "got"))
    finally:
        agent.stop()
    assert _tree_hash(src) == _tree_hash(str(tmp_path / "got"))


def test_stream_corrupt_peer_never_published(tmp_path, monkeypatch):
    """A digest mismatch aborts before publish: no destination, no
    adoptable ``.ok`` stage."""
    src = _port_ckpt(str(tmp_path / "ck"))
    agent = ControlAgent(KEY, ckpt_dir=src)
    dest = str(tmp_path / "fetched")
    monkeypatch.setattr(stream, "_sha256_file", lambda p: "0" * 64)
    try:
        with pytest.raises(RuntimeError, match="refusing to publish"):
            fetch_from_peer([(LOOP, agent.port)], KEY, dest)
    finally:
        agent.stop()
    assert not os.path.exists(dest) and not os.path.exists(dest + ".ok")


def test_stream_without_a_checkpoint_raises(tmp_path):
    agent = ControlAgent(KEY, ckpt_dir=str(tmp_path / "nothing"))
    try:
        with pytest.raises(RuntimeError, match="no streamable checkpoint"):
            fetch_from_peer([(LOOP, agent.port)], KEY, str(tmp_path / "d"))
    finally:
        agent.stop()


@pytest.mark.parametrize("fetcher,server", [("port", "jax"), ("jax", "port"),
                                            ("port", "port")])
@pytest.mark.parametrize("which", ["port", "jax"])
def test_cross_package_fetch(two_dirs, tmp_path, monkeypatch, fetcher, server, which):
    """Either package's fetch from either package's leader, in 64 KiB
    chunks, over a checkpoint of either package with a multi-chunk file
    added: byte-identical files, and the same manifest returned."""
    monkeypatch.setenv("HOROVOD_CKPT_STREAM_CHUNK_MB", "0.0625")
    src = two_dirs[which]
    with open(os.path.join(src, "extra.bin"), "wb") as f:
        f.write(np.random.RandomState(0).bytes(300_001))
    agent = (ControlAgent if server == "port" else RefControlAgent)(KEY, ckpt_dir=src)
    fetch = fetch_from_peer if fetcher == "port" else ref_stream.fetch_from_peer
    dest = str(tmp_path / f"fetched-{fetcher}-{server}")
    try:
        man = fetch([(LOOP, agent.port)], KEY, dest)
    finally:
        agent.stop()
    assert man == serve_manifest(src)
    assert _tree_hash(src) == _tree_hash(dest)
    assert not os.path.exists(dest + ".ok")


@pytest.mark.parametrize("raw", ["10.0.0.1:9100, host-b:9101", "", " , h:1,",
                                 "[::1]:7"])
def test_stream_sources_env_parse(raw, monkeypatch):
    monkeypatch.setenv("HOROVOD_CKPT_STREAM_FROM", raw)
    assert stream.stream_sources_from_env() == ref_stream.stream_sources_from_env()
    if raw.startswith("10."):
        assert stream.stream_sources_from_env() == [("10.0.0.1", 9100),
                                                    ("host-b", 9101)]
