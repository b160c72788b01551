"""``horovod_tpu_torch.ckpt_async``: the counterparts of
tests/test_ckpt_async.py's writer and SIGKILL tests (its lines 47-208),
plus what the port adds: ``submit`` snapshots the state on the calling
thread, so a tensor changed right after ``submit`` returns is committed
with the value it had at ``submit``.

Moving the commit off the step path changes nothing about crash
consistency: a SIGKILL inside the stage window leaves the old checkpoint
(the torn stage is discarded), one between the swap's renames leaves a
complete stage that the next restore adopts. The JAX package's elastic
tests (``ElasticState.commit``) have their counterpart in ``drain``, which
is what a reader of the same process calls, and in the
``HOROVOD_CKPT_ASYNC`` switch, parsed as the JAX package parses it.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu.ckpt_async import writer as ref_writer
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.ckpt_async import AsyncCheckpointer, async_enabled, drain
from horovod_tpu_torch.metrics import registry
from launch_util import REPO


def test_async_writer_commits_latest(tmp_path):
    path = str(tmp_path / "ck")
    w = AsyncCheckpointer(path)
    try:
        w.submit({"w": np.arange(4.0)})
        assert w.wait(60)
        w.submit({"w": np.arange(4.0) * 3})
    finally:
        w.close()
    assert w.commits == 2
    out = checkpoint.restore(path, template={"w": np.zeros(4)})
    np.testing.assert_array_equal(out["w"], np.arange(4.0) * 3)
    # commit discipline left no stage/trash debris
    assert sorted(os.listdir(tmp_path)) == ["ck"]


def test_async_writer_error_reraised_on_step_thread(tmp_path):
    def boom(path, state, step=None):
        raise RuntimeError("disk on fire")

    w = AsyncCheckpointer(str(tmp_path / "ck"), save_fn=boom)
    w.submit({"w": np.ones(2)})
    with pytest.raises(RuntimeError, match="background checkpoint commit"):
        # surfaces on the NEXT training-thread interaction
        for _ in range(200):
            time.sleep(0.01)
            w.submit({"w": np.ones(2)})
    # the raise consumed the error; a fresh failed commit re-arms it and
    # close() refuses to swallow it
    w.submit({"w": np.ones(2)})
    with pytest.raises(RuntimeError, match="background checkpoint commit"):
        w.close()


def test_mutation_after_submit_is_not_committed(tmp_path):
    """The snapshot is taken before ``submit`` returns: the commit holds the
    values at ``submit`` even when the writer runs after the tensors moved
    on (its save waits here until the caller has changed them)."""
    path = str(tmp_path / "ck")
    moved = threading.Event()

    def save_after_the_change(p, state, step=None):
        assert moved.wait(30)
        checkpoint.save_local(p, state, step)

    w = AsyncCheckpointer(path, save_fn=save_after_the_change)
    params = torch.arange(6.0)
    view = torch.zeros(10)[2:8]
    view.copy_(params)
    try:
        w.submit({"params": params, "view": view, "epoch": 1}, step=1)
        params.add_(100.0)
        view.mul_(-1.0)
        moved.set()
        assert w.wait(60)
    finally:
        w.close()
    saved = torch.load(os.path.join(path, "step_1", checkpoint.STATE_FILE),
                       weights_only=True)
    assert torch.equal(saved["params"], torch.arange(6.0))
    assert torch.equal(saved["view"], torch.arange(6.0))
    assert saved["view"].untyped_storage().nbytes() == 6 * 4
    assert saved["epoch"] == 1


def test_histograms_time_the_commit_and_the_block(tmp_path):
    reg = registry()
    commit = reg.histogram("horovod_ckpt_commit_seconds")
    block = reg.histogram("horovod_ckpt_step_block_seconds")
    before = (commit.count, block.count)
    release = threading.Event()

    def slow(p, state, step=None):
        assert release.wait(30)
        checkpoint.save_local(p, state, step)

    w = AsyncCheckpointer(str(tmp_path / "ck"), save_fn=slow)
    try:
        w.submit({"w": torch.ones(2)})
        threading.Timer(0.3, release.set).start()
        t0 = time.monotonic()
        w.submit({"w": torch.ones(2) * 2})       # blocks on the first commit
        blocked = time.monotonic() - t0
    finally:
        w.close()
    assert (commit.count, block.count) == (before[0] + 2, before[1] + 2)
    assert blocked >= 0.25 and block.sum >= 0.25


def test_drain_flushes_a_live_writer_for_a_reader_in_this_process(tmp_path):
    path = str(tmp_path / "ck")
    release = threading.Event()

    def slow(p, state, step=None):
        assert release.wait(30)
        checkpoint.save_local(p, state, step)

    w = AsyncCheckpointer(path, save_fn=slow)
    try:
        w.submit({"step": 7, "w": torch.arange(3.0)}, step=7)
        assert not drain(path, timeout=0.2)      # still in flight
        release.set()
        assert drain(path, timeout=60)
        assert checkpoint.latest_step(path) == 7
    finally:
        w.close()
    assert drain(path)                           # no writer left: True at once


@pytest.mark.parametrize("value", [None, "1", "0", "false", "False", "no", ""])
def test_async_switch_parses_as_the_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HOROVOD_CKPT_ASYNC", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_CKPT_ASYNC", value)
    assert async_enabled() == ref_writer.async_enabled()


def test_writers_under_thread_switch_stress(tmp_path):
    """More submitting threads than cores, each with its own writer, the
    interpreter switching threads every microsecond: every submit becomes
    one commit and each directory ends with its last submit's value."""
    threads_n, submits = 2 * (os.cpu_count() or 1) + 1, 12
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(i):
        try:
            w = AsyncCheckpointer(str(tmp_path / f"ck{i}"))
            try:
                for k in range(submits):
                    w.submit({"w": torch.full((64,), float(i * 100 + k))})
            finally:
                w.close()
            assert w.commits == submits
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        workers = [threading.Thread(target=work, args=(i,)) for i in range(threads_n)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    for i in range(threads_n):
        got = checkpoint.restore(str(tmp_path / f"ck{i}"), template={"w": torch.zeros(64)})
        assert torch.equal(got["w"], torch.full((64,), float(i * 100 + submits - 1)))


# -- SIGKILL crash windows ----------------------------------------------------

KILL_SCRIPT = """
import os, sys
sys.path.insert(0, os.environ["HVD_REPO"])
import numpy as np
from horovod_tpu_torch.ckpt_async import AsyncCheckpointer

w = AsyncCheckpointer(os.environ["CK_PATH"])
w.submit({"w": np.arange(4.0) * 5, "step": np.int64(2)})
w.wait(120)
print("COMMITTED", flush=True)
"""


def _spawn_killed_commit(path, stall_point, marker_fn, timeout=60.0):
    """Run the async-writer script with the commit stalled at
    ``stall_point``, SIGKILL it the moment ``marker_fn()`` sees the stall
    window's filesystem state, and assert the kill landed mid-commit."""
    env = dict(os.environ, HVD_REPO=REPO, CK_PATH=path,
               HOROVOD_CKPT_TEST_STALL=stall_point,
               HOROVOD_CKPT_TEST_STALL_S="45")
    proc = subprocess.Popen([sys.executable, "-c", KILL_SCRIPT], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if marker_fn():
                break
            if proc.poll() is not None:
                out, err = proc.communicate()
                raise AssertionError(
                    f"writer exited before the {stall_point} window:\n"
                    f"{err.decode()[-2000:]}")
            time.sleep(0.02)
        else:
            raise AssertionError(f"{stall_point} window never appeared")
        os.kill(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == -signal.SIGKILL


def _siblings(path, infix):
    parent, base = os.path.split(path)
    try:
        return [n for n in os.listdir(parent) if n.startswith(base + infix)]
    except OSError:
        return []


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_sigkill_mid_stage_discards_and_keeps_old(tmp_path):
    """Kill while the stage exists but carries no .ok: heal discards the
    torn stage; the previous commit restores bitwise intact."""
    path = str(tmp_path / "ck")
    checkpoint.save_local(path, {"w": np.arange(4.0), "step": np.int64(1)})
    before = _tree_bytes(path)

    def in_stage_window():
        stages = [n for n in _siblings(path, ".tmp.") if not n.endswith(".ok")]
        return bool(stages) and not any(
            n.endswith(".ok") for n in _siblings(path, ".tmp."))

    _spawn_killed_commit(path, "stage", in_stage_window)
    checkpoint._heal_interrupted(path)
    assert _siblings(path, ".tmp.") == [] and _siblings(path, ".trash.") == []
    assert _tree_bytes(path) == before       # old checkpoint bitwise intact
    out = checkpoint.restore(path, template={"w": np.zeros(4),
                                             "step": np.array(0, np.int64)})
    np.testing.assert_array_equal(out["w"], np.arange(4.0))


def test_sigkill_mid_rename_adopts_complete_stage(tmp_path):
    """Kill between the swap's two renames (old moved aside, new not yet
    in): the complete .ok stage is adopted and the NEW commit restores."""
    path = str(tmp_path / "ck")
    checkpoint.save_local(path, {"w": np.arange(4.0), "step": np.int64(1)})

    def in_rename_window():
        return bool(_siblings(path, ".trash.")) and not os.path.exists(path)

    _spawn_killed_commit(path, "rename", in_rename_window)
    assert not os.path.exists(path)          # died inside the window
    out = checkpoint.restore(path, template={"w": np.zeros(4),
                                             "step": np.array(0, np.int64)})
    np.testing.assert_array_equal(out["w"], np.arange(4.0) * 5)
    assert int(out["step"]) == 2
    checkpoint._heal_interrupted(path)
    assert _siblings(path, ".tmp.") == [] and _siblings(path, ".trash.") == []
