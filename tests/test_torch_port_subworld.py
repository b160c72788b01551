"""``init(comm=...)`` sub-worlds of the port against
``horovod_tpu.common.basics.init``.

- The same ``ValueError``s in the same words: a ``comm`` that is not a
  list, ranks outside the launched world, and a caller that is not a
  member; a ``comm`` naming the whole world is plain ``init``.
- A launched gloo world of three (tests/torch_port_subworld_worker.py)
  with ``comm=[0, 2]`` and with ``comm=[1, 2]``: the members re-index to
  ranks 0 and 1 of a world of two, with local rank 0 of 1 and cross rank
  and size as rank and size, as the JAX package's topology gives them; an
  allreduce sums over the members only, ``allgather_object`` and
  ``broadcast_object`` see the members only; the non-member gets the
  reference's error and stays uninitialized; ``comm=[1, 2]`` logs the
  reference's warning about the coordinator address.
- On the card the GPU comes from the launched local rank: sub-rank 0 of
  ``comm=[1, 2]`` launched as local rank 1 pins ``cuda:1``, while
  ``local_rank()`` reports 0.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.common import basics as ref_basics
from horovod_tpu.common.topology import Topology as RefTopology
from horovod_tpu_torch.common import basics
from launch_util import REPO, free_port

WORKER = os.path.join(REPO, "tests", "torch_port_subworld_worker.py")
ENV_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE",
            "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
            "HOROVOD_COORD_ADDR", "HOROVOD_JAX_DISTRIBUTED",
            "HOROVOD_LATENCY_HIDING")


@pytest.fixture()
def launched(monkeypatch):
    """Set this process up as launched rank ``rank`` of ``size``."""
    for k in ENV_VARS:
        monkeypatch.delenv(k, raising=False)

    def place(rank, size):
        monkeypatch.setenv("HOROVOD_RANK", str(rank))
        monkeypatch.setenv("HOROVOD_SIZE", str(size))
        monkeypatch.setenv("HOROVOD_LOCAL_RANK", str(rank))
        monkeypatch.setenv("HOROVOD_LOCAL_SIZE", str(size))

    return place


@pytest.mark.parametrize("rank,size,comm", [
    (0, 1, "0"), (0, 1, 3), (0, 3, {0, 1}), (0, 1, [0, 3]), (1, 3, [0, -1]),
    (1, 3, [0, 2]), (0, 4, (1, 2, 3))],
    ids=["string", "int", "set", "outside-one", "negative", "not-member",
         "not-member-tuple"])
def test_value_errors_match_the_reference(launched, rank, size, comm):
    launched(rank, size)
    with pytest.raises(ValueError) as ref:
        ref_basics.init(comm=comm)
    with pytest.raises(ValueError) as port:
        hvd.init(device="cpu", comm=comm)
    assert str(port.value) == str(ref.value)
    assert not hvd.is_initialized() and not ref_basics.is_initialized()


@pytest.mark.parametrize("comm", [[0], [0, 0], (0,), []])
def test_comm_naming_the_whole_world_is_plain_init(launched, comm):
    launched(0, 1)
    hvd.init(device="cpu", comm=comm)
    try:
        assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size()) == (0, 1, 0, 1)
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("rank,size,comm", [(1, 3, [1, 2]), (2, 3, [2, 0]),
                                            (3, 4, [0, 1, 2, 3]), (2, 4, [3, 2, 2])])
def test_topology_is_the_reference_sub_world(launched, rank, size, comm):
    launched(rank, size)
    got = basics._subworld(basics.detect(), comm)
    ranks = sorted(set(comm))
    want = (RefTopology(ranks.index(rank), len(ranks), 0, 1, ranks.index(rank),
                        len(ranks)) if len(ranks) != size
            else ref_basics.detect())
    assert (got.rank, got.size, got.local_rank, got.local_size, got.cross_rank,
            got.cross_size) == (want.rank, want.size, want.local_rank,
                                want.local_size, want.cross_rank, want.cross_size)


def test_device_comes_from_the_launched_local_rank(launched, monkeypatch):
    launched(2, 3)
    monkeypatch.setenv("HOROVOD_COORD_ADDR", "127.0.0.1:1")
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.setdefault("set", i))
    monkeypatch.setattr(basics.dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    monkeypatch.setattr(basics.dist, "destroy_process_group", lambda: None)
    hvd.init(comm=[1, 2])
    try:
        assert calls["set"] == 2 and hvd.device() == torch.device("cuda", 2)
        assert (calls["backend"], calls["rank"], calls["world_size"]) == ("nccl", 1, 2)
        assert calls["init_method"] == "tcp://127.0.0.1:1"
        assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size()) == (1, 2, 0, 1)
    finally:
        hvd.shutdown()


def _world(comm):
    port = free_port()
    procs = []
    for rank in range(3):
        env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
        env.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE="3",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="3",
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", SUB_COMM=comm,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    out = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        assert proc.returncode == 0, stderr[-3000:]
        out.append((json.loads(stdout.strip().splitlines()[-1]), stderr))
    return out


@pytest.mark.parametrize("comm", ["0,2", "1,2"])
def test_sub_world_of_three(comm):
    members = [int(r) for r in comm.split(",")]
    out = _world(comm)
    for launched_rank, (res, stderr) in enumerate(out):
        if launched_rank not in members:
            assert res == {"member": False, "initialized": False,
                           "error": f"rank {launched_rank} is not a member of comm "
                                    f"{members}: this process cannot participate "
                                    "in the sub-world's collectives. Only member "
                                    "processes may call init(comm=...); "
                                    "non-members should skip Horovod work (or "
                                    "exit) — they must NOT fall back to init(), "
                                    "which would target the same coordinator "
                                    "address."}
            continue
        me = members.index(launched_rank)
        assert res["place"] == [me, 2, 0, 1, me, 2]
        assert res["sum"] == sum(r + 1 for r in members)
        assert res["gathered"] == members
        assert res["root"] == {"from": members[0]}
        warned = f"init(comm={members}): member rank {members[0]} will bind" in stderr
        assert warned == (members[0] != 0)
