"""Data parallelism across processes: tests/torch_port_dp_worker.py in a
4-process gloo world on the CPU and, marked ``cuda``, in one process per
visible GPU over NCCL (skipped with fewer than two GPUs). One world per
device runs both wires; each wire is its own test."""

import os
import subprocess
import sys

import pytest
import torch

from launch_util import REPO, free_port

WORKER = os.path.join(REPO, "tests", "torch_port_dp_worker.py")
WIRES = ["none", "bf16"]


def _world(size: int, device: str) -> str:
    """Run the world; return rank 0's output."""
    port = free_port()
    procs = []
    for rank in range(size):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(size),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", DP_DEVICE=device,
                   DP_WIRES=",".join(WIRES), OMP_NUM_THREADS="1")
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
            env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    failures, outs = [], []
    for rank, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failures.append(f"rank {rank} exit {proc.returncode}:\n{err[-2000:]}")
    assert not failures, "\n".join(failures)
    return outs[0]


@pytest.fixture(scope="module")
def gloo_world():
    return _world(4, "cpu")


@pytest.fixture(scope="module")
def nccl_world():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    n = torch.cuda.device_count()
    return n, _world(n, "cuda")


@pytest.mark.parametrize("wire", WIRES)
def test_gloo_world_of_four(gloo_world, wire):
    assert f"ok world 4 on cpu wire {wire}" in gloo_world


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_nccl_world_one_process_per_gpu(nccl_world, wire):
    n, out = nccl_world
    assert f"ok world {n} on cuda wire {wire}" in out
