"""The port's ``mpi_ops`` (CPU torch tensors through the eager engine)
against ``horovod_tpu.torch.mpi_ops`` on the same inputs: a launched
world of two of each package runs the same script — the sync, async and
in-place allreduce (average and sum; float32, float64, int32, bfloat16),
the ragged allgather, broadcast and its in-place form, alltoall,
reducescatter, poll/synchronize, the sparse allreduce, the fp16
compression, and the autograd Functions' forward and backward — and every
result's bytes, dtype and shape are equal, over the Python engines and over
the two packages' native engines. A tensor not on the CPU is
refused with a message naming the NCCL collectives. Tolerance: none."""

from __future__ import annotations

import pytest
import torch

from launch_util import launch_world

SCRIPT = r"""
import json, os, sys
sys.path.insert(0, os.environ["HVD_REPO"])
import numpy as np, torch
pkg = os.environ["T_PKG"]
if pkg == "horovod_tpu_torch":
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import mpi_ops as m
    hvd.init(device="cpu")
    fp16 = hvd.Compression.fp16
else:
    import horovod_tpu as hvd
    from horovod_tpu.torch import mpi_ops as m
    from horovod_tpu.torch.compression import Compression
    hvd.init()
    fp16 = Compression.fp16
r = hvd.rank()
g = torch.Generator().manual_seed(10 + r)
x = torch.randn(5, 3, generator=g)
out = {}
def put(k, t):
    t = t.detach()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    out[k] = [str(t.dtype), list(t.shape), raw.contiguous().numpy().tobytes().hex()]
put("avg", m.allreduce(x, name="avg"))
put("sum64", m.allreduce(x.double(), average=False, name="sum64"))
put("int", m.allreduce(torch.arange(6, dtype=torch.int32) * (r + 1),
                       average=False, name="int"))
put("bf16", m.allreduce(x.to(torch.bfloat16), name="bf16"))
put("fp16c", m.allreduce(x, name="fp16c", compression=fp16))
y = x.clone(); m.allreduce_(y, name="inplace"); put("inplace", y)
put("gather", m.allgather(torch.full((r + 1, 2), float(r)), name="gather"))
put("bcast", m.broadcast(x, 1, name="bcast"))
z = x.clone(); m.broadcast_(z, 0, name="bcast_"); put("bcast_", z)
put("a2a", m.alltoall(torch.arange(8.0).reshape(4, 2) + 10 * r, name="a2a"))
put("rs", m.reducescatter(torch.arange(8.0) * (r + 1), name="rs"))
h = m.allreduce_async(x * 2, name="async")
put("async", m.synchronize(h))
i = torch.tensor([[0, 2, 3 - r]])
sp = torch.sparse_coo_tensor(i, torch.tensor([1.0, 2.0, 3.0]) * (r + 1), (5,))
s = m.sparse_allreduce(sp, name="sp")
put("sp_idx", s.indices()); put("sp_val", s.values())
a = x.clone().requires_grad_()
(m.HorovodAllreduce.apply(a, True, "ag.f") * torch.arange(3.0)).sum().backward()
put("allreduce_grad", a.grad)
b = torch.full((r + 1, 3), 1.0 + r, requires_grad=True)
(m.HorovodAllgather.apply(b, "ag.g") ** 2).sum().backward()
put("allgather_grad", b.grad)
c = x.clone().requires_grad_()
(m.HorovodBroadcast.apply(c, 1, "ag.b") * 3).sum().backward()
put("broadcast_grad", c.grad)
print(json.dumps(out))
hvd.shutdown()
"""


def _world(pkg, engine="python"):
    return [r["out"] for r in launch_world(2, SCRIPT, extra_env={
        "T_PKG": pkg, "HOROVOD_ENGINE": engine, "JAX_PLATFORMS": "cpu",
        "HOROVOD_STALL_CHECK_DISABLE": "1"})]


def _same(port, ref):
    for r in range(2):
        assert sorted(port[r]) == sorted(ref[r])
        for k in ref[r]:
            assert port[r][k] == ref[r][k], (r, k)


def test_mpi_ops_equal_the_jax_binding():
    _same(_world("horovod_tpu_torch"), _world("horovod_tpu"))


def test_mpi_ops_over_the_native_engine_equal_the_jax_binding():
    _same(_world("horovod_tpu_torch", "native!"),
          _world("horovod_tpu", "native!"))


def test_tensor_off_the_cpu_is_refused():
    from horovod_tpu_torch import mpi_ops

    with pytest.raises(ValueError, match="NCCL collectives"):
        mpi_ops.allreduce_async(torch.empty(2, device="meta"))
