"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Horovod's data-parallel contract on NVIDIA GPUs, mirroring
``import horovod_tpu as hvd``::

    import horovod_tpu_torch as hvd
    hvd.init()                                    # NCCL on cuda:local_rank
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters()),
                                   model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

Entry points run on the card unless the caller passes ``device="cpu"``.
The flash-attention kernels (``ops/flash_attention.py``) are CUDA C++
built from ``csrc/`` on first use.
"""

from .common.basics import (cross_rank, cross_size, device, init,
                            is_initialized, local_rank, local_size, rank,
                            shutdown, size)
from .compression import Compression
from .optimizer import (DistributedOptimizer, broadcast_optimizer_state,
                        broadcast_parameters, metric_average)
from .parallel.collectives import (ReduceOp, allgather, allreduce, broadcast,
                                   bucketed_allreduce)

__all__ = [
    "Compression", "DistributedOptimizer", "ReduceOp", "allgather",
    "allreduce", "broadcast", "broadcast_optimizer_state",
    "broadcast_parameters", "bucketed_allreduce", "cross_rank", "cross_size",
    "device", "init", "is_initialized", "local_rank", "local_size",
    "metric_average", "rank", "shutdown", "size",
]
