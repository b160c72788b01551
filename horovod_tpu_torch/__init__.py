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
from .parallel.collectives import (ReduceOp, allgather, allreduce, alltoall,
                                   broadcast, bucketed_allreduce,
                                   grouped_allreduce, hierarchical_allgather,
                                   hierarchical_allreduce, reducescatter,
                                   sparse_allreduce)
from .parallel.mesh import (DCN_AXIS, HVD_AXIS, ICI_AXIS, Hierarchy,
                            hierarchical_groups)

__all__ = [
    "Compression", "DCN_AXIS", "DistributedOptimizer", "HVD_AXIS", "Hierarchy",
    "ICI_AXIS", "ReduceOp", "allgather", "allreduce", "alltoall", "broadcast",
    "broadcast_optimizer_state", "broadcast_parameters", "bucketed_allreduce",
    "cross_rank", "cross_size", "device", "grouped_allreduce",
    "hierarchical_allgather", "hierarchical_allreduce", "hierarchical_groups",
    "init", "is_initialized", "local_rank", "local_size", "metric_average",
    "rank", "reducescatter", "shutdown", "size", "sparse_allreduce",
]
