"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Horovod's data-parallel contract on NVIDIA GPUs, mirroring
``import horovod_tpu as hvd``::

    import horovod_tpu_torch as hvd
    hvd.init()                                    # NCCL on cuda:local_rank
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters()),
                                   model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

``HOROVOD_LATENCY_HIDING=1`` starts each bucket's exchange from the
gradient hooks during the backward pass (``optimizer.py``;
``metrics/overlap.py`` measures what it hides).
Sharded data parallelism (ZeRO) is ``DistributedOptimizer(sharded=True)``
over ``sharded_groups()`` (``HOROVOD_MESH``, ``HOROVOD_SHARD_PARAMS``;
``parallel/sharded.py``); FSDP is ``parallel/fsdp.py`` over
``training_groups(dp, fsdp)``. Tensor parallelism is
``TransformerLM(tp_group=...)`` on ``parallel/tensor.py``'s conjugate
pair, over the model group of ``sharded_groups``; mixture of experts is
``TransformerLM(moe_experts=...)`` (``models/moe.py``, ``ops/moe.py``),
its experts sharded with ``ep_group``.

Entry points run on the card unless the caller passes ``device="cpu"``.
The flash-attention kernels (``ops/flash_attention.py``) are CUDA C++
built from ``csrc/`` on first use.
"""

from .common.basics import (cross_rank, cross_size, device, init,
                            is_initialized, local_rank, local_size, rank,
                            shutdown, size)
from .compression import Compression
from .optimizer import (DistributedOptimizer, broadcast_optimizer_state,
                        broadcast_parameters, broadcast_sharded_state,
                        metric_average)
from .parallel.collectives import (ReduceOp, allgather, allreduce, alltoall,
                                   broadcast, bucketed_allreduce,
                                   grouped_allreduce, hierarchical_allgather,
                                   hierarchical_allreduce, reducescatter,
                                   sparse_allreduce)
from .parallel.mesh import (BATCH_AXIS, DCN_AXIS, FSDP_AXIS, HVD_AXIS,
                            ICI_AXIS, MODEL_AXIS, SHARD_AXIS, DpFsdp, Hierarchy,
                            ShardedLayout, hierarchical_groups,
                            parse_mesh_spec, sharded_groups, training_groups)

__all__ = [
    "BATCH_AXIS", "Compression", "DCN_AXIS", "DistributedOptimizer", "DpFsdp",
    "FSDP_AXIS", "HVD_AXIS", "Hierarchy", "ICI_AXIS", "MODEL_AXIS", "ReduceOp",
    "SHARD_AXIS", "ShardedLayout", "allgather", "allreduce", "alltoall",
    "broadcast", "broadcast_optimizer_state", "broadcast_parameters",
    "broadcast_sharded_state", "bucketed_allreduce", "cross_rank",
    "cross_size", "device", "grouped_allreduce", "hierarchical_allgather",
    "hierarchical_allreduce", "hierarchical_groups", "init", "is_initialized",
    "local_rank", "local_size", "metric_average", "parse_mesh_spec", "rank",
    "reducescatter", "sharded_groups", "shutdown", "size", "sparse_allreduce",
    "training_groups",
]
