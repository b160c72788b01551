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

``init(comm=[...])`` forms a sub-world of the launched ranks.
``checkpoint`` saves on rank 0 with a crash-consistent commit and
restores on every rank with a cross-rank digest, in place into the live
tensors (``save``/``restore``, ``save_sharded``/``restore_sharded``,
``export_for_inference``/``load_for_inference``, ``latest_step``,
``broadcast_resume_state``); ``ckpt_async.AsyncCheckpointer`` commits off
the step path; ``callbacks`` holds the Keras-style warmup, metric
averaging and broadcast callbacks; ``broadcast_object`` and
``allgather_object`` move picklable objects.

``python -m horovod_tpu_torch.runner`` launches a job (``runner``: ``run``,
``run_command``, ``run_elastic``, remote hosts through ``hvd-agent``);
``elastic`` keeps a job of the flat exchange alive across the loss of a
worker (``ElasticState``, ``elastic.run``), re-forming the world.

``autotune.tune`` measures the exchange's knobs by rebuilding the step
per candidate (``train.TuneStepFactory``); ``control.TrainingController``
retunes them while a job runs, through ``train.TrainRecapture``'s
``rejit``; ``utils/roofline.py`` and ``utils/timeline.py`` say where the
step's device time goes.

``allreduce``/``allgather``/``broadcast``/``alltoall``/``reducescatter``
of a numpy array or a Python scalar run on the eager engine
(``common/engine.py``, attached on first use by ``common.basics.engine``):
collectives negotiated by name across the world, async handles
(``enqueue``/``poll``/``synchronize``), the response cache, a TCP ring or
two-level data plane with fp16, bf16 and top-k wires, and the per-host
relay of its coordinator (``ctrl/relay.py``). ``mpi_ops`` serves CPU
torch tensors through it; tensors on the card keep NCCL.

Entry points run on the card unless the caller passes ``device="cpu"``.
The flash-attention kernels (``ops/flash_attention.py``) are CUDA C++
built from ``csrc/`` on first use.
"""

from . import callbacks, checkpoint, elastic, metrics, mpi_ops, runner
from .common.basics import (HorovodInternalError, cross_rank, cross_size,
                            device, init, is_initialized, local_rank,
                            local_size, rank, shutdown, size)
from .compression import Compression
from .optimizer import (DistributedOptimizer, broadcast_optimizer_state,
                        broadcast_parameters, broadcast_sharded_state,
                        metric_average)
from .parallel.collectives import (ReduceOp, allgather, allgather_object,
                                   allreduce, alltoall, broadcast,
                                   broadcast_object, bucketed_allreduce,
                                   grouped_allreduce, hierarchical_allgather,
                                   hierarchical_allreduce, reducescatter,
                                   sparse_allreduce)
from .parallel.mesh import (BATCH_AXIS, DCN_AXIS, FSDP_AXIS, HVD_AXIS,
                            ICI_AXIS, MODEL_AXIS, SHARD_AXIS, DpFsdp, Hierarchy,
                            ShardedLayout, hierarchical_groups,
                            parse_mesh_spec, sharded_groups, training_groups)

__all__ = [
    "BATCH_AXIS", "Compression", "DCN_AXIS", "DistributedOptimizer", "DpFsdp",
    "FSDP_AXIS", "HVD_AXIS", "Hierarchy", "HorovodInternalError", "ICI_AXIS",
    "MODEL_AXIS", "ReduceOp", "SHARD_AXIS", "ShardedLayout", "allgather",
    "allgather_object", "allreduce", "alltoall", "broadcast",
    "broadcast_object", "broadcast_optimizer_state", "broadcast_parameters",
    "broadcast_sharded_state", "bucketed_allreduce", "callbacks",
    "checkpoint", "cross_rank", "elastic", "mpi_ops", "runner",
    "cross_size", "device", "grouped_allreduce", "hierarchical_allgather",
    "hierarchical_allreduce", "hierarchical_groups", "init", "is_initialized",
    "local_rank", "local_size", "metric_average", "metrics", "parse_mesh_spec",
    "rank",
    "reducescatter", "sharded_groups", "shutdown", "size", "sparse_allreduce",
    "training_groups",
]
