"""Pipeline parallelism (GPipe microbatch pipelining) over a process group,
the counterpart of ``horovod_tpu.parallel.pipeline``.

Each rank of the ``pp`` group holds a contiguous run of layers, its stage.
The schedule runs ``n_micro + n_stages - 1`` ticks: at tick ``t`` stage 0
ingests microbatch ``min(t, n_micro - 1)``, every stage runs its layers on
what it holds, the last stage finishes microbatch ``t - (n_stages - 1)``,
and the activations move one stage on with one ``PPermute`` over the ring
``(i, (i + 1) % n)`` (none after the last tick, whose hand-off no stage
would read). The bubble ticks compute, as the reference's do.

The JAX package gets the backward pipeline by differentiating a scan of
``ppermute`` ticks, and its SPMD program runs every transpose on every
device. Here each rank's ``backward()`` walks only the graph its own loss
reaches, so the stage-0 select, the write into the output buffer and the
loss mask are ``torch.where`` on a tensor condition, never a Python
branch on the stage: every rank's graph then reaches every tick's
``PPermute`` (through the ticks after it), and every rank issues the same
backward P2P calls in the same order, last tick first. A step moves
``2 (n_ticks - 1)`` activations of one microbatch per rank, forward and
backward.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .collectives import PPermute, ReduceOp, allreduce_

PP_AXIS = "pp"


def stack_stage_params(layer_params_list: Sequence[dict]) -> dict:
    """Stack per-layer state dicts (one name -> tensor dict per layer) into
    one dict with a leading layer dim, as the reference stacks its trees."""
    names = list(layer_params_list[0])
    return {n: torch.stack([p[n] for p in layer_params_list]) for n in names}


def unstack_stage_params(stacked: dict) -> list:
    """The inverse of :func:`stack_stage_params`: one dict per layer (views
    of the stacked tensors, so gradients reach them)."""
    layers = next(iter(stacked.values())).shape[0]
    return [{n: t[i] for n, t in stacked.items()} for i in range(layers)]


def stage_of(group: Optional[dist.ProcessGroup]) -> tuple[int, int]:
    """(this rank's stage, the number of stages) in ``group`` (None: the
    world)."""
    return dist.get_rank(group), dist.get_world_size(group)


def pipeline_ticks(n_micro: int, n_stages: int) -> list:
    """The schedule, one ``(ingest, collect)`` pair per tick: stage 0 takes
    microbatch ``ingest``; the last stage finishes microbatch ``collect``
    (None in the ticks that fill the pipeline)."""
    return [(min(t, n_micro - 1), t - (n_stages - 1) if t >= n_stages - 1 else None)
            for t in range(n_micro + n_stages - 1)]


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    # A fill on the device, not a copy from the host: the step that makes
    # it may be captured in a CUDA graph.
    return torch.full((), value, dtype=torch.bool, device=like.device)


def pipeline_apply(layer_fn: Callable, stage_layers, microbatches: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Run ``microbatches`` ``(n_micro, mb, ...)`` through the pipeline.

    ``layer_fn(layer, x)`` is one layer's shape-preserving forward;
    ``stage_layers`` this stage's layers in order: a sequence (per-layer
    state dicts, an ``nn.ModuleList``) or a dict of stacked tensors
    (:func:`stack_stage_params`). Every stage receives the same
    microbatches; only stage 0 reads them. Returns ``(n_micro, mb, ...)``
    outputs, valid on the last stage (zeros elsewhere)."""
    stage, n_stages = stage_of(group)
    layers = unstack_stage_params(stage_layers) if isinstance(stage_layers, dict) \
        else list(stage_layers)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    is_first = _flag(stage == 0, microbatches)
    is_last = _flag(stage == n_stages - 1, microbatches)
    in_flight = torch.zeros_like(microbatches[0])
    outs = [torch.zeros_like(microbatches[0]) for _ in range(microbatches.shape[0])]
    ticks = pipeline_ticks(microbatches.shape[0], n_stages)
    for t, (ingest, collect) in enumerate(ticks):
        h = torch.where(is_first, microbatches[ingest], in_flight)
        for layer in layers:
            h = layer_fn(layer, h)
        if collect is not None:
            outs[collect] = torch.where(is_last, h, outs[collect])
        if t < len(ticks) - 1:
            # The last stage's activation goes round to stage 0, which
            # drops it.
            in_flight = PPermute.apply(h, perm, group)
    return torch.stack(outs)


def last_stage_value(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                     ) -> torch.Tensor:
    """The last stage's ``x`` on every stage (zero elsewhere, then summed
    over the group). For reporting: it has no gradient path; differentiate
    :func:`masked_last_stage_loss`."""
    stage, n_stages = stage_of(group)
    with torch.no_grad():
        x = x.detach() if stage == n_stages - 1 else torch.zeros_like(x)
        return allreduce_(x.clone(), ReduceOp.SUM, group)


def masked_last_stage_loss(loss: torch.Tensor,
                           group: Optional[dist.ProcessGroup] = None
                           ) -> torch.Tensor:
    """The differentiable form of a pipeline loss: ``loss`` on the last
    stage, zero elsewhere, by ``torch.where`` on a tensor condition, so the
    graph stays whole on every stage (a 0/1 product would turn an inf into
    a NaN). Summed over the stages it is the loss once."""
    stage, n_stages = stage_of(group)
    return torch.where(_flag(stage == n_stages - 1, loss), loss,
                       torch.zeros_like(loss))
