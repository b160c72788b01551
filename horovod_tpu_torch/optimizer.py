"""``DistributedOptimizer`` and the broadcasts that keep ranks in step.

The counterpart of ``horovod_tpu.jax.DistributedOptimizer``: ``step()``
fuses the gradients into the buckets of a fusion plan, casts each bucket
to its wire dtype, allreduces it (one collective per bucket), unfuses the
result back into each parameter's ``.grad`` and then runs the wrapped
optimizer. The plan is built once, from the parameters in the order the
caller gives them; to line up with the JAX package's buckets, give them in
the order its parameter tree flattens (``convert.jax_ordered`` does so for
the transformer).
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

import torch

from .common import basics
from .compression import Compression
from .parallel import collectives, fusion
from .parallel.collectives import ReduceOp


def _resolved_threshold(fusion_threshold: Optional[int]) -> int:
    """None -> HOROVOD_FUSION_THRESHOLD (default 64 MiB)."""
    if fusion_threshold is not None:
        return fusion_threshold
    return basics.config().fusion_threshold


def _resolved_num_buckets(num_buckets: Optional[int]) -> int:
    """None -> HOROVOD_NUM_BUCKETS (default 1)."""
    if num_buckets is not None:
        return max(1, int(num_buckets))
    return basics.config().num_buckets


def _resolved_compression(compression):
    """None -> HOROVOD_COMPRESSION; an explicit argument wins."""
    if compression is not None:
        return compression
    return Compression.by_name(basics.config().compression)


class DistributedOptimizer:
    """Wrap ``optimizer`` so that each ``step()`` first averages the
    gradients over all ranks.

    ``backward_passes_per_step = k > 1`` lets gradients of k backward
    passes accumulate in ``.grad``; every k-th ``step()`` divides them by k
    (the mean, as ``optax.MultiSteps`` takes it), allreduces and steps, and
    the calls between are no-ops, as is ``zero_grad()`` after them."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Iterable[tuple[str, torch.Tensor]],
                 compression=None, fusion_threshold: Optional[int] = None,
                 num_buckets: Optional[int] = None,
                 backward_passes_per_step: int = 1):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        named = list(named_parameters)
        names = [n for n, _ in named]
        if len(set(names)) != len(names):
            raise ValueError("named_parameters has duplicate names")
        owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
        if {id(p) for _, p in named} != owned:
            raise ValueError(
                "named_parameters must list exactly the optimizer's parameters")
        self.optimizer = optimizer
        self.params = [p for _, p in named]
        self.compression = _resolved_compression(compression)
        self.threshold = _resolved_threshold(fusion_threshold)
        self.num_buckets = _resolved_num_buckets(num_buckets)
        self.compression_min_bytes = basics.config().compression_min_bytes
        self.backward_passes_per_step = backward_passes_per_step
        self.plan = fusion.build_plan(self.params, self.threshold,
                                      self.num_buckets)
        self._passes = 0

    def synchronize(self) -> None:
        """Allreduce every parameter's gradient (a missing one counts as 0)."""
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.backward_passes_per_step > 1:
            for g in grads:
                g.div_(self.backward_passes_per_step)
        fusion.fused_allreduce_(grads, self.plan, ReduceOp.AVERAGE,
                                self.compression, self.compression_min_bytes)

    def step(self) -> bool:
        """Allreduce and step; returns whether this call stepped."""
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return False
        self._passes = 0
        self.synchronize()
        self.optimizer.step()
        return True

    def zero_grad(self) -> None:
        if self._passes == 0:
            self.optimizer.zero_grad()


def _named_tensors(params) -> list[tuple[str, torch.Tensor]]:
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().items())
    if isinstance(params, Mapping):
        return list(params.items())
    return list(params)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite every tensor of ``params`` (a module, a state dict, or
    ``(name, tensor)`` pairs) with root's value, in place."""
    with torch.no_grad():
        for _, t in _named_tensors(params):
            collectives.broadcast(t.data, root_rank)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Give every rank root's optimizer state and numeric hyperparameters.

    State that does not exist yet (a fresh ``Adam``, before its first step)
    is the same on every rank by construction and is left alone, so no
    optimizer step is taken to create it."""
    if isinstance(optimizer, DistributedOptimizer):
        optimizer = optimizer.optimizer
    dev = basics.device()
    with torch.no_grad():
        for group in optimizer.param_groups:
            keys = sorted(k for k, v in group.items()
                          if isinstance(v, (int, float)) and not isinstance(v, bool))
            if keys:
                vals = torch.tensor([float(group[k]) for k in keys],
                                    dtype=torch.float64, device=dev)
                collectives.broadcast(vals, root_rank)
                for k, v in zip(keys, vals.tolist()):
                    group[k] = type(group[k])(v)
            for p in group["params"]:
                for key in sorted(optimizer.state.get(p, {})):
                    t = optimizer.state[p][key]
                    if torch.is_tensor(t):
                        on_dev = t.to(dev)
                        collectives.broadcast(on_dev, root_rank)
                        t.copy_(on_dev)


def metric_average(value) -> float:
    """Average a scalar metric over all ranks."""
    t = torch.tensor([float(value)], dtype=torch.float64, device=basics.device())
    return float(collectives.allreduce_(t, ReduceOp.AVERAGE).item())
