"""The transformer's switch-MoE MLP, the counterpart of
``horovod_tpu.models.moe``: top-1 routing with ``ops/moe.py``'s capacity
and dispatch, written densely over all of the layer's tokens.

The gate runs in float32 on float32 tokens; the experts run in the
activation dtype on float32 parameters cast as ``Dense`` casts them. The
parameters keep flax's layout and names: ``gate (D, E)``, ``w_in (E, D,
H)``, ``w_out (E, H, D)``. Each forward keeps the router's load-balancing
loss in ``lb_loss`` (flax sows it under ``intermediates/moe_lb_loss``);
the caller adds ``sum * aux_weight`` to the task loss.

``ep_group`` shards the experts (flax's ``ep_param_specs``, GSPMD's
``P('ep', None, None)`` on ``w_in``/``w_out``): rank r of the group holds
experts ``r * E/ep ... (r + 1) * E/ep - 1``, while the tokens and the gate
stay replicated over the group. Every rank routes all tokens and builds
the whole dispatch buffer, takes its experts' rows, runs them, and the
outputs are all-gathered along the expert dim. Both conjugate directions
are explicit: the buffer's slice gathers its gradient backward, and the
outputs' all-gather hands each rank its slice of their gradient. So the
sharded layer has the dense one's capacity, drops and result. A group of
one (or None) makes no call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..ops.moe import combine, dispatch, load_balancing_loss, top1_route
from ..parallel.collectives import Group, all_gather_into
from ..parallel.tensor import model_size as group_size

EXPERT_LEAVES = ("w_in", "w_out")


class _TakeExperts(torch.autograd.Function):
    """This rank's experts' rows of a replicated ``(E, ...)`` tensor;
    backward: every rank's row gradients all-gathered into the whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        per = x.shape[0] // n
        return x[r * per:(r + 1) * per].clone()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_into(grad.contiguous(), ctx.group), None


class _GatherExperts(torch.autograd.Function):
    """Every rank's ``(E_local, ...)`` rows all-gathered along dim 0;
    backward: this rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_into(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        per = grad.shape[0] // n
        return grad[r * per:(r + 1) * per].contiguous(), None


class MoEMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, n_experts: int,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16, ep_group: Group = None):
        super().__init__()
        ep = group_size(ep_group)
        if n_experts % ep:
            raise ValueError(f"{n_experts} experts not divisible by ep={ep}")
        self.dim, self.hidden, self.n_experts = dim, hidden, n_experts
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.ep_group, self.ep_size = ep_group, ep
        e_local = n_experts // ep
        self.gate = nn.Parameter(torch.empty(dim, n_experts))
        self.w_in = nn.Parameter(torch.empty(e_local, dim, hidden))
        self.w_out = nn.Parameter(torch.empty(e_local, hidden, dim))
        self.lb_loss: Optional[torch.Tensor] = None
        self.dropped = 0        # tokens past capacity in the last forward

    def capacity(self, n_tok: int) -> int:
        return max(int(self.capacity_factor * n_tok / self.n_experts), 1)

    def forward(self, x):
        b, t, d = x.shape
        tokens = x.reshape(-1, d)
        capacity = self.capacity(b * t)
        logits = tokens.float() @ self.gate
        expert, prob, pos, keep = top1_route(logits, capacity)
        self.lb_loss = load_balancing_loss(logits, expert, self.n_experts)
        self.dropped = keep.numel() - keep.sum()
        disp = dispatch(tokens.to(self.dtype), expert, pos, keep,
                        self.n_experts, capacity)
        sharded = self.ep_size > 1
        if sharded:
            disp = _TakeExperts.apply(disp, self.ep_group)
        h = torch.relu(torch.einsum("ecd,edh->ech", disp,
                                    self.w_in.to(self.dtype)))
        y = torch.einsum("ech,ehd->ecd", h, self.w_out.to(self.dtype))
        if sharded:
            y = _GatherExperts.apply(y, self.ep_group)
        out = combine(y, expert, prob, pos, keep, self.dtype)
        return out.reshape(b, t, d)


def ep_param_specs(model: nn.Module) -> dict:
    """Parameter name -> the dim expert parallelism cuts: 0 (the expert
    dim) for every 3-D ``w_in``/``w_out``, None (replicated) for the rest,
    by ``horovod_tpu.models.moe.ep_param_specs``'s rules."""
    return {name: 0 if name.rsplit(".", 1)[-1] in EXPERT_LEAVES and p.dim() == 3
            else None for name, p in model.named_parameters()}


def ep_state_dict(full: dict, ep: int, rank: int) -> dict:
    """Expert rank ``rank``'s state dict out of a full one: the experts'
    3-D ``w_in``/``w_out`` cut along dim 0, every other entry as is."""
    if not 0 <= rank < ep:
        raise ValueError(f"rank {rank} outside [0, {ep})")
    out = {}
    for name, t in full.items():
        if name.rsplit(".", 1)[-1] in EXPERT_LEAVES and t.dim() == 3:
            if t.shape[0] % ep:
                raise ValueError(f"{name}: {t.shape[0]} experts not "
                                 f"divisible by ep={ep}")
            per = t.shape[0] // ep
            t = t[rank * per:(rank + 1) * per]
        out[name] = t.clone()
    return out


def ep_merge_state_dicts(locals_: list) -> dict:
    """The inverse of :func:`ep_state_dict` over every rank's dict (in rank
    order): the expert leaves concatenated, the rest rank 0's."""
    return {name: torch.cat([sd[name] for sd in locals_])
            if name.rsplit(".", 1)[-1] in EXPERT_LEAVES and t.dim() == 3
            else t for name, t in locals_[0].items()}
