"""Switch mixture-of-experts with expert parallelism over a process group,
the counterpart of ``horovod_tpu.ops.moe``.

Top-1 routing, capacity-bounded, dropping on overflow:

1. each rank routes its local tokens: softmax gate, argmax expert, and
   the token's slot in that expert's capacity C by a cumulative count;
   a token past the capacity is dropped (it contributes zero);
2. the dispatch buffer ``(E, C, D)`` is filled from the kept tokens,
   viewed as ``(ep, E_local, C, D)`` and exchanged with one all-to-all:
   each rank then holds, for each of its ``E_local`` experts, up to C
   tokens from every rank;
3. the local experts run as one batched product over the stacked weights;
4. the inverse all-to-all brings the outputs home, and each token gathers
   its row back, scaled by its gate probability.

The all-to-alls are ``collectives.AllToAll``, differentiable (the backward
of each is the inverse exchange); ``group=None`` is a group of one and
makes no call. JAX's ``.at[expert, pos].add`` drops a token whose slot is
past the capacity and ``y[expert, pos]`` clamps it; torch indexing out of
range raises instead, so both clamp the slot to ``C - 1``: the dropped
token's row is already zero when it is added, and its gathered row is
multiplied by ``keep = 0``, so the result is JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import AllToAll, Group
from ..parallel.tensor import model_size as group_size


class MoEParams(NamedTuple):
    gate: torch.Tensor    # (D, E), replicated
    w_in: torch.Tensor    # (E_local, D, H), this rank's experts
    w_out: torch.Tensor   # (E_local, H, D)


def top1_route(logits: torch.Tensor, capacity: int):
    """``(expert, prob, pos, keep)`` of each token: the argmax expert (the
    first maximal index, as ``jnp.argmax``), its gate probability, the
    token's slot in the expert's buffer (how many earlier tokens chose the
    same expert), and whether the slot is within ``capacity``."""
    n_experts = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)
    prob = torch.gather(probs, -1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, n_experts).int()
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    keep = pos < capacity
    return expert, prob, pos, keep


def dispatch(tokens: torch.Tensor, expert, pos, keep, n_experts: int,
             capacity: int) -> torch.Tensor:
    """The ``(E, C, D)`` buffer of the kept tokens at their slots (the
    dropped ones add 0.0 at slot ``C - 1``)."""
    kept = torch.where(keep[:, None], tokens, torch.zeros_like(tokens))
    buf = tokens.new_zeros((n_experts, capacity, tokens.shape[-1]))
    return buf.index_put((expert, pos.clamp(max=capacity - 1)), kept,
                         accumulate=True)


def combine(y: torch.Tensor, expert, prob, pos, keep,
            dtype: torch.dtype) -> torch.Tensor:
    """Each token's row of the ``(E, C, D)`` expert outputs, scaled by
    ``prob * keep`` cast to ``dtype``."""
    rows = y[expert, pos.clamp(max=y.shape[1] - 1)]
    return rows * (prob * keep).to(dtype)[:, None]


def moe_apply(params: MoEParams, x: torch.Tensor, capacity: int,
              group: Group = None) -> torch.Tensor:
    """Switch-MoE forward of this rank's tokens ``x (T, D)`` with this
    rank's ``E / ep`` experts, ``ep`` the size of ``group``."""
    ep = group_size(group)
    e_local, d, _ = params.w_in.shape
    n_experts = ep * e_local

    logits = x @ params.gate
    expert, prob, pos, keep = top1_route(logits, capacity)
    disp = dispatch(x, expert, pos, keep, n_experts, capacity)
    disp = disp.reshape(ep, e_local, capacity, d)
    recv = disp if ep == 1 else AllToAll.apply(disp, group, 0, 0)

    h = torch.relu(torch.einsum("recd,edh->rech", recv, params.w_in))
    y = torch.einsum("rech,ehd->recd", h, params.w_out)

    back = y if ep == 1 else AllToAll.apply(y.contiguous(), group, 0, 0)
    return combine(back.reshape(n_experts, capacity, d), expert, prob, pos,
                   keep, x.dtype)


def load_balancing_loss(logits: torch.Tensor, expert: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """Switch Transformer's auxiliary loss: ``n_e * sum_e (fraction routed
    to e) * (mean gate probability of e)``; 1 at uniform routing."""
    probs = torch.softmax(logits.float(), dim=-1)
    frac = F.one_hot(expert, n_experts).float().mean(dim=0)
    return n_experts * (frac * probs.mean(dim=0)).sum()
