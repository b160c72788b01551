"""CPU torch tensors through the eager engine: the port of
``horovod_tpu/torch/mpi_ops.py``.

Sync, async and in-place allreduce, allgather, broadcast, alltoall and
reducescatter, ``poll``/``synchronize`` on integer handles, the sparse
allreduce (values and indices allgathered, then coalesced), and the
autograd Functions ``HorovodAllreduce``/``Allgather``/``Broadcast``. A CPU
tensor is viewed as a numpy array without a copy and negotiated by name on
the engine (``common/engine.py``, ``basics.engine()``); a bfloat16 tensor
travels as its 16-bit patterns (``compression.BFLOAT16``).

A tensor on the card is refused: its collectives are the NCCL ones of
``horovod_tpu_torch.allreduce`` and ``parallel/collectives.py``, which the
engine never carries.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .common import basics
from .compression import BFLOAT16, compression_name

# Keep (tensor, output) alive while an async op is in flight (reference
# _handle_map, torch/mpi_ops.py:54).
_handle_map: dict[int, tuple[torch.Tensor, Optional[torch.Tensor]]] = {}


def _engine():
    return basics.engine()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.device.type != "cpu":
        raise ValueError(
            "horovod_tpu_torch.mpi_ops serves CPU tensors through the eager "
            f"engine; a tensor on {t.device} goes to the NCCL collectives "
            "(horovod_tpu_torch.allreduce/allgather/broadcast, "
            "parallel/collectives.py)")
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).numpy().view(BFLOAT16)
    return t.detach().numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype == BFLOAT16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _name(name: Optional[str], op: str, tensor: torch.Tensor) -> Optional[str]:
    # None lets the engine auto-name by handle (unique per call, consistent
    # across ranks when op order matches — reference GetOpName semantics).
    del op, tensor
    return name


# ------------------------------------------------------------------- async API

def allreduce_async(tensor: torch.Tensor, average: bool = True,
                    name: Optional[str] = None) -> int:
    arr = _to_numpy(tensor)
    h = _engine().enqueue("allreduce", arr,
                          _name(name, "allreduce", tensor), average=average)
    _handle_map[h] = (tensor, None)
    return h


def allreduce_async_(tensor: torch.Tensor, average: bool = True,
                     name: Optional[str] = None) -> int:
    """In-place: the result is written back into ``tensor`` at synchronize."""
    arr = _to_numpy(tensor)
    h = _engine().enqueue("allreduce", arr,
                          _name(name, "allreduce", tensor), average=average)
    _handle_map[h] = (tensor, tensor)
    return h


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None) -> int:
    arr = _to_numpy(tensor)
    h = _engine().enqueue("allgather", arr,
                          _name(name, "allgather", tensor))
    _handle_map[h] = (tensor, None)
    return h


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None) -> int:
    arr = _to_numpy(tensor)
    h = _engine().enqueue("broadcast", arr,
                          _name(name, "broadcast", tensor), root_rank=root_rank)
    _handle_map[h] = (tensor, None)
    return h


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> int:
    arr = _to_numpy(tensor)
    h = _engine().enqueue("broadcast", arr,
                          _name(name, "broadcast", tensor), root_rank=root_rank)
    _handle_map[h] = (tensor, tensor)
    return h


def alltoall_async(tensor: torch.Tensor, name: Optional[str] = None) -> int:
    """Beyond the reference's op set (its operations.h:108-126 exposes only
    allreduce/allgather/broadcast): dim-0 split to all ranks, matching the
    framework's public numpy API."""
    arr = _to_numpy(tensor)
    h = _engine().enqueue("alltoall", arr,
                          _name(name, "alltoall", tensor))
    _handle_map[h] = (tensor, None)
    return h


def reducescatter_async(tensor: torch.Tensor, average: bool = False,
                        name: Optional[str] = None) -> int:
    """Beyond the reference's op set (reduce-scatter is internal-only there,
    operations.cc:1350): reduce across ranks, return this rank's dim-0 shard."""
    arr = _to_numpy(tensor)
    h = _engine().enqueue("reducescatter", arr,
                          _name(name, "reducescatter", tensor), average=average)
    _handle_map[h] = (tensor, None)
    return h


# --------------------------------------------------------------- sparse path

def sparse_allreduce_async(tensor: torch.Tensor, average: bool = True,
                           name: Optional[str] = None) -> tuple[int, int]:
    """Allreduce of a torch sparse COO tensor without densifying: allgather
    the (values, indices) pair over the ring, exactly the reference's
    IndexedSlices decomposition (tensorflow/__init__.py:72-83 — allgather of
    values and indices; its torch binding only offers sparse_as_dense
    densification, so this is a capability the reference reserves for TF).
    The engine's ragged allgather carries per-rank nnz naturally. Returns
    the two handles; pass them to :func:`sparse_synchronize`."""
    t = tensor if tensor.is_coalesced() else tensor.coalesce()
    eng = _engine()
    values = t.values().contiguous()
    # COO indices are (sparse_dim, nnz); allgather concatenates dim 0, so
    # ship them row-per-entry as (nnz, sparse_dim).
    indices = t.indices().t().contiguous()
    base = name or ""
    h_v = eng.enqueue("allgather", _to_numpy(values),
                      f"{base}.values" if base else None)
    h_i = eng.enqueue("allgather", _to_numpy(indices),
                      f"{base}.indices" if base else None)
    _handle_map[h_v] = (values, None)
    _handle_map[h_i] = (indices, None)
    _sparse_meta[(h_v, h_i)] = (tuple(tensor.shape), average)
    return h_v, h_i


def sparse_synchronize(handles: tuple[int, int]) -> torch.Tensor:
    """Complete a :func:`sparse_allreduce_async`: returns a COALESCED sparse
    tensor — coalescing performs the local scatter-add of same-index rows
    from different ranks. ``average`` divides values by world size, like the
    dense op."""
    h_v, h_i = handles
    shape, average = _sparse_meta.pop(handles)
    all_values = synchronize(h_v)
    all_indices = synchronize(h_i)
    if average:
        all_values = all_values / basics.size()
    out = torch.sparse_coo_tensor(all_indices.t(), all_values, shape)
    return out.coalesce()


def sparse_allreduce(tensor: torch.Tensor, average: bool = True,
                     name: Optional[str] = None) -> torch.Tensor:
    return sparse_synchronize(sparse_allreduce_async(tensor, average, name))


_sparse_meta: dict[tuple[int, int], tuple[tuple, bool]] = {}


def poll(handle: int) -> bool:
    return _engine().poll(handle)


def synchronize(handle: int) -> torch.Tensor:
    """Wait for an async op; returns the result tensor (the input tensor for
    in-place variants, reference torch/mpi_ops.py:422-438)."""
    tensor, inplace_target = _handle_map.pop(handle, (None, None))
    result = _engine().synchronize(handle)
    out = _from_numpy(np.asarray(result))
    if inplace_target is not None:
        with torch.no_grad():
            inplace_target.copy_(out.reshape(inplace_target.shape))
        return inplace_target
    return out


# -------------------------------------------------------------------- sync API

class HorovodAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, average, name):
        ctx.average = average
        return synchronize(allreduce_async(tensor, average, name))

    @staticmethod
    def backward(ctx, grad_output):
        return (synchronize(allreduce_async(grad_output.contiguous(),
                                            ctx.average, None)), None, None)


class HorovodAllgather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name):
        dim0 = tensor.shape[0] if tensor.ndim else 1
        # Ranks may gather different first dims: learn every rank's size so
        # backward can slice at the right offset (reference
        # tensorflow/mpi_ops.py:135-160 gathers the sizes the same way).
        sizes = synchronize(allgather_async(
            torch.tensor([dim0], dtype=torch.int64), None))
        r = basics.rank()
        ctx.offset = int(sizes[:r].sum())
        ctx.dim0 = dim0
        return synchronize(allgather_async(tensor, name))

    @staticmethod
    def backward(ctx, grad_output):
        # grad of allgather = allreduce(sum) then slice out our rows
        summed = synchronize(allreduce_async(grad_output.contiguous(), False, None))
        return summed[ctx.offset:ctx.offset + ctx.dim0], None


class HorovodBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return synchronize(broadcast_async(tensor, root_rank, name))

    @staticmethod
    def backward(ctx, grad_output):
        grad = synchronize(allreduce_async(grad_output.contiguous(), False, None))
        if basics.rank() != ctx.root_rank:
            grad = grad * 0
        return grad, None, None


# Casts of the compression names (``compression.Compression``) for a float
# tensor wider than the wire, as the reference's torch compressors do.
_CAST = {"fp16": torch.float16, "bf16": torch.bfloat16}


def allreduce(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None, compression: Any = None) -> torch.Tensor:
    """Differentiable allreduce. ``compression`` (``Compression.fp16`` or
    ``.bf16``) casts a wider float tensor for the engine and back."""
    wire = _CAST.get(compression_name(compression))
    if wire is None or tensor.dtype not in (torch.float32, torch.float64):
        return HorovodAllreduce.apply(tensor, average, name)
    out = HorovodAllreduce.apply(tensor.to(wire), average, name)
    return out.to(tensor.dtype)


def allreduce_(tensor: torch.Tensor, average: bool = True,
               name: Optional[str] = None) -> torch.Tensor:
    return synchronize(allreduce_async_(tensor, average, name))


def allgather(tensor: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
    return HorovodAllgather.apply(tensor, name)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    return HorovodBroadcast.apply(tensor, root_rank, name)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name))


def alltoall(tensor: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
    return synchronize(alltoall_async(tensor, name))


def reducescatter(tensor: torch.Tensor, average: bool = False,
                  name: Optional[str] = None) -> torch.Tensor:
    return synchronize(reducescatter_async(tensor, average, name))
