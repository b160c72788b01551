"""Weights of the JAX package's models in the port's models.

``flax_path(name)`` maps a parameter name of the port's TransformerLM to
the path of the same parameter in the flax tree (``embed/embedding``,
``block_3/qkv/kernel``, ``block_1/moe/w_in``, ...). ``cnn_flax_path(name)`` does the same for the
CNN zoo, whose submodules carry the flax scopes' names, so only the leaf
is renamed: a conv or Dense ``weight`` is flax's ``kernel``, a BatchNorm
``weight`` its ``scale``, and the buffers ``running_mean`` and
``running_var`` are ``mean`` and ``var`` in the ``batch_stats`` tree.

A flax Dense kernel ``(in, out)`` is the transpose of the port's
``weight`` ``(out, in)``; a flax conv kernel HWIO is the port's OIHW
``weight`` permuted; every other leaf has the same shape in both (the
MoE's ``gate``, ``w_in`` and ``w_out`` too: they are not Dense kernels). Sorting
the port's parameters by their flax paths gives the order in which JAX
flattens the tree (its dict keys sorted, so ``BottleneckBlock_10`` comes
before ``BottleneckBlock_2``), the order the fusion plan needs to put the
same leaves in the same buckets.

The pipelined TransformerLM's reference layout is ``split_lm_params``'
``(outer, blocks)``: ``outer`` the embedding, final norm and head, and
``blocks`` one tree of the block leaves, each with a leading layer dim.
``stage_state_dict_from_jax`` cuts a ``PipelineStage``'s state dict from
it and ``stages_to_stacked_jax`` puts every stage's tensors (gradients,
for the tests) back into it. A stage's parameters keep the flat model's
names, its blocks renumbered from 0, so ``jax_ordered`` orders a stage as
JAX flattens the flat model's tree, and each stage's bucket plan is the
same on every call.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch

_NORMS = {"norm1": "RMSNorm_0", "norm2": "RMSNorm_1"}
_DENSE = {"qkv", "q_proj", "kv_proj", "o_proj", "mlp_in", "mlp_out"}
_MOE = {"gate", "w_in", "w_out"}     # flax's own layout: no transpose


def flax_path(name: str) -> tuple[str, ...]:
    """Flax param path of the port's parameter ``name``."""
    parts = name.split(".")
    if name == "embed.weight":
        return ("embed", "embedding")
    if name == "norm.scale":
        return ("RMSNorm_0", "scale")
    if name == "lm_head.weight":
        return ("lm_head", "kernel")
    if len(parts) == 4 and parts[0] == "blocks":
        block = f"block_{int(parts[1])}"
        if parts[2] in _NORMS and parts[3] == "scale":
            return (block, _NORMS[parts[2]], "scale")
        if parts[2] in _DENSE and parts[3] == "weight":
            return (block, parts[2], "kernel")
        if parts[2] == "moe" and parts[3] in _MOE:
            return (block, "moe", parts[3])
    raise KeyError(f"no flax counterpart for parameter {name!r}")


# The flax scopes of the CNN zoo's BatchNorms: BatchNorm_k, bn_init,
# bn_{i} (VGG) and norm_proj (ResNet's projection shortcut).
_NORM_SCOPE = re.compile(r"BatchNorm_\d+|bn_\w+|norm_proj")
_STATS = {"running_mean": "mean", "running_var": "var"}


def cnn_flax_path(name: str) -> tuple[str, tuple[str, ...]]:
    """(collection, path) of the CNN zoo's parameter or buffer ``name``:
    ``BottleneckBlock_3.Conv_1.weight`` is ``("params",
    ("BottleneckBlock_3", "Conv_1", "kernel"))``."""
    *scopes, leaf = name.split(".")
    if not scopes:
        raise KeyError(f"no flax counterpart for {name!r}")
    if leaf in _STATS:
        return "batch_stats", (*scopes, _STATS[leaf])
    if leaf == "weight":
        leaf = "scale" if _NORM_SCOPE.fullmatch(scopes[-1]) else "kernel"
    elif leaf != "bias":
        raise KeyError(f"no flax counterpart for {name!r}")
    return "params", (*scopes, leaf)


def cnn_param_path(name: str) -> tuple[str, ...]:
    """Path of the CNN parameter ``name`` in the flax ``params`` tree."""
    collection, path = cnn_flax_path(name)
    if collection != "params":
        raise KeyError(f"{name!r} is a batch statistic, not a parameter")
    return path


def _from_flax(arr: np.ndarray, kernel: bool) -> np.ndarray:
    if not kernel:
        return arr
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T


def _to_flax(arr: np.ndarray, kernel: bool) -> np.ndarray:
    if not kernel:
        return arr
    return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T


def _is_kernel(name: str) -> bool:
    return flax_path(name)[-1] == "kernel"


def _lookup(tree: Mapping, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def transformer_state_dict_from_jax(params: Mapping,
                                    names: Iterable[str]) -> dict:
    """The port's state dict for parameters ``names`` (e.g. the keys of
    ``model.state_dict()``) from a flax param tree of numpy arrays."""
    out = {}
    for name in names:
        arr = np.asarray(_lookup(params, flax_path(name)), dtype=np.float32)
        out[name] = torch.from_numpy(np.array(
            _from_flax(arr, _is_kernel(name)), order="C"))
    return out


def cnn_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                            names: Iterable[str]) -> dict:
    """The CNN's state dict for ``names`` (the keys of
    ``model.state_dict()``: parameters and BatchNorm statistics) from flax
    ``params`` and ``batch_stats`` trees of numpy arrays."""
    trees = {"params": params, "batch_stats": batch_stats}
    out = {}
    for name in names:
        collection, path = cnn_flax_path(name)
        arr = np.asarray(_lookup(trees[collection], path), dtype=np.float32)
        out[name] = torch.from_numpy(np.array(
            _from_flax(arr, path[-1] == "kernel"), order="C"))
    return out


def to_flax_layout(name: str, tensor: torch.Tensor,
                   path: Callable[[str], tuple[str, ...]] = flax_path
                   ) -> np.ndarray:
    """A copy of a port parameter (or its gradient) as a float64 numpy
    array (exact for every float dtype) in flax's layout; ``path`` maps
    the name to its flax path (``cnn_param_path`` for the CNN zoo)."""
    arr = tensor.detach().to("cpu", torch.float64, copy=True).numpy()
    return _to_flax(arr, path(name)[-1] == "kernel")


def jax_ordered(named_parameters: Iterable[tuple[str, torch.Tensor]],
                path: Callable[[str], tuple[str, ...]] = flax_path) -> list:
    """``(name, parameter)`` pairs in the JAX tree's flatten order;
    ``path`` as in ``to_flax_layout``."""
    return sorted(named_parameters, key=lambda kv: path(kv[0]))


def stacked_flax_path(name: str) -> tuple[Optional[int], tuple[str, ...]]:
    """(layer, path) of the port's parameter ``name`` in the stacked layout:
    ``(None, path in outer)`` for an outer leaf, ``(block index, path in
    blocks)`` for a block leaf (whose leaves lead with the layer dim)."""
    path = flax_path(name)
    if path[0].startswith("block_"):
        return int(path[0][len("block_"):]), path[1:]
    return None, path


def stage_state_dict_from_jax(outer: Mapping, blocks: Mapping,
                              names: Iterable[str], pp: int,
                              stage: int) -> dict:
    """Stage ``stage``'s state dict, for parameters ``names`` (the keys of
    a ``PipelineStage``'s ``state_dict()``, blocks numbered from 0), from
    the stacked layout of numpy arrays, the blocks cut into ``pp`` equal
    stages."""
    out = {}
    for name in names:
        layer, path = stacked_flax_path(name)
        if layer is None:
            arr = _lookup(outer, path)
        else:
            stacked = _lookup(blocks, path)
            if stacked.shape[0] % pp:
                raise ValueError(f"{stacked.shape[0]} layers do not cut into "
                                 f"{pp} equal stages")
            arr = stacked[stage * (stacked.shape[0] // pp) + layer]
        arr = np.asarray(arr, dtype=np.float32)
        out[name] = torch.from_numpy(np.array(_from_flax(arr, path[-1] == "kernel"),
                                              order="C"))
    return out


def stages_to_stacked_jax(stages: list) -> tuple[dict, dict]:
    """Every stage's tensors by name (e.g. gradients), in stage order, as
    ``(outer, blocks)`` nested dicts of float64 numpy arrays in flax's
    stacked layout; the outer leaves from stage 0."""
    per = 1 + max(layer for layer, _ in map(stacked_flax_path, stages[0])
                  if layer is not None)
    outer, blocks, layers = {}, {}, {}
    for s, tensors in enumerate(stages):
        for name, t in tensors.items():
            layer, path = stacked_flax_path(name)
            if layer is not None:
                layers.setdefault(path, {})[s * per + layer] = to_flax_layout(name, t)
            elif s == 0:
                _put(outer, path, to_flax_layout(name, t))
    for path, by_layer in layers.items():
        _put(blocks, path, np.stack([by_layer[i] for i in sorted(by_layer)]))
    return outer, blocks


def _put(tree: dict, path: tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
