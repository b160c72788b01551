"""Weights of the JAX package's TransformerLM in the port's TransformerLM.

``flax_path(name)`` maps a parameter name of the port's model to the path
of the same parameter in the flax tree (``embed/embedding``,
``block_3/qkv/kernel``, ...). A flax Dense kernel ``(in, out)`` is the
transpose of the port's ``weight`` ``(out, in)``; every other parameter has
the same shape in both. Sorting the port's parameters by their flax paths
gives the order in which JAX flattens the tree (its dict keys sorted), the
order the fusion plan needs to put the same leaves in the same buckets.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

_NORMS = {"norm1": "RMSNorm_0", "norm2": "RMSNorm_1"}
_DENSE = {"qkv", "q_proj", "kv_proj", "o_proj", "mlp_in", "mlp_out"}


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
    raise KeyError(f"no flax counterpart for parameter {name!r}")


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
            arr.T if _is_kernel(name) else arr, order="C"))
    return out


def to_flax_layout(name: str, tensor: torch.Tensor) -> np.ndarray:
    """A port parameter (or its gradient) as a numpy array in flax's layout."""
    arr = tensor.detach().float().cpu().numpy()
    return arr.T if _is_kernel(name) else arr


def jax_ordered(named_parameters: Iterable[tuple[str, torch.Tensor]]) -> list:
    """``(name, parameter)`` pairs in the JAX tree's flatten order."""
    return sorted(named_parameters, key=lambda kv: flax_path(kv[0]))
