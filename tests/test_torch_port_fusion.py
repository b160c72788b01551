"""The port's fusion plan against ``horovod_tpu.parallel.fusion``: the same
leaves in the same buckets, exactly, over a grid of thresholds and bucket
counts (greedy K=1 and reverse-order K=2, 3), for a mixed-dtype tree and
for the TransformerLM's parameters in the converter's order; and the same
per-bucket wire-dtype verdicts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.compression import Compression as JaxCompression
from horovod_tpu.parallel import fusion as jax_fusion
from horovod_tpu.parallel.collectives import ReduceOp as JaxReduceOp
from horovod_tpu_torch import convert
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.parallel import fusion
from horovod_tpu_torch.parallel.collectives import ReduceOp

THRESHOLDS = [0, 64, 700, 4096, 20000, 64 << 20]


def _mixed_tree():
    """Leaves of several sizes and three dtypes, so buckets split on both
    the byte cap and dtype changes."""
    shapes = {"a": (3,), "b": (40, 5), "c": (7,), "d": (128, 8), "e": (2, 2),
              "f": (300,), "g": (), "h": (16, 16), "i": (1000,)}
    dtypes = {"c": np.int32, "e": np.float16, "g": np.int32, "h": np.float16}
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(dtypes.get(k, np.float32))
            for k, s in shapes.items()}


def _indices(plan):
    return [[d.index for d in bucket] for bucket in plan.buckets]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_plan_matches_jax_on_mixed_tree(threshold, k):
    tree = _mixed_tree()
    want = _indices(jax_fusion.build_plan(tree, threshold, num_buckets=k))
    leaves = jax.tree_util.tree_leaves(tree)
    assert _indices(fusion.build_plan(leaves, threshold, num_buckets=k)) == want
    tensors = [torch.from_numpy(np.asarray(x)) for x in leaves]
    assert _indices(fusion.build_plan(tensors, threshold, num_buckets=k)) == want


@pytest.mark.parametrize("k", [1, 3])
def test_plan_matches_jax_on_transformer_params(k):
    from horovod_tpu.models import TransformerLM as JaxLM

    kw = dict(vocab=64, dim=32, heads=4, layers=3)
    params = jax.jit(JaxLM(**kw).init)(jax.random.PRNGKey(0),
                                       jnp.ones((1, 8), jnp.int32))["params"]
    named = convert.jax_ordered(TransformerLM(**kw).named_parameters())
    threshold = 40000
    want = _indices(jax_fusion.build_plan(params, threshold, num_buckets=k))
    got = _indices(fusion.build_plan([p for _, p in named], threshold, num_buckets=k))
    assert got == want and len(got) > 1


def test_fuse_unfuse_roundtrip():
    leaves = [torch.arange(6.0).view(2, 3), torch.ones(4), torch.full((1, 1), 7.0)]
    plan = fusion.build_plan(leaves, threshold=1 << 20)
    buffers = fusion.fuse(leaves, plan)
    assert [b.numel() for b in buffers] == [11]
    out = [torch.zeros_like(x) for x in leaves]
    fusion.unfuse_(buffers, plan, out)
    for a, b in zip(out, leaves):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["none", "bf16", "fp16"])
def test_wire_dtype_verdicts_match_jax(name):
    cases = [(np.float32, torch.float32), (np.float16, torch.float16),
             (np.int32, torch.int32), (np.float64, torch.float64)]
    ops = [(JaxReduceOp.SUM, ReduceOp.SUM), (JaxReduceOp.AVERAGE, ReduceOp.AVERAGE),
           (JaxReduceOp.MAX, ReduceOp.MAX)]
    for np_dtype, torch_dtype in cases:
        for nbytes in (100, 4096, 1 << 20):
            for jop, op in ops:
                want = jax_fusion.wire_dtype_for_bucket(
                    JaxCompression.by_name(name), jnp.dtype(np_dtype), nbytes, jop)
                got = fusion.wire_dtype_for_bucket(
                    Compression.by_name(name), torch_dtype, nbytes, op)
                want_name = None if want is None else jnp.dtype(want).name
                got_name = None if got is None else str(got).removeprefix("torch.")
                assert got_name == want_name, (np_dtype, nbytes, jop)
