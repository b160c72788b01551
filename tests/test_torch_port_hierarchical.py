"""Hierarchical data parallelism of the port against the JAX package.

In one process, over grids:
- ``build_plan(pad_to=2, 4)`` gives the JAX plan's buckets and padded
  lengths; ``dcn_capped_threshold``, ``compiled_formats``, ``parse_spec``,
  ``CompressionPolicy.decide`` and ``compiled_tier_format`` give the JAX
  answers; the config reads the same env knobs;
- per bucket, the ICI and DCN wire dtypes of ``fusion.tier_wires`` are the
  ones ``horovod_tpu.parallel.fusion.fused_allreduce`` ships (read from its
  calls of ``hierarchical_allreduce`` while it traces on a virtual
  ``('dcn', 'ici')`` mesh), with the padded bucket lengths, with and
  without HOROVOD_DCN_COMPRESSION;
- ``DistributedOptimizer``'s resolver: an explicit ``hierarchical=True``
  with MAX raises, HOROVOD_HIERARCHICAL_ALLREDUCE with MAX warns and runs
  flat, as ``horovod_tpu.jax._resolved_hierarchical`` does.

A 4-rank gloo world (tests/torch_port_hier_worker.py) with
``HOROVOD_LOCAL_SIZE=2``, so dcn 2 x ici 2, against the same functions on a
2 x 2 virtual mesh (``jax.devices()[:4]``): the new collectives, the ladder,
``fused_allreduce_(hierarchical=True)`` on the mixed-dtype tree of
tests/test_torch_port_fusion.py, and the graft demo's ResNet-18 step
(``__graft_entry__._resnet_dp_step``) in float64.

Tolerances:
- data movement (broadcast, allgathers, all-to-all, the layout) and
  integer payloads: exact;
- float32 sums with no wire cast: |err| <= 1e-6 x max(1, |ref|), sums of
  four values in another order;
- a bf16 DCN wire: |err| <= 2^-8 |ref| + 1e-6, one bf16 rounding (2^-9
  relative) of each DCN partial sum, on either side of a tie;
- float16 leaves: |err| <= 2^-9 |ref| + 1e-6, one float16 rounding (2^-11)
  of each tier's partial sum, on either side;
- the graft step, float64 (both heads in float32, whose rounding, ~1e-7,
  sets the scale): the loss to 1e-6 relative; each parameter's update to
  1e-6 relative norm with no wire. With the bf16 DCN wire both sides cast
  the float64 shards to bf16 by the same rule (to float32, then to bf16),
  but where the heads' float32 rounding moves a shard value (~1e-7
  relative) across a bf16 rounding boundary (2^-9 relative apart) it
  rounds one bf16 unit the other way, in about 1e-7 / 2^-9 ~ 5e-5 of the
  elements (read: at most 39 of 1,179,648, 1 of 9,408): each update is
  held, by the norm of its difference from JAX's, to a tenth of the norm
  by which the bf16 wire moves JAX's own update from full width (read:
  at most 0.021 of it).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd_tpu
import horovod_tpu_torch as hvd
from horovod_tpu import compression as jax_compression
from horovod_tpu import models as jzoo
from horovod_tpu.common import config as jax_config
from horovod_tpu.common import policy as jax_policy
from horovod_tpu.compat import shard_map
from horovod_tpu.parallel import collectives as JC
from horovod_tpu.parallel import fusion as jax_fusion
from horovod_tpu_torch import compression, convert
from horovod_tpu_torch.common import basics, config, policy
from horovod_tpu_torch.parallel import fusion
from horovod_tpu_torch.parallel.collectives import ReduceOp
from launch_util import REPO, free_port

WORKER = os.path.join(REPO, "tests", "torch_port_hier_worker.py")
N = 4
THRESHOLDS = [0, 64, 700, 4096, 20000, 64 << 20]
F32_TOL, BF16_RTOL, F16_RTOL, ATOL = 1e-6, 2.0 ** -8, 2.0 ** -9, 1e-6
GRAFT_LOSS_TOL, GRAFT_UPDATE_TOL, GRAFT_WIRE_SHARE = 1e-6, 1e-6, 0.1
W = ("dcn", "ici")


def _mixed_tree(seed=0, ranks=None):
    """The mixed-dtype tree of tests/test_torch_port_fusion.py; with
    ``ranks``, a leading dim of one row per rank."""
    shapes = {"a": (3,), "b": (40, 5), "c": (7,), "d": (128, 8), "e": (2, 2),
              "f": (300,), "g": (), "h": (16, 16), "i": (1000,)}
    dtypes = {"c": np.int32, "e": np.float16, "g": np.int32, "h": np.float16}
    rng = np.random.default_rng(seed)
    lead = () if ranks is None else (ranks,)
    out = {}
    for k, s in shapes.items():
        dt = dtypes.get(k, np.float32)
        if np.dtype(dt).kind == "i":
            out[k] = rng.integers(-50, 50, lead + s).astype(dt)
        else:
            out[k] = rng.standard_normal(lead + s).astype(dt)
    return out


def _indices(plan):
    return [[d.index for d in bucket] for bucket in plan.buckets]


def _jax_padded(plan):
    sizes = [sum(d.size for d in b) for b in plan.buckets]
    return [n + (-n % plan.pad_to) for n in sizes]


# ------------------------------------------------------------ one process

@pytest.mark.parametrize("pad_to", [2, 4])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_padded_plan_matches_jax(threshold, k, pad_to):
    tree = _mixed_tree()
    want = jax_fusion.build_plan(tree, threshold, pad_to=pad_to, num_buckets=k)
    leaves = [torch.from_numpy(np.asarray(x)) for x in jax.tree_util.tree_leaves(tree)]
    plan = fusion.build_plan(leaves, threshold, num_buckets=k, pad_to=pad_to)
    assert _indices(plan) == _indices(want) and plan.pad_to == pad_to
    buffers = fusion.fuse(leaves, plan)
    assert [b.numel() for b in buffers] == _jax_padded(want)
    for bucket, buf in zip(plan.buckets, buffers):      # the pad is zeros
        assert not buf[sum(d.size for d in bucket):].any()
    out = [torch.zeros_like(x) for x in leaves]
    fusion.unfuse_(buffers, plan, out)
    assert all(torch.equal(a, b) for a, b in zip(out, leaves))


def test_dcn_capped_threshold_matches_jax():
    for threshold in (0, 4096, 1 << 20, 64 << 20):
        for dcn in (0, -1, 1, 1000, 1 << 20):
            for width in (1, 2, 4, 8):
                assert fusion.dcn_capped_threshold(threshold, dcn, width) == \
                    jax_fusion.dcn_capped_threshold(threshold, dcn, width)


SPECS = ["none", "fp16", "bf16", "topk", "adaptive", "topk@0.05", "TOPK@0.2",
         "topk@0", "topk@-1", "topk@x", "junk", "", None, "BF16"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_and_names_match_jax(spec):
    assert compression.parse_spec(spec) == jax_compression.parse_spec(spec)
    assert compression.compiled_formats(spec) == jax_compression.compiled_formats(spec)
    assert compression.Compression.by_name(spec).name == \
        jax_compression.Compression.by_name(spec).name


def test_topk_helpers_match_jax(monkeypatch):
    for n in (1, 10, 99, 1000, 123457):
        for ratio in (0.001, 0.01, 0.3, 0.5):
            assert compression.topk_k(n, ratio) == jax_compression.topk_k(n, ratio)
    for dt, tdt in ((np.float32, torch.float32), (np.float16, torch.float16),
                    (np.int32, torch.int32), (np.float64, torch.float64)):
        for nbytes in (0, 4, 4096, 4100, 65536, 1 << 20):
            for ratio in (0.01, 0.3, 0.5):
                want = jax_compression.topk_eligible(dt, nbytes, ratio, 4096)
                assert compression.topk_eligible(dt, nbytes, ratio, 4096) == want
                assert compression.topk_eligible(tdt, nbytes, ratio, 4096) == want
    for v in (None, "", "0.05", "0.9", "0", "-1", "junk"):
        if v is None:
            monkeypatch.delenv("HOROVOD_TOPK_RATIO", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_TOPK_RATIO", v)
        assert compression.topk_ratio_from_env() == jax_compression.topk_ratio_from_env()


POLICY_SIZES = [0, 100, 4095, 4096, 4097, 65535, 65536, 65540, 1 << 20, 1 << 26]
POLICY_DTYPES = [(np.float32, torch.float32), (np.float16, torch.float16),
                 (jnp.bfloat16, torch.bfloat16), (np.int32, torch.int32)]


@pytest.mark.parametrize("env", [{}, {"HOROVOD_TOPK_MIN_BYTES": "1000"},
                                 {"HOROVOD_TOPK_MIN_BYTES": "200000",
                                  "HOROVOD_TOPK_RATIO": "0.4"},
                                 {"HOROVOD_TOPK_RATIO": "0.5"}])
def test_policy_table_matches_jax(monkeypatch, env):
    for k in ("HOROVOD_TOPK_MIN_BYTES", "HOROVOD_TOPK_RATIO"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for got_policy, want_policy in (
            (policy.CompressionPolicy(config.Config.from_env()),
             jax_policy.CompressionPolicy(jax_config.Config.from_env())),
            (policy.CompressionPolicy(), jax_policy.CompressionPolicy())):
        assert (got_policy.min_bytes, got_policy.topk_ratio,
                got_policy.topk_min_bytes) == (want_policy.min_bytes,
                                               want_policy.topk_ratio,
                                               want_policy.topk_min_bytes)
    for nbytes in POLICY_SIZES:
        for np_dt, t_dt in POLICY_DTYPES:
            for tier in ("ici", "dcn", "local", "cross", "other"):
                want = want_policy.decide(nbytes, np_dt, tier)
                assert got_policy.decide(nbytes, np_dt, tier) == want
                assert got_policy.decide(nbytes, t_dt, tier) == want
                want = jax_policy.compiled_tier_format(nbytes, np_dt, tier, True)
                assert policy.compiled_tier_format(nbytes, t_dt, tier, True) == want
    assert policy.TIER_ALIASES == jax_policy.TIER_ALIASES
    assert policy.COMPILED_TOPK_SUBSTITUTE == jax_policy.COMPILED_TOPK_SUBSTITUTE
    assert policy.DEFAULT_TOPK_MIN_BYTES == jax_policy.DEFAULT_TOPK_MIN_BYTES


@pytest.mark.parametrize("env", [
    {},
    {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1", "HOROVOD_DCN_COMPRESSION": "BF16",
     "HOROVOD_DCN_FUSION_THRESHOLD": "12345", "HOROVOD_COMPRESSION": "topk@0.05",
     "HOROVOD_TOPK_RATIO": "0.7"},
    {"HOROVOD_HIERARCHICAL_ALLREDUCE": "no", "HOROVOD_COMPRESSION": "adaptive",
     "HOROVOD_DCN_FUSION_THRESHOLD": "-5"},
    {"HOROVOD_COMPRESSION": "junk"},
])
def test_config_matches_jax(monkeypatch, env):
    for k in ("HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_DCN_COMPRESSION",
              "HOROVOD_DCN_FUSION_THRESHOLD", "HOROVOD_COMPRESSION",
              "HOROVOD_TOPK_RATIO", "HOROVOD_TOPK_MIN_BYTES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = config.Config.from_env(), jax_config.Config.from_env()
    for field in ("hierarchical_allreduce", "dcn_fusion_threshold",
                  "compression"):
        assert getattr(got, field) == getattr(want, field), field
    assert config.env_dcn_compression() == want.dcn_compression


def _mesh(dcn, ici):
    return Mesh(np.asarray(jax.devices()[:dcn * ici]).reshape(dcn, ici), W)


def _jax_fused(monkeypatch, mesh, tree, **kw):
    """JAX ``fused_allreduce(hierarchical=True)`` on ``tree`` (leaves with a
    leading rank dim) over ``mesh``: (the reduced tree with the rank dim,
    per bucket (padded length, dtype shipped, DCN wire dtype) from its
    ``hierarchical_allreduce`` calls while it traces)."""
    seen = []
    real = JC.hierarchical_allreduce

    def spy(x, *args, dcn_wire_dtype=None, **kwargs):
        seen.append((int(x.shape[0]), jnp.dtype(x.dtype).name,
                     None if dcn_wire_dtype is None else jnp.dtype(dcn_wire_dtype).name))
        return real(x, *args, dcn_wire_dtype=dcn_wire_dtype, **kwargs)

    monkeypatch.setattr(JC, "hierarchical_allreduce", spy)

    def body(t):
        t = jax.tree_util.tree_map(lambda a: a[0], t)
        out = jax_fusion.fused_allreduce(t, hierarchical=True, **kw)
        return jax.tree_util.tree_map(lambda a: a[None], out)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P(W), out_specs=P(W),
                           check_vma=False))
    with jax.default_matmul_precision("highest"):
        out = fn(tree)
    monkeypatch.setattr(JC, "hierarchical_allreduce", real)
    return jax.tree_util.tree_map(np.asarray, out), seen


def _dtype_name(dtype):
    return None if dtype is None else str(dtype).removeprefix("torch.")


def _port_tiers(tree, threshold, dcn_threshold, ici, op, comp, dcn_comp):
    """The port's plan on rank 0's leaves: per bucket (padded length, dtype
    shipped, DCN wire dtype)."""
    leaves = [torch.from_numpy(np.ascontiguousarray(x[0]))
              for x in jax.tree_util.tree_leaves(tree)]
    plan = fusion.build_plan(leaves, fusion.dcn_capped_threshold(
        threshold, dcn_threshold, ici), pad_to=ici)
    buffers = fusion.fuse(leaves, plan)
    wires, dcn = fusion.tier_wires(plan, op, comp, None, True, dcn_comp)
    return [(b.numel(), _dtype_name(w or b.dtype), _dtype_name(d))
            for b, w, d in zip(buffers, wires, dcn)]


WIRE_CASES = [
    # (compression, dcn_compression, dcn_threshold, threshold)
    ("none", None, 0, 64 << 20), ("none", "bf16", 0, 64 << 20),
    ("none", "fp16", 1024, 64 << 20), ("bf16", None, 0, 64 << 20),
    ("bf16", "fp16", 0, 4096), ("fp16", "bf16", 0, 64 << 20),
    ("topk", None, 0, 64 << 20), ("topk", "bf16", 0, 64 << 20),
    ("adaptive", None, 0, 64 << 20), ("adaptive", None, 512, 64 << 20),
    ("adaptive", "fp16", 0, 64 << 20), ("none", "junk", 0, 2048),
]


@pytest.mark.parametrize("ici", [2, 4])
@pytest.mark.parametrize("case", WIRE_CASES, ids=str)
def test_tier_wires_match_jax(monkeypatch, case, ici):
    """Bucket for bucket: the padded lengths, the ICI wire (the dtype the
    bucket ships at) and the DCN wire, as the JAX fused_allreduce traces
    them. The big leaf makes the adaptive table answer topk (substituted
    by bf16) and cross HOROVOD_TOPK_MIN_BYTES."""
    for k in ("HOROVOD_DCN_COMPRESSION", "HOROVOD_DCN_FUSION_THRESHOLD",
              "HOROVOD_COMPRESSION_MIN_BYTES", "HOROVOD_TOPK_MIN_BYTES",
              "HOROVOD_TOPK_RATIO"):
        monkeypatch.delenv(k, raising=False)
    comp, dcn_comp, dcn_threshold, threshold = case
    tree = _mixed_tree(1, ranks=2 * ici)
    tree["j"] = np.zeros((2 * ici, 40000), np.float32)
    for op, jop in ((ReduceOp.SUM, JC.ReduceOp.SUM),
                    (ReduceOp.AVERAGE, JC.ReduceOp.AVERAGE)):
        _, want = _jax_fused(monkeypatch, _mesh(2, ici), tree, op=jop,
                             threshold=threshold, compression=comp,
                             dcn_compression=dcn_comp, dcn_threshold=dcn_threshold)
        got = _port_tiers(tree, threshold, dcn_threshold, ici, op, comp, dcn_comp)
        assert got == want, (op, got, want)


ENV_WIRE_CASES = [
    # (compression, dcn_compression, HOROVOD_DCN_COMPRESSION)
    ("none", None, "bf16"), ("bf16", None, "fp16"), ("adaptive", None, "fp16"),
    ("adaptive", None, "none"), ("topk", None, "fp16"), ("none", "fp16", "bf16"),
]


@pytest.mark.parametrize("case", ENV_WIRE_CASES, ids=str)
def test_tier_wires_follow_dcn_env(monkeypatch, case):
    """HOROVOD_DCN_COMPRESSION, read when the wires are chosen, as the JAX
    fused_allreduce reads it: it stands in for a missing dcn_compression
    and overrides adaptive's DCN table; an argument wins over it."""
    for k in ("HOROVOD_DCN_FUSION_THRESHOLD", "HOROVOD_COMPRESSION_MIN_BYTES",
              "HOROVOD_TOPK_MIN_BYTES", "HOROVOD_TOPK_RATIO"):
        monkeypatch.delenv(k, raising=False)
    comp, dcn_comp, env = case
    monkeypatch.setenv("HOROVOD_DCN_COMPRESSION", env)
    tree = _mixed_tree(1, ranks=4)
    tree["j"] = np.zeros((4, 40000), np.float32)
    for op, jop in ((ReduceOp.SUM, JC.ReduceOp.SUM),
                    (ReduceOp.AVERAGE, JC.ReduceOp.AVERAGE)):
        _, want = _jax_fused(monkeypatch, _mesh(2, 2), tree, op=jop,
                             compression=comp, dcn_compression=dcn_comp,
                             dcn_threshold=0)
        got = _port_tiers(tree, 64 << 20, 0, 2, op, comp, dcn_comp)
        assert got == want, (op, got, want)


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR",
              "HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_DCN_COMPRESSION",
              "HOROVOD_DCN_FUSION_THRESHOLD"):
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    hvd.shutdown()


def _opt(**kw):
    w = torch.nn.Parameter(torch.ones(3))
    return hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0), [("w", w)], **kw), w


def test_explicit_hierarchical_with_max_raises(world_of_one):
    hvd.init(device="cpu")
    with pytest.raises(ValueError, match="SUM/AVERAGE only"):
        _opt(hierarchical=True, op=ReduceOp.MAX)
    with pytest.raises(ValueError, match="SUM/AVERAGE only"):
        jax_fusion.fused_allreduce({"w": jnp.ones(3)}, hierarchical=True,
                                   op=JC.ReduceOp.MAX)


def test_env_hierarchical_with_max_warns_and_runs_flat(world_of_one, capsys):
    from horovod_tpu.jax import _resolved_hierarchical

    world_of_one.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
    hvd.init(device="cpu")
    assert _resolved_hierarchical(None, JC.ReduceOp.MAX, "ici", "dcn") is False
    capsys.readouterr()
    opt, w = _opt(op=ReduceOp.MAX)
    assert "SUM/AVERAGE only" in capsys.readouterr().err
    assert not opt.hierarchical and opt.groups is None and opt.plan.pad_to == 1
    w.grad = torch.tensor([1.0, -2.0, 3.0])
    opt.step()
    assert torch.equal(w.detach(), torch.tensor([0.0, 3.0, -2.0]))
    opt, _ = _opt()
    assert opt.hierarchical and opt.groups.ici_size == opt.groups.dcn_size == 1


def test_env_dcn_knobs_reach_the_plan(world_of_one):
    """HOROVOD_DCN_COMPRESSION and HOROVOD_DCN_FUSION_THRESHOLD, read at
    init, give the optimizer its DCN wire and its plan's cap; explicit
    arguments win. A world of one: the ladder runs in groups of one and
    gives the flat allreduce's values."""
    world_of_one.setenv("HOROVOD_DCN_COMPRESSION", "bf16")
    world_of_one.setenv("HOROVOD_DCN_FUSION_THRESHOLD", "8192")
    hvd.init(device="cpu")
    ws = [torch.nn.Parameter(torch.full((n,), 1.0)) for n in (2048, 2048, 2048)]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(ws, lr=1.0),
                                   [(str(i), w) for i, w in enumerate(ws)],
                                   hierarchical=True)
    assert opt.wires == ([None] * 3, [torch.bfloat16] * 3)
    assert opt.plan.num_buckets == 3
    explicit = hvd.DistributedOptimizer(
        torch.optim.SGD(ws, lr=1.0), [(str(i), w) for i, w in enumerate(ws)],
        hierarchical=True, dcn_compression="none", dcn_threshold=0)
    assert explicit.wires == ([None], [None]) and explicit.plan.num_buckets == 1
    for w in ws:
        w.grad = torch.full_like(w, 0.5)
    explicit.step()
    assert all(torch.equal(w.detach(), torch.full((2048,), 0.5)) for w in ws)


def test_hierarchical_groups_layout_and_gcd_rule(world_of_one):
    from horovod_tpu_torch.parallel.mesh import hierarchical_groups

    hvd.init(device="cpu")
    g = hierarchical_groups()
    assert (g.ici_rank, g.ici_size, g.dcn_rank, g.dcn_size) == (0, 1, 0, 1)
    with pytest.raises(ValueError, match="not divisible"):
        hierarchical_groups(ici_size=2)


# ------------------------------------------------------ the 4-rank world

FUSED_CASES = {   # as tests/torch_port_hier_worker.py FUSED_CASES
    "plain": ("none", None, 0, ""),
    "dcn_bf16": ("none", "bf16", 0, ""),
    "dcn_capped": ("none", None, 1024, ""),
    "adaptive": ("adaptive", None, 0, ""),
    "dcn_env_bf16": ("none", None, 0, "bf16"),
    "adaptive_env_fp16": ("adaptive", None, 0, "fp16"),
}
BF16_DCN = ("dcn_bf16", "adaptive", "dcn_env_bf16")
F16_DCN = ("adaptive_env_fp16",)
THRESHOLD = 64 << 20
GRAFT_CONFIG = dict(model="ResNet18", num_classes=10, image_size=32, batch=2,
                    dtype="float64", seed=9)


def _randomized(variables, seed):
    """BatchNorm scales and variances from [0.5, 1.5], biases and means
    from N(0, 0.1^2): from the init, the last scale of each residual
    branch is 0 and the branch's gradients would be 0 on both sides."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key, leaf = path[-1].key, np.asarray(leaf)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if key in ("bias", "mean"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, variables)


def _jax_collectives(x, ints, a2a, values, indices):
    def body(x, ints, a2a, values, indices):
        x, ints, a2a, values, indices = (t[0] for t in (x, ints, a2a, values, indices))
        grouped = JC.grouped_allreduce([x, ints], W, JC.ReduceOp.SUM)
        sv, si = JC.sparse_allreduce(values, indices, W)
        out = {
            "ici_allreduce": JC.allreduce(x, "ici"),
            "ici_broadcast": JC.broadcast(x, 1, "ici"),
            "ici_allgather": JC.allgather(x, "ici"),
            "grouped_list_x": grouped[0], "grouped_list_ints": grouped[1],
            "grouped_dict_x": JC.grouped_allreduce({"x": x}, W)["x"],
            "rs_ici": JC.reducescatter(x, "ici"),
            "rs_world_avg": JC.reducescatter(x, W, average=True),
            "a2a_world": JC.alltoall(a2a, W, 1, 0),
            "a2a_ici": JC.alltoall(a2a, "ici", 0, 2),
            "hier_allgather": JC.hierarchical_allgather(ints),
            "sparse_values": sv, "sparse_indices": si,
            "hier_avg": JC.hierarchical_allreduce(x),
            "hier_sum": JC.hierarchical_allreduce(x, average=False),
            "hier_bf16": JC.hierarchical_allreduce(x, dcn_wire_dtype=jnp.bfloat16),
        }
        return {k: v[None] for k, v in out.items()}

    fn = jax.jit(shard_map(body, mesh=_mesh(2, 2), in_specs=P(W), out_specs=P(W),
                           check_vma=False))
    with jax.default_matmul_precision("highest"):
        return {k: np.asarray(v) for k, v in fn(x, ints, a2a, values, indices).items()}


def _jax_graft_step(params, stats, x, y, dcn_wire):
    """``__graft_entry__._resnet_dp_step``'s step on the 2 x 2 mesh, in
    float64; ``dcn_wire`` goes in HOROVOD_DCN_COMPRESSION while it traces.
    Returns (loss, params after the step, per-bucket tiers)."""
    model = jzoo.ResNet18(num_classes=10, dtype=jnp.float64)
    opt = hvd_tpu.jax.DistributedOptimizer(optax.sgd(0.01), hierarchical=True,
                                           fusion_threshold=1 << 20)

    def loss_fn(p, x, y):
        logits = model.apply({"params": p, "batch_stats": stats}, x, train=False)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    def train_step(p, o, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
        updates, o = opt.update(grads, o, p)
        return optax.apply_updates(p, updates), o, jax.lax.pmean(loss, W)

    step = jax.jit(shard_map(train_step, mesh=_mesh(2, 2),
                             in_specs=(P(), P(), P(W), P(W)),
                             out_specs=(P(), P(), P()), check_vma=False))
    old = os.environ.pop("HOROVOD_DCN_COMPRESSION", None)
    if dcn_wire != "none":
        os.environ["HOROVOD_DCN_COMPRESSION"] = dcn_wire
    try:
        with jax.default_matmul_precision("highest"):
            new, _, loss = step(params, opt.init(params), x, y)
    finally:
        os.environ.pop("HOROVOD_DCN_COMPRESSION", None)
        if old is not None:
            os.environ["HOROVOD_DCN_COMPRESSION"] = old
    return float(loss), jax.tree_util.tree_map(np.asarray, new)


def _flatten(tree, prefix):
    return {prefix + "/" + "/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def hier_world(tmp_path_factory):
    """The JAX side, then the port's 4-rank gloo world on the same inputs;
    returns (inputs, JAX results, per-rank port results)."""
    tmp = tmp_path_factory.mktemp("hier_world")
    rng = np.random.default_rng(21)
    inputs = {
        "x": rng.standard_normal((N, 8, 3)).astype(np.float32),
        "ints": rng.integers(-1000, 1000, (N, 6)).astype(np.int32),
        "a2a": rng.standard_normal((N, 2, 8, 3)).astype(np.float32),
        "values": rng.standard_normal((N, 5, 3)).astype(np.float32),
        "indices": rng.integers(0, 100, (N, 5)).astype(np.int32),
    }
    want = {"collectives": _jax_collectives(*(inputs[k] for k in (
        "x", "ints", "a2a", "values", "indices")))}
    tree = _mixed_tree(3, ranks=N)
    names = sorted(tree)
    inputs.update({f"tree/{k}": v for k, v in tree.items()},
                  tree_names=np.array(json.dumps(names)))
    mp = pytest.MonkeyPatch()
    try:
        for case, (comp, dcn_comp, dcn_threshold, env) in FUSED_CASES.items():
            mp.setenv("HOROVOD_DCN_COMPRESSION", env)
            for op_name, jop in (("sum", JC.ReduceOp.SUM),
                                 ("average", JC.ReduceOp.AVERAGE)):
                sub = {k: v for k, v in tree.items()
                       if op_name == "sum" or v.dtype.kind == "f"}
                want[f"{case}/{op_name}"] = _jax_fused(
                    mp, _mesh(2, 2), sub, op=jop, threshold=THRESHOLD,
                    compression=comp, dcn_compression=dcn_comp,
                    dcn_threshold=dcn_threshold)
    finally:
        mp.undo()

    jmodel = jzoo.ResNet18(num_classes=10)
    x = rng.standard_normal((N * 2, 32, 32, 3))
    y = rng.integers(0, 10, N * 2).astype(np.int32)
    variables = _randomized(jax.jit(lambda a: jmodel.init(
        jax.random.PRNGKey(9), a, train=False))(x[:1].astype(np.float32)), 9)
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            (variables["params"], variables["batch_stats"]))
        want["graft_plan"] = _jax_padded(jax_fusion.build_plan(params, 1 << 20,
                                                               pad_to=2))
        for wire in ("none", "bf16"):
            want[f"graft/{wire}"] = _jax_graft_step(params, stats, x, y, wire)
    inputs.update(**_flatten(variables["params"], "graft_params"),
                  **_flatten(variables["batch_stats"], "graft_stats"),
                  graft_x=x.reshape(N, 2, 32, 32, 3), graft_y=y.reshape(N, 2),
                  graft_config=np.array(json.dumps(GRAFT_CONFIG)))
    np.savez(tmp / "in.npz", **inputs)

    port = free_port()
    procs = []
    for rank in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(rank % 2), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", HIER_DEVICE="cpu",
                   HIER_IN=str(tmp / "in.npz"), HIER_OUT=str(tmp / "out"),
                   HOROVOD_DCN_COMPRESSION="bf16", OMP_NUM_THREADS="1")
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                    "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE",
                    "HOROVOD_DCN_FUSION_THRESHOLD", "HOROVOD_COMPRESSION"):
            env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    failures = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"rank {rank} exit {proc.returncode}:\n{err[-3000:]}")
    assert not failures, "\n".join(failures)
    got = [dict(np.load(tmp / f"out.{rank}.npz")) for rank in range(N)]
    return inputs, want, got


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    limit = rtol * np.abs(want) + ATOL if rtol != F32_TOL else \
        F32_TOL * np.maximum(1.0, np.abs(want))
    assert (err <= limit).all(), (what, float(err.max()))


def test_world_layout_is_row_major_ici_minor(hier_world):
    _, _, got = hier_world
    for rank, g in enumerate(got):
        assert g["ici_ranks"].tolist() == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert g["dcn_ranks"].tolist() == [rank % 2, rank % 2 + 2]


EXACT = ["ici_broadcast", "ici_allgather", "grouped_list_ints", "a2a_world",
         "a2a_ici", "hier_allgather", "sparse_indices"]
SUMS = ["ici_allreduce", "grouped_list_x", "grouped_dict_x", "rs_ici",
        "rs_world_avg", "sparse_values", "hier_avg", "hier_sum"]


@pytest.mark.parametrize("name", EXACT + SUMS + ["hier_bf16"])
def test_world_collectives_match_jax(hier_world, name):
    _, want, got = hier_world
    for rank, g in enumerate(got):
        ref = want["collectives"][name][rank]
        if name in EXACT:
            assert g[name].dtype == ref.dtype, name
            np.testing.assert_array_equal(g[name], ref, err_msg=f"{name} {rank}")
        else:
            _close(g[name], ref, BF16_RTOL if name == "hier_bf16" else F32_TOL,
                   f"{name} {rank}")


@pytest.mark.parametrize("op_name", ["sum", "average"])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_world_fused_allreduce_matches_jax(hier_world, case, op_name):
    inputs, want, got = hier_world
    tag = f"{case}/{op_name}"
    ref_tree, tiers = want[tag]
    assert got[0][f"{tag}/padded"].tolist() == [t[0] for t in tiers]
    assert json.loads(str(got[0][f"{tag}/tiers"])) == [list(t[1:]) for t in tiers]
    names = json.loads(str(inputs["tree_names"]))
    for rank, g in enumerate(got):
        for n in names:
            key = f"{tag}/leaf/{n}"
            if op_name == "average" and inputs[f"tree/{n}"].dtype.kind != "f":
                assert key not in g
                continue
            ref = ref_tree[n][rank]
            if ref.dtype.kind == "i":
                np.testing.assert_array_equal(g[key], ref, err_msg=key)
            elif ref.dtype == np.float16 or case in F16_DCN:
                _close(g[key], ref, F16_RTOL, key)
            else:
                _close(g[key], ref, BF16_RTOL if case in BF16_DCN else F32_TOL, key)


def test_world_fused_cases_reach_their_tiers(hier_world):
    """The cases do what they are named for: a bf16 DCN wire on the big
    float32 bucket, a cap that splits the buckets, adaptive's per-bucket
    DCN table (bf16 on the big bucket only), HOROVOD_DCN_COMPRESSION as an
    argument would give it, and over adaptive's table."""
    _, want, _ = hier_world
    dcn = {case: [t[2] for t in want[f"{case}/sum"][1]] for case in FUSED_CASES}
    assert not any(dcn["plain"])
    assert dcn["dcn_bf16"].count("bfloat16") == 1
    assert len(dcn["dcn_capped"]) > len(dcn["plain"])
    assert dcn["adaptive"] == dcn["dcn_bf16"] == dcn["dcn_env_bf16"]
    assert dcn["adaptive_env_fp16"] == [
        w and "float16" for w in dcn["dcn_bf16"]]


def test_world_graft_step_matches_jax(hier_world):
    inputs, want, got = hier_world
    params = {k.split("/", 1)[1]: v for k, v in inputs.items()
              if k.startswith("graft_params/")}
    for wire in ("none", "bf16"):
        loss, after = want[f"graft/{wire}"]
        for g in got:
            assert g[f"{wire}/padded"].tolist() == want["graft_plan"]
            assert abs(float(g[f"{wire}/loss"]) - loss) <= GRAFT_LOSS_TOL * abs(loss)
        keys = [k for k in got[0] if k.startswith(f"{wire}/param/")]
        assert len(keys) == len(params)
        for key in keys:
            name = key.split("/", 2)[2]
            for g in got[1:]:
                np.testing.assert_array_equal(g[key], got[0][key], err_msg=name)
            path = convert.cnn_param_path(name)
            start = np.asarray(convert._lookup(
                jax.tree_util.tree_map(np.asarray, _unflatten(params)), path),
                np.float64)
            ref = np.asarray(convert._lookup(after, path)) - start
            upd = got[0][key] - start
            if wire == "none":
                err = np.linalg.norm(upd - ref) / max(np.linalg.norm(ref), 1e-30)
                assert err <= GRAFT_UPDATE_TOL, (wire, name, err)
            else:
                full = np.asarray(convert._lookup(want["graft/none"][1], path)) - start
                err = np.linalg.norm(upd - ref)
                assert err <= GRAFT_WIRE_SHARE * np.linalg.norm(ref - full), \
                    (wire, name, err, np.linalg.norm(ref - full))


def _unflatten(flat):
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree
