"""Sharded data parallelism (ZeRO) of the port against the JAX package.

In one process: ``parse_mesh_spec`` on the reference's table of spellings
and errors; ``build_shard_plan`` field for field against the JAX plan on
the reference tests' MLP (``tests/test_sharded.py`` ``make_params``: 33
and 9 divide by no shard size) and on slice 1's TransformerLM at small
width in ``convert.jax_ordered`` order, at shard sizes 1, 2 and 4 with 1
and 2 buckets, the DCN cap, and the DP plan at shard 1; the rows of
``shard_params`` against the JAX buffers' rows, the round trips,
``state_bytes_per_rank``, ``mask_pad_`` against ``mask_pad_updates``; the
ValueErrors of the sharded optimizer and trainer.

A 4-rank gloo world (tests/torch_port_sharded_worker.py, ``zero``) against
the same functions on the virtual CPU mesh: the ``sharded_groups``
layouts against ``sharded_mesh(...).devices``; reduce-scatter then gather
of integer-valued payloads against the JAX exchange; the 2x2 Adam
trajectory against ``DistributedOptimizer(sharded=True)`` on
``grid_mesh(2, 2)``; shard=1 (4x1) against the port's flat DP world; the
pad tail under a noisy inner optimizer; the bf16 wire;
``broadcast_sharded_state``. A 2-rank world (``train``): the trainer's
ZeRO and FSDP steps against its DP step.

Tolerances:
- layouts, plans, rows, integer payloads, broadcasts: exact;
- shard=1 against DP, in the port: bit for bit (same plan, same call over
  a group of the same ranks, the same foreach Adam per element);
- the trainer on 2 ranks (ZeRO 1x2, FSDP 2) against DP: bit for bit. A
  sum of two operands is one rounding whichever order it takes, the
  average divides by 2 exactly, and Adam runs the same arithmetic per
  element;
- the 2x2 trajectory against JAX, float64 on both sides
  (``jax.enable_x64``): |err| <= 1e-12 x max(1, |ref|). The two sides sum
  four gradients in other orders (~1e-16 relative) and Adam's
  m / (sqrt(v) + eps) carries that over 5 steps at lr 1e-2 into a few
  float64 ulps of the parameters (read: 7.5e-16);
- the bf16 wire: positive payloads, so no partial sum cancels. Each side
  casts the same float32 inputs to bf16 the same way and rounds its two
  partial sums (the shard reduce-scatter, the batch all-reduce) to bf16,
  at most 2^-8 relative each, so the two agree to 2 x 2 x 2^-8 = 2^-6
  relative (read: bit for bit), and each is within 3 x 2^-8 < 2^-6 of the
  float64 mean of the float32 inputs (read: 8.4e-3).
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
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd_tpu
import horovod_tpu_torch as hvd
import test_sharded as ref
from horovod_tpu import metrics as jax_metrics
from horovod_tpu.compat import shard_map
from horovod_tpu.parallel import mesh as jax_mesh
from horovod_tpu.parallel import sharded as jsh
from horovod_tpu_torch import convert
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.parallel import fusion, mesh
from horovod_tpu_torch.parallel import sharded as sh
from horovod_tpu_torch.parallel.collectives import ReduceOp
from launch_util import REPO, free_port

WORKER = os.path.join(REPO, "tests", "torch_port_sharded_worker.py")
N = 4
NAMES = ["b1", "w1", "w2"]          # JAX's flatten order of make_params
TRAJ_TOL, WIRE_RTOL = 1e-12, 2.0 ** -6
LAYOUTS = {"2x2": (2, 2, None), "1x4": (1, 4, None), "4x1": (4, 1, None),
           "2x2x1": (2, 2, 1)}


def _np_params(dtype=np.float32):
    params = ref.make_params()
    return {k: np.asarray(params[k], dtype) for k in NAMES}


def _torch_leaves(params):
    return [torch.tensor(params[k]) for k in NAMES]


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ------------------------------------------------------------ one process

SPECS = ["", "8", "4x2", "2X4", "4×2", "-1x2", "2x-1", "4x2x1", "2x2x2",
         "2X2×2", "-1x2x2", "2x-1x2", "4x1x-1",
         "3x2", "axb", "-1x-1", "0x8", "4x3", "2x2x3", "4x2x2", "0x2x4",
         "2x2x0", "axbxc", "-1x-1x2", "2x-1x-1", "1x2x3x4", "16x1x1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jax_mesh.parse_mesh_spec(spec, 8)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.parse_mesh_spec(spec, 8)
        assert str(got.value) == str(e)
    else:
        assert mesh.parse_mesh_spec(spec, 8) == want
    assert mesh._spec_names_model(spec) == jax_mesh._spec_names_model(spec)


def _lm_trees():
    from horovod_tpu.models import TransformerLM as JaxLM

    kw = dict(vocab=64, dim=32, heads=4, layers=3)
    params = jax.jit(JaxLM(**kw).init)(jax.random.PRNGKey(0),
                                       jnp.ones((1, 8), jnp.int32))["params"]
    named = convert.jax_ordered(TransformerLM(**kw).named_parameters())
    return params, [p.detach() for _, p in named]


TREES = {"mlp": lambda: (ref.make_params(), _torch_leaves(_np_params())),
         "lm": _lm_trees}


def _plan_fields(plan):
    """Every field of a plan of either package, dtypes by name."""
    dtypes = [_dtype_name(d) if isinstance(d, torch.dtype) else jnp.dtype(d).name
              for d in plan.bucket_dtypes]
    return ([[d.index for d in b] for b in plan.base.buckets], plan.shard_size,
            plan.threshold, list(plan.raw_sizes), list(plan.padded_sizes),
            list(plan.chunk_sizes), dtypes, plan.model_size, plan.num_buckets,
            plan.state_bytes_per_rank())


@pytest.mark.parametrize("threshold", [1 << 20, 2048])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shard", [1, 2, 4])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_shard_plan_matches_jax(monkeypatch, tree, shard, k, threshold):
    monkeypatch.delenv("HOROVOD_DCN_FUSION_THRESHOLD", raising=False)
    jtree, leaves = TREES[tree]()
    want = jsh.build_shard_plan(jtree, shard, threshold, k)
    got = sh.build_shard_plan(leaves, shard, threshold, k)
    assert _plan_fields(got) == _plan_fields(want)
    if shard == 1:
        dp = fusion.build_plan(leaves, threshold, k)
        assert got.base.buckets == dp.buckets and got.raw_sizes == got.padded_sizes


@pytest.mark.parametrize("env", [None, "4096"])
def test_dcn_cap_matches_jax(monkeypatch, env):
    """An explicit DCN cap, and HOROVOD_DCN_FUSION_THRESHOLD read when the
    argument is None, bound the buckets at D x shard on both sides."""
    monkeypatch.delenv("HOROVOD_DCN_FUSION_THRESHOLD", raising=False)
    if env is not None:
        monkeypatch.setenv("HOROVOD_DCN_FUSION_THRESHOLD", env)
    jtree = {f"w{i}": jnp.zeros((1 << 10,), jnp.float32) for i in range(64)}
    leaves = [torch.zeros(1 << 10) for _ in range(64)]
    for dcn in (16 << 10, None):
        want = jsh.build_shard_plan(jtree, 4, threshold=1 << 30, dcn_threshold=dcn)
        got = sh.build_shard_plan(leaves, 4, threshold=1 << 30, dcn_threshold=dcn)
        assert _plan_fields(got) == _plan_fields(want)
    assert got.num_buckets == (1 if env is None else 16)


@pytest.mark.parametrize("shard", [1, 2, 4, 8])
def test_rows_and_round_trip_match_jax(shard):
    params = _np_params()
    jplan = jsh.build_shard_plan(ref.make_params(), shard, threshold=1 << 20)
    want = [np.asarray(b) for b in jsh.shard_params(ref.make_params(), jplan)]
    leaves = _torch_leaves(params)
    plan = sh.build_shard_plan(leaves, shard, threshold=1 << 20)
    rows = [sh.shard_params(leaves, plan, s) for s in range(shard)]
    for s, r in enumerate(rows):
        assert [tuple(x.shape) for x in r] == [(c,) for c in plan.chunk_sizes]
        for b, row in enumerate(r):
            np.testing.assert_array_equal(row.detach().numpy(), want[b][s])
    back = sh.unshard_params(rows, plan)
    for a, b in zip(back, leaves):
        assert torch.equal(a, b)
    assert plan.state_bytes_per_rank() == jplan.state_bytes_per_rank()
    assert sh.state_bytes(rows) == jsh.state_bytes(jsh.shard_params(
        ref.make_params(), jplan))
    assert sh.state_bytes(leaves) == jsh.state_bytes(ref.make_params())


def test_state_bytes_per_rank_shrinks_shard_fold():
    leaves = _torch_leaves(_np_params())
    plan = sh.build_shard_plan(leaves, 4, threshold=1 << 20)
    assert plan.state_bytes_per_rank() < sh.state_bytes(leaves) / 4 + \
        4 * plan.num_buckets * 4
    assert sh.state_bytes(sh.shard_params(leaves, plan, 3)) == \
        plan.state_bytes_per_rank()


def test_mask_pad_matches_jax_mask():
    leaves = _torch_leaves(_np_params())
    plan = sh.build_shard_plan(leaves, 4, threshold=1 << 20, num_buckets=2)
    jplan = jsh.build_shard_plan(ref.make_params(), 4, threshold=1 << 20,
                                 num_buckets=2)
    want = [np.asarray(b) for b in jsh.mask_pad_updates(jsh.ShardedBuckets(
        jnp.ones((4, c)) for c in jplan.chunk_sizes), jplan)]
    assert any(r != p for r, p in zip(plan.raw_sizes, plan.padded_sizes))
    for s in range(4):
        rows = sh.ShardedBuckets(torch.nn.Parameter(torch.ones(c))
                                 for c in plan.chunk_sizes)
        sh.mask_pad_(rows, plan, s)
        for b, row in enumerate(rows):
            np.testing.assert_array_equal(row.detach().numpy(), want[b][s])


def test_unmasked_noise_would_drift_tail():
    """Without ``mask_pad_`` an inner optimizer that moves zero-gradient
    entries moves the last rank's tail; ``mask_pad_`` puts it back to 0.0
    and touches nothing else."""
    from torch_port_sharded_worker import Noisy

    leaves = _torch_leaves(_np_params())
    plan = sh.build_shard_plan(leaves, 4, threshold=1 << 20)
    rows = sh.shard_params(leaves, plan, 3)
    for row in rows:
        row.grad = torch.zeros_like(row)
    Noisy(list(rows), 1e-2, 0).step()
    valid = [min(max(r - 3 * c, 0), c) for r, c in zip(plan.raw_sizes, plan.chunk_sizes)]
    assert any((row[v:] != 0).any() for row, v in zip(rows, valid))
    kept = [row[:v].clone() for row, v in zip(rows, valid)]
    sh.mask_pad_(rows, plan, 3)
    for row, v, k in zip(rows, valid, kept):
        assert not row[v:].any() and torch.equal(row[:v], k)


def test_trees_and_model_stacks_round_trip():
    leaves = _torch_leaves(_np_params())
    plan = sh.build_shard_plan(leaves, 2, threshold=1 << 20, model_size=2)
    states = [{"params": sh.shard_params(leaves, plan, s), "step": 3}
              for s in range(2)]
    full = sh.unshard_tree(states, plan)
    assert full["step"] == 3
    assert all(torch.equal(a, b) for a, b in zip(full["params"], leaves))
    plan4 = sh.build_shard_plan(leaves, 4, threshold=1 << 20)
    again = sh.reshard_tree(full, {"params": sh.shard_params(leaves, plan4, 0),
                                   "step": 0}, plan4, 2)
    assert again["step"] == 3
    assert all(torch.equal(a, b) for a, b in zip(
        again["params"], sh.shard_params(leaves, plan4, 2)))
    other = [t * 2 for t in leaves]
    stacked = sh.shard_params_model([leaves, other], plan)
    jplan = jsh.build_shard_plan(ref.make_params(), 2, threshold=1 << 20,
                                 model_size=2)
    jother = {k: v * 2 for k, v in ref.make_params().items()}
    want = jsh.shard_params_model([ref.make_params(), jother], jplan)
    for i, rows in enumerate(stacked):
        for b, row in enumerate(rows):
            np.testing.assert_array_equal(row.detach().numpy(), np.asarray(want[b])[i])
    back = sh.unshard_params_model(stacked, plan)
    assert all(torch.equal(a, b) for a, b in zip(back[1], other))


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR", "HOROVOD_MESH",
              "HOROVOD_SHARD_PARAMS", "HOROVOD_COMPRESSION",
              "HOROVOD_COMPRESSION_MIN_BYTES"):
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    hvd.shutdown()


def _rows_opt(**kw):
    leaves = _torch_leaves(_np_params())
    params = [torch.nn.Parameter(t.clone()) for t in leaves]
    plan = sh.build_shard_plan(params, 1, threshold=1 << 20)
    rows = sh.shard_params(params, plan, 0)
    return hvd.DistributedOptimizer(torch.optim.Adam(list(rows)),
                                    list(zip(NAMES, params)), shard_plan=plan, **kw)


def test_sharded_optimizer_errors_match_jax(world_of_one):
    hvd.init(device="cpu")
    with pytest.raises(ValueError) as jerr:
        hvd_tpu.jax.DistributedOptimizer(optax.sgd(1.0), sharded=True,
                                         backward_passes_per_step=2)
    with pytest.raises(ValueError) as err:
        _rows_opt(sharded=True, backward_passes_per_step=2)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jsh.reduce_scatter_gradients({"w": jnp.ones(4)},
                                     jsh.build_shard_plan({"w": jnp.ones(4)}, 1),
                                     op=hvd_tpu.ReduceOp.MAX)
    with pytest.raises(ValueError) as err:
        _rows_opt(sharded=True, op=ReduceOp.MAX)
    assert str(err.value).split(" (got")[0] == str(jerr.value).split(" (got")[0]
    w, v = torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="shard group has 1"):
        hvd.DistributedOptimizer(torch.optim.SGD([v], lr=1.0), [("w", w)],
                                 sharded=True, shard_plan=sh.build_shard_plan([w], 2))
    with pytest.raises(ValueError, match="rows of the plan"):
        hvd.DistributedOptimizer(torch.optim.SGD([v], lr=1.0), [("w", w)],
                                 sharded=True)


def test_sharded_optimizer_reads_the_env(world_of_one):
    """HOROVOD_SHARD_PARAMS and HOROVOD_MESH, read at init: the optimizer
    goes sharded on the env's layout; an explicit False wins."""
    world_of_one.setenv("HOROVOD_SHARD_PARAMS", "1")
    world_of_one.setenv("HOROVOD_MESH", "1x1x1")
    world_of_one.setenv("HOROVOD_COMPRESSION_MIN_BYTES", "0")
    hvd.init(device="cpu")
    opt = _rows_opt()
    assert opt.sharded and opt.layout.model_group is not None
    assert opt.plan is opt.shard_plan.base and len(opt.rows) == opt.plan.num_buckets
    assert opt.wires == [None] * opt.plan.num_buckets
    w = torch.nn.Parameter(torch.zeros(3))
    flat = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0), [("w", w)],
                                    sharded=False)
    assert not flat.sharded
    bf16 = _rows_opt(compression=hvd.Compression.bf16)
    assert bf16.wires == [torch.bfloat16] * bf16.plan.num_buckets


@pytest.mark.parametrize("kw", [dict(sp=1), dict(steps_per_dispatch=2)])
def test_sharded_trainer_rejects_sp_and_graphs(world_of_one, kw):
    from horovod_tpu_torch.train import TrainConfig, setup, setup_fsdp

    config = TrainConfig(vocab=16, dim=32, heads=2, layers=1, seq=8, sharded=True, **kw)
    with pytest.raises(ValueError, match="does not combine"):
        setup(config, "cpu")
    with pytest.raises(ValueError, match="plain step only"):
        setup_fsdp(TrainConfig(vocab=16, dim=32, heads=2, layers=1, seq=8, **kw),
                   device="cpu")


def test_world_of_one_layout(world_of_one):
    hvd.init(device="cpu")
    lay = hvd.sharded_groups()
    assert (lay.batch_size, lay.shard_size, lay.model_size, lay.model_group) == \
        (1, 1, 1, None)
    assert hvd.sharded_groups(model=1).model_group is not None
    with pytest.raises(ValueError, match="HOROVOD_MESH"):
        hvd.sharded_groups(batch=2)
    t = hvd.training_groups(1, 1)
    assert (t.dp_size, t.fsdp_size, t.dp_rank, t.fsdp_rank) == (1, 1, 0, 0)
    with pytest.raises(ValueError, match="world size"):
        hvd.training_groups(2, 1)


# ------------------------------------------------------ the 4-rank world

def _launch(n, mode, inp, out, timeout=300):
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", SHARDED_MODE=mode,
                   SHARDED_IN=str(inp), SHARDED_OUT=str(out), OMP_NUM_THREADS="1")
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                    "HOROVOD_MESH", "HOROVOD_SHARD_PARAMS", "HOROVOD_COMPRESSION",
                    "HOROVOD_FUSION_THRESHOLD", "HOROVOD_NUM_BUCKETS",
                    "HOROVOD_DCN_FUSION_THRESHOLD", "HOROVOD_COMPRESSION_MIN_BYTES"):
            env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    failures = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"rank {rank} exit {proc.returncode}:\n{err[-3000:]}")
    assert not failures, "\n".join(failures)
    return [dict(np.load(f"{out}.{rank}.npz")) for rank in range(n)]


def _per_device(body, mesh, *args):
    """``body`` on each device of ``mesh`` with its row of each arg; the
    outputs stacked rank-major."""
    axes = tuple(mesh.axis_names)
    fn = jax.jit(shard_map(
        lambda *a: jax.tree_util.tree_map(lambda t: t[None], body(
            *jax.tree_util.tree_map(lambda t: t[0], a))),
        mesh=mesh, in_specs=P(axes), out_specs=P(axes), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn(*args))


def _jax_oracle(ints, b, s):
    """The JAX exchange then gather of ``ints + rank`` on a b x s mesh."""
    plan = jsh.build_shard_plan(ints, s, threshold=1 << 20, num_buckets=2)

    def body(g):
        r = jax.lax.axis_index("batch") * s + jax.lax.axis_index("shard")
        g = jax.tree_util.tree_map(lambda t: t + r.astype(t.dtype), g)
        return jsh.gather_params(jsh.reduce_scatter_gradients(g, plan), plan)

    stacked = jax.tree_util.tree_map(lambda t: jnp.broadcast_to(t, (N,) + t.shape), ints)
    return _per_device(body, ref.grid_mesh(b, s), stacked)


def _jax_wire(big, min_bytes):
    """The bf16 exchange of per-rank ``big`` on 2 x 2 and its recorded
    wire plan."""
    tree = {"w": jnp.asarray(big[0])}
    plan = jsh.build_shard_plan(tree, 2, threshold=1 << 20, num_buckets=1)

    def body(g):
        out = jsh.reduce_scatter_gradients(g, plan, compression="bf16",
                                           compression_min_bytes=min_bytes)
        return jsh.gather_params(out, plan)

    got = _per_device(body, ref.grid_mesh(2, 2), {"w": jnp.asarray(big)})
    return got["w"], jax_metrics.last_wire_plan()


@pytest.fixture(scope="module")
def zero_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_world")
    params32 = _np_params()
    x, y = (np.asarray(t, np.float32) for t in ref.make_data(N))
    ints = {"a": np.arange(131, dtype=np.float32) % 13,
            "b": (np.arange(64, dtype=np.float32).reshape(8, 8) % 7) - 3.0}
    big = np.random.default_rng(5).uniform(0.5, 1.5, (N, 1 << 14)).astype(np.float32)
    inputs = {**{f"params/{k}": v for k, v in params32.items()},
              **{f"ints/{k}": v for k, v in ints.items()},
              "x": x.reshape(N, 8, 16), "y": y.reshape(N, 8, 9), "big": big}
    np.savez(tmp / "in.npz", **inputs)
    got = _launch(N, "zero", tmp / "in.npz", tmp / "out")

    want = {}
    for name, (b, s, m) in LAYOUTS.items():
        want[f"mesh/{name}"] = jax_mesh.sharded_mesh(b, s, m, devices=jax.devices()[:N])
    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_MESH", "2x2")
    want["mesh/env 2x2"] = jax_mesh.sharded_mesh(devices=jax.devices()[:N])
    mp.undo()
    jints = {k: jnp.asarray(v) for k, v in ints.items()}
    for name, (b, s, _) in (("2x2", LAYOUTS["2x2"]), ("1x4", LAYOUTS["1x4"])):
        want[f"oracle/{name}"] = _jax_oracle(jints, b, s)
    with jax.enable_x64(True):
        p64 = {k: jnp.asarray(v, jnp.float64) for k, v in params32.items()}
        traj, _, _ = ref._train(ref.grid_mesh(2, 2), 2, 2, p64,
                                jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64))
        want["traj64"] = {k: np.asarray(v) for k, v in traj.items()}
    for tag, min_bytes in (("bf16", 0), ("optout", 1 << 20)):
        want[f"wire/{tag}"] = _jax_wire(big, min_bytes)
    jplan = jsh.build_shard_plan(ref.make_params(), 2, threshold=1 << 20, num_buckets=2)
    want["fresh_rows"] = [np.asarray(b) for b in jsh.shard_params(ref.make_params(), jplan)]
    return inputs, want, got


def _ids(jmesh):
    return np.vectorize(lambda d: d.id)(jmesh.devices)


@pytest.mark.parametrize("name", sorted(LAYOUTS) + ["env 2x2"])
def test_world_layout_matches_sharded_mesh(zero_world, name):
    _, want, got = zero_world
    ids = _ids(want[f"mesh/{name}"])
    three = ids.ndim == 3
    if not three:
        ids = ids[..., None]
    for rank, g in enumerate(got):
        b, s, m = (int(c[0]) for c in np.nonzero(ids == rank))
        coords = g[f"layout/{name}/coords"].tolist()
        assert coords == [b, ids.shape[0], s, ids.shape[1], m, ids.shape[2]]
        assert g[f"layout/{name}/batch"].tolist() == ids[:, s, m].tolist()
        assert g[f"layout/{name}/shard"].tolist() == ids[b, :, m].tolist()
        assert g[f"layout/{name}/model"].tolist() == (ids[b, s, :].tolist()
                                                      if three else [])


def test_world_creates_groups_in_one_order(zero_world):
    _, _, got = zero_world
    calls = [json.loads(str(g["new_group_calls"])) for g in got]
    assert all(c == calls[0] for c in calls)
    # 2x2: 2 batch + 2 shard groups; 1x4: 4 + 1; 4x1: 1 + 4; 2x2x1: 2 + 2
    # + 4 model groups; the env's 2x2: 2 + 2.
    assert len(calls[0]) == 4 + 5 + 5 + 8 + 4


@pytest.mark.parametrize("name", ["2x2", "1x4"])
def test_world_reduce_scatter_oracle_is_bitwise(zero_world, name):
    inputs, want, got = zero_world
    for k in ("a", "b"):
        ints = inputs[f"ints/{k}"]
        mean = ints + np.mean(np.arange(N, dtype=np.float32))
        for rank, g in enumerate(got):
            np.testing.assert_array_equal(g[f"oracle/{name}/{k}"],
                                          want[f"oracle/{name}"][k][rank])
            np.testing.assert_array_equal(g[f"oracle/{name}/{k}"], mean)


def test_world_trajectory_2x2_matches_jax(zero_world):
    _, want, got = zero_world
    for n in NAMES:
        ref_ = want["traj64"][n]
        for g in got:
            np.testing.assert_array_equal(g[f"traj64/{n}"], got[0][f"traj64/{n}"])
        err = np.abs(got[0][f"traj64/{n}"] - ref_)
        assert (err <= TRAJ_TOL * np.maximum(1.0, np.abs(ref_))).all(), (n, err.max())


def test_world_shard1_equals_dp_bitwise(zero_world):
    _, _, got = zero_world
    for g in got:
        for n in NAMES:
            assert g[f"shard1/{n}"].tobytes() == g[f"dp/{n}"].tobytes(), n


def test_world_pad_tail_stays_zero_under_noise(zero_world):
    _, _, got = zero_world
    raw, chunk = got[0]["noise/raw"], got[0]["noise/chunk"]
    assert any(r % N for r in raw), "test vacuous: no bucket has a pad"
    drifted = False
    for rank, g in enumerate(got):
        for b, (r, c) in enumerate(zip(raw, chunk)):
            valid = min(max(r - rank * c, 0), c)
            assert not g[f"noise/masked/row{b}"][valid:].any(), (rank, b)
            drifted |= bool(g[f"noise/unmasked/row{b}"][valid:].any())
        for n in NAMES:
            np.testing.assert_array_equal(g[f"noise/masked/{n}"],
                                          g[f"noise/unmasked/{n}"])
    assert drifted, "control broken: unmasked noise did not move the tail"


@pytest.mark.parametrize("tag", ["bf16", "optout"])
def test_world_bf16_wire_rides_the_scatter(zero_world, tag):
    inputs, want, got = zero_world
    ref_, (name, buckets) = want[f"wire/{tag}"]
    wires = json.loads(str(got[0][f"wire/{tag}/wires"]))
    assert name == "bf16"
    assert [w is not None for w in wires] == [c for _, c, _ in buckets]
    assert wires == (["bfloat16"] if tag == "bf16" else [None])
    for (nbytes, _, wire_bytes), w in zip(buckets, wires):
        assert wire_bytes == (nbytes // 2 if w else 0)
    mean = inputs["big"].astype(np.float64).mean(axis=0)
    for rank, g in enumerate(got):
        out = g[f"wire/{tag}"]
        if tag == "optout":
            err = np.abs(out - ref_[rank])
            assert (err <= 1e-6 * np.abs(ref_[rank])).all()
            continue
        assert (np.abs(out - ref_[rank]) <= WIRE_RTOL * np.abs(ref_[rank])).all()
        assert (np.abs(out - mean) <= WIRE_RTOL * mean).all()
        assert (out != mean.astype(np.float32)).any(), "no bf16 rounding seen"


def test_world_broadcast_sharded_state(zero_world):
    _, want, got = zero_world
    for rank, g in enumerate(got):
        s = rank % 2
        for b, rows in enumerate(want["fresh_rows"]):
            np.testing.assert_array_equal(g[f"bcast/fresh/row{b}"], rows[s])
        # Before the perturbation every replica of a shard index held the
        # same state; after the broadcast each holds it again.
        keys = [k for k in g if k.startswith("bcast/state/before/")]
        assert len(keys) >= 1 + 4          # lr, per bucket (row, step, m, v)
        for k in keys:
            np.testing.assert_array_equal(g[k], got[s][k], err_msg=k)
            np.testing.assert_array_equal(g[k.replace("/before/", "/after/")],
                                          g[k], err_msg=k)


# ------------------------------------------------------ the 2-rank trainer

TRAIN_CONFIG = dict(vocab=128, dim=64, heads=2, layers=2, seq=64)


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_world")
    np.savez(tmp / "in.npz", config=np.array(json.dumps(TRAIN_CONFIG)))
    return _launch(2, "train", tmp / "in.npz", tmp / "out")


@pytest.mark.parametrize("run", ["zero", "fsdp"])
def test_world_trainer_sharded_equals_dp(train_world, run):
    got = train_world
    if run == "zero":
        assert got[0]["zero/layout"].tolist() == [1, 2]
    for g in got:
        np.testing.assert_array_equal(g[f"{run}/losses"], g["dp/losses"])
        assert np.all(np.diff(g["dp/losses"]) < 0)
        keys = [k for k in g if k.startswith("dp/param/")]
        assert len(keys) == 2 * 6 + 3      # 6 per block, embed, norm, head
        for k in keys:
            assert g[k.replace("dp/", f"{run}/", 1)].tobytes() == g[k].tobytes(), k
