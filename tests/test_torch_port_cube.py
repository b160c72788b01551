"""The ``('batch', 'shard', 'model')`` cube in the port's trainer against
the JAX package.

A 4-rank gloo world (tests/torch_port_cube_worker.py, ``cpu``) runs
``train.setup`` of a small float32 TransformerLM (2 layers, dim 64, 4
heads, vocab 64, seq 16) at 4x1x1, 1x1x4 (kv_heads 4, 2 and 1), 2x1x2,
ZeRO 1x2x2, 2x1x2 with the chunked loss (chunk 8) and 2x1x2 with remat,
from ``HOROVOD_MESH`` or ``layout=``, 3 steps each. The JAX side is
``horovod_tpu.models.TransformerLM`` with ``optax.adam`` on the data ranks'
batches put together, from the same weights (through ``convert.py``),
under ``jax.default_matmul_precision("highest")``, with dense attention
(which the JAX suite holds equal to flash); the chunked case takes its
loss from the JAX ``chunked_lm_loss``. The JAX runs are computed while the
world runs.

Tolerances, ``tests/test_torch_port_train.py``'s: losses 1e-5 relative;
parameters at most lr x steps apart and at most 1e-3 of each tensor's
elements past 2e-6 (Adam's step is insensitive to a gradient's rounding
except within float32 noise of zero). A named model axis of one rank
(4x1x1, 2x2x1) against the same layout without it (flat, 2x2): bit for
bit, as the ranks of one data index are against each other.

In one process: ``tp_state_dict``/``tp_merge_state_dicts``/
``tp_param_specs`` over a grid of (heads, kv_heads, tp), exactly; a
virtual model group with ``kv_heads < tp`` against the whole block
(1e-5); ``1x1x1`` against ``1x1`` in a world of one, bit for bit; the
per-rank parameter count at full width and ZeRO's planned state per rank
at 1x2x2.
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

import horovod_tpu_torch as hvd
from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu.models.transformer import chunked_lm_loss as jax_chunked_lm_loss
from horovod_tpu_torch import convert
from horovod_tpu_torch import train as T
from horovod_tpu_torch.models.transformer import (
    TransformerLM, init_weights, tp_merge_state_dicts, tp_param_specs,
    tp_state_dict)
from horovod_tpu_torch.parallel import sharded as sh
from launch_util import REPO, free_port

import torch_port_cube_worker as W

WORKER = os.path.join(REPO, "tests", "torch_port_cube_worker.py")
LR, LOSS_TOL, ELEM_TOL, ELEM_SHARE = 1e-3, 1e-5, 2e-6, 1e-3
# Case -> (kv_heads, remat, loss chunk): each held to the JAX run on its
# data ranks' batches.
JAX_CASES = {
    "4x1x1": (None, False, 0),
    "1x1x4": (None, False, 0),
    "1x1x4 kv2": (2, False, 0),
    "1x1x4 kv1": (1, False, 0),
    "2x1x2": (None, False, 0),
    "1x2x2 zero": (None, False, 0),
    "2x1x2 chunk": (None, False, 8),
    "2x1x2 remat": (None, True, 0),
}
BIT_EQUAL = (("4x1x1", "flat"), ("2x2x1 zero", "2x2 zero"))


def _config(kv_heads=None, remat=False, chunk=0):
    return T.TrainConfig(**W.SMALL, kv_heads=kv_heads, remat=remat, loss_chunk=chunk)


def _flax_params(state: dict) -> dict:
    tree = {}
    for name, t in state.items():
        convert._put(tree, convert.flax_path(name),
             jnp.asarray(convert.to_flax_layout(name, t), jnp.float32))
    return tree


def _jax_run(kv_heads, remat, chunk, n_data):
    """3 Adam steps of the JAX model on data indices 0..n_data-1's batches
    put together, from the whole model that ``build_model`` draws."""
    config = _config(kv_heads, remat, chunk)
    whole = T.build_model(config, "cpu")
    params = _flax_params(whole.state_dict())
    tokens = jnp.asarray(np.concatenate(
        [T.make_batch(config, i, "cpu").numpy() for i in range(n_data)]), jnp.int32)
    model = JaxLM(vocab=config.vocab, dim=config.dim, heads=config.heads,
                  layers=config.layers, kv_heads=kv_heads, remat=remat,
                  dtype=jnp.float32)
    opt = optax.adam(LR)

    def loss_fn(p):
        targets = jnp.roll(tokens, -1, axis=1)
        if chunk:
            hidden = model.apply({"params": p}, tokens, return_hidden=True)
            return jax_chunked_lm_loss(hidden, p["lm_head"]["kernel"], targets, chunk)
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply({"params": p}, tokens), targets).mean()

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    state, losses = opt.init(params), []
    with jax.default_matmul_precision("highest"):
        for _ in range(W.STEPS):
            params, state, loss = step(params, state)
            losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, params)


def _launch(out):
    port = free_port()
    procs = []
    for rank in range(4):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE="4",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="4",
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", CUBE_MODE="cpu",
                   CUBE_OUT=str(out), OMP_NUM_THREADS="1")
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                    "HOROVOD_MESH", "HOROVOD_SHARD_PARAMS", "HOROVOD_COMPRESSION",
                    "HOROVOD_FUSION_THRESHOLD", "HOROVOD_NUM_BUCKETS",
                    "HOROVOD_LATENCY_HIDING", "HOROVOD_HIERARCHICAL_ALLREDUCE"):
            env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def _wait(procs, out, timeout=300):
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
    return [dict(np.load(f"{out}.{rank}.npz")) for rank in range(4)]


@pytest.fixture(scope="module")
def cube_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("cube_world") / "out"
    procs = _launch(out)
    try:
        want = {}
        for case, (kv, remat, chunk) in JAX_CASES.items():
            mesh = [int(c) for c in case.split()[0].split("x")]
            want[case] = _jax_run(kv, remat, chunk, mesh[0] * mesh[1])
    finally:
        got = _wait(procs, out)
    return want, got


def _local(got_rank: dict, case: str) -> dict:
    prefix = f"{case}/p/"
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in got_rank.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_cube_setup_matches_jax(cube_world, case):
    want, got = cube_world
    want_losses, want_params = want[case]
    kv = JAX_CASES[case][0]
    at = {tuple(int(c) for c in g[f"{case}/coords"][:3]): g for g in got}
    b_size, s_size, m_size = (max(k[i] for k in at) + 1 for i in range(3))
    # The ranks of one model index hold the same slices at every data index.
    for (b, s, m), g in at.items():
        ref = _local(at[(0, 0, m)], case)
        for n, t in _local(g, case).items():
            assert torch.equal(t, ref[n]), (case, (b, s, m), n)
    losses = np.mean([at[(b, s, 0)][f"{case}/loss"] for b in range(b_size)
                      for s in range(s_size)], axis=0)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_TOL)
    full = tp_merge_state_dicts([_local(at[(0, 0, m)], case) for m in range(m_size)],
                                kv_heads=kv)
    for name, t in full.items():
        w = np.asarray(convert._lookup(want_params, convert.flax_path(name)))
        diff = np.abs(convert.to_flax_layout(name, t) - w)
        assert diff.max() <= LR * W.STEPS, (case, name, diff.max())
        assert np.mean(diff > ELEM_TOL) <= ELEM_SHARE, (case, name,
                                                        np.sort(diff.ravel())[-5:])


@pytest.mark.parametrize("named,plain", BIT_EQUAL)
def test_model_axis_of_one_is_bitwise_the_2d_layout(cube_world, named, plain):
    _, got = cube_world
    for g in got:
        assert np.array_equal(g[f"{named}/loss"], g[f"{plain}/loss"]), named
        for n, t in _local(g, plain).items():
            assert torch.equal(_local(g, named)[n], t), (named, n)


@pytest.mark.parametrize("case", ["1x1x4", "2x1x2", "1x2x2 zero", "4x1x1"])
def test_model_group_draws_one_batch(cube_world, case):
    """The data index is batch_rank x shard_size + shard_rank, and
    tokens_per_step counts the data ranks."""
    _, got = cube_world
    mesh = [int(c) for c in case.split()[0].split("x")]
    for g in got:
        b, s, m, index, tokens = (int(c) for c in g[f"{case}/coords"])
        assert index == b * mesh[1] + s
        assert tokens == mesh[0] * mesh[1] * W.SMALL["seq"]


def test_train_takes_a_layout(cube_world):
    """``train(layout=sharded_groups(2, 1, 2))``: its world-averaged losses
    are the JAX run's on the two data ranks' batches."""
    want, got = cube_world
    for g in got:
        np.testing.assert_allclose(g["train 2x1x2/loss"], want["2x1x2"][0],
                                   rtol=LOSS_TOL)


def test_tuner_takes_three_axis_candidates(cube_world):
    _, got = cube_world
    for g in got:
        records = json.loads(str(g["tune"]))
        assert [r["mesh_shape"] for r in records] == list(W.TUNE_MESHES)
        assert [r["model_size"] for r in records] == [1, 1, 2, 4]
        assert not any(r["graphed"] for r in records)
        by = {r["mesh_shape"]: r["losses"] for r in records}
        assert by["4x1x1"] == by["4x1"]
        assert all(np.isfinite(r["losses"]).all() for r in records)


def test_refusals(cube_world):
    _, got = cube_world
    for g in got:
        assert "sharded=True" in str(g["refuse/flat_shard"])
        for key in ("refuse/save", "refuse/save_copy", "refuse/host_copy",
                    "refuse/save_opt", "refuse/save_sharded"):
            assert "tensor-parallel model" in str(g[key]), key


def test_hierarchical_ladder_under_a_model_axis_raises(monkeypatch):
    """The ladder spans the world, so a model axis's batch group refuses it,
    whether HOROVOD_HIERARCHICAL_ALLREDUCE or the argument asks for it; a
    refused ``rejit`` leaves the job running as it was."""
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "HOROVOD_COORD_ADDR", "HOROVOD_SHARD_PARAMS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_MESH", "1x1x1")
    config = T.TrainConfig(**W.SMALL, steps_per_dispatch=2)
    for env in ("1", "0"):
        monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", env)
        hvd.init(device="cpu")
        try:
            if env == "1":
                with pytest.raises(ValueError, match="hierarchical ladder"):
                    T.setup(config, "cpu")
                continue
            with pytest.raises(ValueError, match="hierarchical ladder"):
                T.setup(config, "cpu", hierarchical=True)
            job = T.TrainRecapture(config, "cpu")
            job()
            with pytest.raises(ValueError, match="hierarchical ladder"):
                job.rejit({"hierarchical": True})
            assert not job.s.opt.hierarchical and job.recaptures == []
            assert np.isfinite(job().item())
        finally:
            hvd.shutdown()


# ------------------------------------------------------------ one process

GRID = [(h, kv, tp) for h in (4, 8) for kv in (1, 2, 4, 8) for tp in (1, 2, 4, 8)
        if kv <= h and h % kv == 0 and h % tp == 0 and (kv % tp == 0 or tp % kv == 0)]


@pytest.mark.parametrize("heads,kv_heads,tp", GRID)
def test_tp_state_dict_round_trips(heads, kv_heads, tp):
    kw = dict(vocab=64, dim=64, heads=heads, kv_heads=kv_heads, layers=2,
              dtype=torch.float32)
    full = TransformerLM(**kw)
    init_weights(full, torch.Generator().manual_seed(0))
    state = full.state_dict()
    locals_ = [tp_state_dict(state, tp, r, kv_heads) for r in range(tp)]
    merged = tp_merge_state_dicts(locals_, kv_heads=kv_heads)
    assert merged.keys() == state.keys()
    for name, t in state.items():
        assert torch.equal(merged[name], t), name
    rank_model = TransformerLM(**kw, tp_size=tp, tp_rank=0)
    specs = tp_param_specs(rank_model)
    for r, sd in enumerate(locals_):
        rank_model.load_state_dict(sd)          # the rank's shapes
        for name, dim in specs.items():
            if dim is None:
                assert torch.equal(sd[name], state[name]), (name, r)
    if kv_heads != heads:
        assert (specs["blocks.0.kv_proj.weight"] is None) == (kv_heads < tp)


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_kv_heads_below_tp_virtual_world_matches_whole_block(kv_heads):
    """Four virtual ranks, each keeping the one kv head its q heads read,
    their attn_partial and mlp_partial summed, against the whole block:
    output and every gradient (a whole kv_proj's as the sum of the ranks'
    partial gradients, as a replicated leaf's) to 1e-5."""
    kw = dict(vocab=64, dim=64, heads=4, kv_heads=kv_heads, layers=1,
              dtype=torch.float32, attention="flash")
    full = TransformerLM(**kw)
    init_weights(full, torch.Generator().manual_seed(0))
    ranks = []
    for r in range(4):
        m = TransformerLM(**kw, tp_size=4, tp_rank=r)
        m.load_state_dict(tp_state_dict(full.state_dict(), 4, r, kv_heads))
        ranks.append(m.blocks[0])
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 64, generator=gen, requires_grad=True)
    pos = torch.arange(16)[None]
    want = full.blocks[0](x, pos)
    g = torch.randn(want.shape, generator=gen)
    want_grads = torch.autograd.grad(want, [x] + list(full.blocks[0].parameters()), g)
    x1 = x + sum(b.attn_partial(x, pos) for b in ranks)
    got = x1 + sum(b.mlp_partial(x1) for b in ranks)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-5, rtol=1e-5)
    names = [n for n, _ in ranks[0].named_parameters()]
    grads = torch.autograd.grad(got, [x] + [p for b in ranks for p in b.parameters()], g)
    np.testing.assert_allclose(grads[0].numpy(), want_grads[0].numpy(),
                               atol=1e-5, rtol=1e-5)
    per_rank = [dict(zip(names, grads[1 + i * len(names):1 + (i + 1) * len(names)]))
                for i in range(4)]
    specs = tp_param_specs(ranks[0])
    assert specs["kv_proj.weight"] is None
    for n, gw in zip(names, want_grads[1:]):
        if specs[n] is None:
            gm = sum(sd[n] for sd in per_rank)
        else:
            gm = tp_merge_state_dicts([{f"blocks.0.{n}": sd[n]} for sd in per_rank])[
                f"blocks.0.{n}"]
        np.testing.assert_allclose(gm.numpy(), gw.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=n)


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "HOROVOD_COORD_ADDR", "HOROVOD_MESH",
              "HOROVOD_SHARD_PARAMS"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield monkeypatch
    hvd.shutdown()


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "zero"])
def test_1x1x1_is_bitwise_1x1_in_a_world_of_one(world_of_one, sharded):
    config = T.TrainConfig(**W.SMALL, sharded=sharded, loss_chunk=8)
    runs = []
    for spec in ("1x1x1", "1x1"):
        world_of_one.setenv("HOROVOD_MESH", spec)
        s = T.setup(config, "cpu")
        assert (s.layout is not None and s.layout.model_group is not None) == \
            (spec == "1x1x1")
        tokens = T.make_batch(config, s.data_index, "cpu")
        losses = [s.step(tokens).item() for _ in range(W.STEPS)]
        runs.append((losses, W.params_of(s)))
    assert runs[0][0] == runs[1][0]
    for n, t in runs[1][1].items():
        assert torch.equal(runs[0][1][n], t), n


def test_per_rank_parameter_count_at_full_width():
    """The embedding (32,768,000) and the norms (25,600) replicated, the
    rest cut into tp; and ZeRO's planned state per rank at 1x2x2."""
    config = T.TrainConfig()
    want = {1: 216_556_544, 2: 124_675_072, 4: 78_734_336}
    with torch.device("meta"):
        models = {tp: TransformerLM(**T.model_kwargs(config), tp_size=tp)
                  for tp in want}
    replicated = 32_768_000 + 25_600
    for tp, n in want.items():
        assert sum(p.numel() for p in models[tp].parameters()) == n
        assert n == replicated + (want[1] - replicated) // tp
        assert n == W.analytic_params(config, tp)
    leaves = [p for _, p in convert.jax_ordered(models[2].named_parameters())]
    plan = sh.build_shard_plan(leaves, 2, model_size=2)
    pad = sum(plan.padded_sizes) - sum(plan.raw_sizes)
    cut = want[1] - replicated
    # parameters and Adam's two moments, float32, over shard x model
    assert 3 * plan.state_bytes_per_rank() == \
        3 * 4 * (cut // (2 * 2) + replicated // 2) + 3 * 4 * pad // 2
    assert plan.model_size == 2
