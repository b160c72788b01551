"""The compiled sharded steps of the port: ZeRO, FSDP and the pipelined
step through ``loop.make_scan_train_loop``, against their own eager steps
and against the JAX package's scanned sharded steps.

On the card a dispatch replays one CUDA graph of the step K times
(``chip_smoke.py`` phases 16, 19 and 22d hold it there). On the CPU a
dispatch runs the same K steps eagerly, so these tests hold what is the
same on both: each setup builds with ``steps_per_dispatch``, the loop
takes its step, cache and optimizer, and one dispatch is K eager calls of
the same step on the same cache draws.

In one process (a world of one): ZeRO at ``HOROVOD_MESH=1x1`` and the
pipelined step of a pp group of one, one dispatch of K = 2 against two
eager calls from a fresh setup; ``TuneStepFactory``'s mesh candidate
built with ``steps_per_dispatch``, graphed, against K eager steps of the
same setup; the refusals that stay (sharded + sp, FSDP with remat or the
chunked loss, the graphed loop under ``HOROVOD_ELASTIC=1``).

A 2-rank gloo world (tests/torch_port_sharded_worker.py, ``graph``):
- the trainer's ZeRO at 1x2 and FSDP on ``training_groups(1, 2)``, each
  one dispatch against two eager calls;
- two dispatches of K = 2 of the reference tests' MLP (``test_sharded``'s
  ``make_params``/``loss_fn``) in float64 through the port's
  ``DistributedOptimizer(sharded=True)`` at 1x2, against the JAX package's
  ``make_scan_train_loop`` over ``DistributedOptimizer(sharded=True)``
  under ``shard_map`` on ``grid_mesh(1, 2)``, built as
  ``tests/test_sharded.py`` builds its sharded steps; and of the FSDP step
  body of ``__graft_entry__._fsdp_step`` (as tests/test_torch_port_fsdp.py
  runs it) on both sides. The weights are the same float64 arrays on both
  sides (the MLP's leaves are products ``x @ w`` in both packages, so no
  layout converts between them). The JAX loop draws each step's rows from
  a table of the port's cache draws (``data.epoch_order``; the two
  packages' caches shuffle by different hashes).

Tolerances:
- graphed against eager, in the port: bit for bit (the same calls);
- the port against JAX, float64 on both sides (``jax.enable_x64``): every
  row element after each dispatch within 1e-12 x max(1, |ref|), the
  trajectory tolerance of tests/test_torch_port_sharded.py: the two sides
  sum the ranks' gradients and the rows' losses in other orders (~1e-16
  relative), which Adam carries over 4 steps into a few float64 ulps.
  Each dispatch's loss within 2^-22 x |ref|: the port's loop keeps its
  per-step losses in float32 (``ScanTrainLoop.losses``), each rounded once
  (2^-24) and their mean once more, where JAX's scan keeps float64.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd_tpu
import horovod_tpu_torch as hvd
import test_sharded as ref
from horovod_tpu.compat import shard_map
from horovod_tpu.parallel import fsdp as jfsdp
from horovod_tpu.parallel import sharded as jsh
from horovod_tpu_torch.data import epoch_order
from horovod_tpu_torch.loop import make_scan_train_loop
from test_torch_port_sharded import NAMES, TRAJ_TOL, _launch

SMALL = dict(vocab=64, dim=32, heads=2, layers=2, seq=16)
K, MB, ROWS, SEED, DISPATCHES = 2, 4, 8, 3, 2
LOSS_RTOL = 2.0 ** -22


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR", "HOROVOD_MESH",
              "HOROVOD_SHARD_PARAMS", "HOROVOD_COMPRESSION", "HOROVOD_ELASTIC"):
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    hvd.shutdown()


def _state(named) -> dict:
    return {n: t.detach().clone() for n, t in named}


def _assert_runs_equal(graph, eager):
    assert graph["losses"] == eager["losses"]
    assert graph["state"].keys() == eager["state"].keys()
    for n, t in eager["state"].items():
        assert graph["state"][n].dtype == t.dtype
        assert graph["state"][n].numpy().tobytes() == t.numpy().tobytes(), n


def _graph_and_eager(build):
    """One dispatch of the loop over ``build()``'s step, and K eager calls
    of a fresh ``build()``'s step on the same cache draws. ``build()``
    returns ``(step, cache, optimizer, state)``, ``state()`` the rows and
    parameters by name."""
    runs = {}
    for mode in ("graph", "eager"):
        step, cache, opt, state = build()
        if mode == "graph":
            loop = make_scan_train_loop(step, cache, K, optimizer=opt)
            mean = loop().item()
            losses = loop.losses.tolist()
            assert mean == pytest.approx(sum(losses) / K, rel=1e-6)
        else:
            ctr, losses = cache.counter(), []
            for _ in range(K):
                x, y, ctr = cache.sample(ctr)
                losses.append(step(x, y).item())
        assert len(losses) == K
        runs[mode] = {"losses": losses, "state": state()}
        hvd.shutdown()
    _assert_runs_equal(runs["graph"], runs["eager"])
    assert runs["graph"]["losses"][0] != runs["graph"]["losses"][1]
    return runs


def test_zero_1x1_dispatch_equals_eager_steps(world_of_one):
    from horovod_tpu_torch import train as T
    from horovod_tpu_torch.parallel import sharded as sh

    world_of_one.setenv("HOROVOD_MESH", "1x1")
    config = T.TrainConfig(**SMALL, sharded=True, steps_per_dispatch=K)

    def build():
        s = T.setup(config, "cpu")
        opt = s.opt
        assert opt.sharded and opt.layout.shard_size == 1

        def state():
            sh.gather_params(opt.rows, opt.shard_plan, opt.layout, opt.params)
            return {**_state((f"row{b}", r) for b, r in enumerate(opt.rows)),
                    **_state(s.model.named_parameters())}

        return s.step, T.make_cache(config, None, "cpu"), opt, state

    runs = _graph_and_eager(build)
    assert any(k.startswith("row") for k in runs["graph"]["state"])


def test_zero_graphed_train_runs_through_the_loop(world_of_one):
    """``train()`` of a sharded config with ``steps_per_dispatch``: one
    dispatch's mean loss, rank-averaged, per K steps."""
    from horovod_tpu_torch import train as T

    world_of_one.setenv("HOROVOD_MESH", "1x1")
    config = T.TrainConfig(**SMALL, sharded=True, steps_per_dispatch=K)
    result = T.train(config, 2 * K, device="cpu")
    flat = T.train(T.TrainConfig(**SMALL, steps_per_dispatch=K), 2 * K,
                   device="cpu")
    assert len(result.dispatch_losses) == 2 and not result.losses
    assert result.dispatch_losses == flat.dispatch_losses


@pytest.mark.parametrize("n_micro", [1, 2])
def test_pipeline_dispatch_equals_eager_steps(world_of_one, n_micro):
    from horovod_tpu_torch import train as T

    config = T.TrainConfig(**SMALL, batch=2, steps_per_dispatch=K)

    def build():
        s = T.setup_pipeline(config, 1, n_micro, "cpu")
        cache = T.make_cache(config, None, "cpu", s.layout.dp_rank)
        assert cache.batch == config.batch
        return s.step, cache, s.opt, lambda: _state(s.stage.named_parameters())

    _graph_and_eager(build)


def test_pipeline_cache_is_the_replicas_batch(world_of_one):
    """The pipeline's cache draws from (seed, dp index), as its eager
    batch: the rows are ``make_batch``'s for the dp index. The step reads
    the targets the cache draws: the rolled tokens give the default loss,
    other targets another one."""
    from horovod_tpu_torch import train as T

    config = T.TrainConfig(**SMALL, steps_per_dispatch=K)
    s = T.setup_pipeline(config, 1, 1, "cpu")
    cache = T.make_cache(config, None, "cpu", s.layout.dp_rank)
    want = T.make_batch(config, s.layout.dp_rank, "cpu", T.CACHE_ROWS)
    assert torch.equal(cache.data, want)
    assert torch.equal(T.make_cache(config, None, "cpu", 5).data,
                       T.make_batch(config, 5, "cpu", T.CACHE_ROWS))
    x, y, _ = cache.sample(cache.counter())
    state = _state(s.stage.named_parameters())
    losses = []
    for targets in (None, y, torch.zeros_like(y)):
        for name, p in s.stage.named_parameters():
            p.data.copy_(state[name])
        losses.append(s.step(x, targets).item())
    assert losses[0] == losses[1] != losses[2]


def test_tune_mesh_candidate_is_graphed(world_of_one):
    """A mesh candidate built with ``steps_per_dispatch`` records
    ``graphed: True`` and its first dispatch's losses are K eager steps of
    the same setup on the same draws; ``graphed=False`` keeps it eager."""
    from horovod_tpu_torch import autotune as at
    from horovod_tpu_torch.train import (TrainConfig, TuneStepFactory,
                                         make_cache, setup)
    from horovod_tpu_torch.parallel.mesh import sharded_groups

    config = TrainConfig(**SMALL, steps_per_dispatch=K)
    factory = TuneStepFactory(config, "cpu")
    at.tune(factory, thresholds=(1 << 12,), mesh_shapes=("1x1",), warmup=1,
            iters=1, reps=1, gp_rounds=0)
    factory.close()
    (record,) = factory.records
    assert record["mesh_shape"] == "1x1" and record["graphed"]
    s = setup(TrainConfig(**SMALL, sharded=True, steps_per_dispatch=K), "cpu",
              fusion_threshold=1 << 12, layout=sharded_groups(1, 1, 1))
    cache = make_cache(config, None, "cpu")
    ctr, want = cache.counter(), []
    for _ in range(K):
        x, y, ctr = cache.sample(ctr)
        want.append(s.step(x, y).item())
    assert record["losses"] == want
    eager = TuneStepFactory(config, "cpu", graphed=False)
    at.tune(eager, thresholds=(1 << 12,), mesh_shapes=("1x1",), warmup=1,
            iters=1, reps=1, gp_rounds=0)
    eager.close()
    assert not eager.records[0]["graphed"]


@pytest.mark.parametrize("case", ["zero_sp", "fsdp_remat", "fsdp_chunk",
                                  "fsdp_sp", "pipeline_sp", "elastic_loop"])
def test_refusals_that_stay(world_of_one, case):
    from horovod_tpu_torch import train as T

    config = T.TrainConfig(**SMALL, steps_per_dispatch=K)
    if case == "zero_sp":
        with pytest.raises(ValueError, match="does not combine with sp"):
            T.setup(T.TrainConfig(**SMALL, sharded=True, sp=1,
                                  steps_per_dispatch=K), "cpu")
    elif case.startswith("fsdp"):
        kw = {"fsdp_remat": dict(remat=True), "fsdp_chunk": dict(loss_chunk=8),
              "fsdp_sp": dict(sp=1)}[case]
        with pytest.raises(ValueError, match="plain step only"):
            T.setup_fsdp(T.TrainConfig(**SMALL, steps_per_dispatch=K, **kw),
                         device="cpu")
    elif case == "pipeline_sp":
        with pytest.raises(ValueError, match="plain step only"):
            T.setup_pipeline(T.TrainConfig(**SMALL, sp=1, steps_per_dispatch=K),
                             1, 1, "cpu")
    else:
        s = T.setup_fsdp(config, device="cpu")
        world_of_one.setenv("HOROVOD_ELASTIC", "1")
        with pytest.raises(ValueError, match="elastic reset"):
            make_scan_train_loop(s.step, T.make_cache(config, None, "cpu"), K,
                                 optimizer=s.optimizer)
        world_of_one.delenv("HOROVOD_ELASTIC")


# ------------------------------------------------------ the 2-rank world

class _Draws:
    """The JAX loop's cache: step ``c`` takes row block ``c`` of a table of
    the port's cache draws (every rank's, rank-major)."""

    def sample(self, ctr, data, labels):
        return data[ctr], labels[ctr], ctr + 1


def _port_draws(rows_per_rank: np.ndarray, steps: int) -> np.ndarray:
    """``(steps, ranks * MB, features)``: what each rank's ``DeviceCache``
    of ``ROWS`` rows (batch ``MB``, seed ``SEED``) draws at each step,
    concatenated in rank order."""
    per_epoch = ROWS // MB
    out = []
    for c in range(steps):
        perm = epoch_order(SEED, torch.tensor(c // per_epoch), ROWS).numpy()
        idx = perm[(c % per_epoch) * MB:(c % per_epoch + 1) * MB]
        out.append(np.concatenate([r[idx] for r in rows_per_rank]))
    return np.stack(out)


def _scan(train_step, params, opt_state, table):
    """DISPATCHES dispatches of the JAX package's ``make_scan_train_loop``
    over ``table``: each dispatch's mean loss and the parameters after it."""
    loop = hvd_tpu.jax.make_scan_train_loop(train_step, _Draws(), K, donate=False)
    ctr, labels = jnp.zeros((), jnp.int32), jnp.zeros(len(table), jnp.int32)
    out = []
    for _ in range(DISPATCHES):
        params, opt_state, ctr, loss = loop(params, opt_state, ctr, table, labels)
        out.append((float(loss), jax.tree_util.tree_map(np.asarray, params)))
    return out


def _jax_zero(params, table):
    """``DistributedOptimizer(sharded=True)`` at 1x2 under shard_map, as
    ``test_sharded._train`` builds it, its step scanned."""
    plan = jsh.build_shard_plan(params, 2, threshold=1 << 20, num_buckets=2)
    opt = hvd_tpu.jax.DistributedOptimizer(optax.adam(1e-2), sharded=True,
                                           shard_plan=plan)
    sp = jsh.shard_params(params, plan)
    st = opt.init(sp)
    specs = jsh.shard_specs(st)

    def body(sp, st, x, y):
        full = jsh.gather_params(sp, plan)
        loss, g = jax.value_and_grad(lambda p: ref.loss_fn(p, x, y))(full)
        upd, st = opt.update(g, st, sp)
        return optax.apply_updates(sp, upd), st, \
            jax.lax.pmean(loss, ("batch", "shard"))

    step = shard_map(body, mesh=ref.grid_mesh(1, 2),
                     in_specs=(P("shard"), specs, P(("batch", "shard")),
                               P(("batch", "shard"))),
                     out_specs=(P("shard"), specs, P()), check_vma=False)
    return _scan(lambda p, s, xy, _: step(p, s, xy[:, :16], xy[:, 16:]),
                 sp, st, table)


def _jax_fsdp(params, table):
    """The FSDP step body of ``__graft_entry__._fsdp_step`` (dp 1, fsdp 2,
    Adam lr 1e-3), as tests/test_torch_port_fsdp.py runs it, scanned."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("fsdp",))
    opt = optax.adam(1e-3)
    sharded, shapes = jfsdp.fsdp_shard_params(params, 2)
    st = opt.init(sharded)
    specs = jax.tree_util.tree_map(
        lambda l: P("fsdp") if getattr(l, "ndim", 0) > 0 else P(), st)

    def body(shards, st, x):
        def loss(shards):
            full = jfsdp.fsdp_gather_params(shards, shapes, "fsdp")
            return jnp.mean((jnp.tanh(x @ full["w"] + full["b"])) ** 2)

        value, grads = jax.value_and_grad(loss)(shards)
        grads = jax.tree_util.tree_map(lambda g: g / 2, grads)
        upd, st = opt.update(grads, st, shards)
        return optax.apply_updates(shards, upd), st, jax.lax.pmean(value, "fsdp")

    step = shard_map(body, mesh=mesh, in_specs=(P("fsdp"), specs, P("fsdp")),
                     out_specs=(P("fsdp"), specs, P()), check_vma=False)
    return _scan(lambda p, s, x, _: step(p, s, x), sharded, st, table)


@pytest.fixture(scope="module")
def graph_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graph_world")
    params = {k: np.asarray(v, np.float64) for k, v in ref.make_params().items()}
    x, y = (np.asarray(t, np.float64) for t in ref.make_data(2))
    mlp_rows = np.concatenate([x, y], axis=1).reshape(2, ROWS, -1)
    rng = np.random.default_rng(11)
    graft = {"w": rng.standard_normal((8, 8)) * 0.3, "b": np.zeros(8)}
    graft_rows = rng.standard_normal((2, ROWS, 8))
    inputs = {**{f"params/{k}": v for k, v in params.items()},
              "graft/w": graft["w"], "graft/b": graft["b"],
              "zero64/rows": mlp_rows, "fsdp64/rows": graft_rows,
              "k": np.array(K), "mb": np.array(MB), "seed": np.array(SEED),
              "config": np.array(json.dumps({**SMALL, "steps_per_dispatch": K}))}
    np.savez(tmp / "in.npz", **inputs)
    got = _launch(2, "graph", tmp / "in.npz", tmp / "out")
    steps = K * DISPATCHES
    with jax.enable_x64(True):
        want = {
            "zero64": _jax_zero({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(_port_draws(mlp_rows, steps))),
            "fsdp64": _jax_fsdp({k: jnp.asarray(v) for k, v in graft.items()},
                                jnp.asarray(_port_draws(graft_rows, steps)))}
    return inputs, want, got


@pytest.mark.parametrize("name", ["zero", "fsdp"])
def test_world_trainer_dispatch_equals_eager_steps(graph_world, name):
    _, _, got = graph_world
    for g in got:
        runs = {}
        for mode in ("graph", "eager"):
            keys = [k for k in g if k.startswith(f"{name}/{mode}/")]
            runs[mode] = {"losses": g[f"{name}/{mode}/losses"].tolist(),
                          "state": {k.split("/", 2)[2]: torch.from_numpy(g[k])
                                    for k in keys if not k.endswith("/losses")}}
        assert any(k.startswith("row/") for k in runs["graph"]["state"])
        assert len(runs["graph"]["losses"]) == K
        _assert_runs_equal(runs["graph"], runs["eager"])
    # Each rank draws its own rows: the two ranks' losses differ.
    assert got[0][f"{name}/graph/losses"].tolist() != \
        got[1][f"{name}/graph/losses"].tolist()


def _close(got, want, what):
    err = np.abs(got - want)
    assert (err <= TRAJ_TOL * np.maximum(1.0, np.abs(want))).all(), \
        (what, err.max())


def _close_loss(got, want, what):
    assert abs(float(got) - want) <= LOSS_RTOL * abs(want), (what, got, want)


def test_world_zero_1x2_matches_jax_scan(graph_world):
    inputs, want, got = graph_world
    for d, (loss, sp) in enumerate(want["zero64"]):
        sp = list(sp)
        for rank, g in enumerate(got):
            _close_loss(g[f"zero64/loss{d}"], loss, f"loss {d}")
            rows = [g[f"zero64/{d}/row{b}"] for b in range(len(sp))]
            for b, buf in enumerate(sp):
                _close(rows[b], buf[rank], f"dispatch {d} row {b} rank {rank}")
    first = list(want["zero64"][0][1])
    fresh = jsh.shard_params({k: jnp.asarray(inputs[f"params/{k}"])
                              for k in NAMES},
                             jsh.build_shard_plan(ref.make_params(), 2,
                                                  threshold=1 << 20,
                                                  num_buckets=2))
    assert not all(np.array_equal(a, np.asarray(b)) for a, b in zip(first, fresh)), \
        "no step taken"


def test_world_fsdp_matches_jax_scan(graph_world):
    inputs, want, got = graph_world
    for d, (loss, shards) in enumerate(want["fsdp64"]):
        for rank, g in enumerate(got):
            _close_loss(g[f"fsdp64/loss{d}"], loss, f"loss {d}")
            for k, buf in shards.items():
                _close(g[f"fsdp64/{d}/{k}"], buf[rank], f"dispatch {d} {k} rank {rank}")
                assert not np.array_equal(
                    buf[rank], inputs[f"graft/{k}"].reshape(2, -1)[rank]), "no step"
