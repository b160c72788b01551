"""FSDP (ZeRO-3, one leaf at a time) of the port against the JAX package.

In one process: ``fsdp_shard_params`` rows against the JAX ``(N, chunk)``
rows and the round trip through ``fsdp_unshard_params``; the per-rank
bytes; ``fsdp_mask_`` against ``fsdp_mask_updates``; the gather's
backward in a world of one.

A 4-rank gloo world (tests/torch_port_sharded_worker.py, ``fsdp``): the
body of ``__graft_entry__._fsdp_step`` over 3 steps on
``training_groups(1, 4)`` and of ``_dp_fsdp_step`` on ``training_groups(2,
2)``, against the same bodies under shard_map on the virtual CPU mesh,
from the same weights and inputs; the layout against
``training_mesh(dp=2, fsdp=2).devices``; the pad tail under an inner
optimizer that adds seeded noise to every element.

Tolerances: rows, layouts, masks and the world-of-one gather: exact. The
steps run in float64 on both sides (``jax.enable_x64``): |err| <= 1e-12 x
max(1, |ref|). The sides sum the ranks' gradients in other orders (~1e-16
relative), which Adam at lr 1e-3 carries over 3 steps into a few float64
ulps of the parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
import test_fsdp as ref
from horovod_tpu.compat import shard_map
from horovod_tpu.parallel import fsdp as jfsdp
from horovod_tpu.parallel.mesh import training_mesh
from horovod_tpu_torch.parallel import fsdp
from test_torch_port_sharded import _launch

N = 4
STEP_TOL = 1e-12
MLP = ("b1", "w1", "w2")


def _mlp():
    return {k: np.asarray(v) for k, v in ref.make_params().items()}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_rows_and_round_trip_match_jax(n):
    params = _mlp()
    jrows, _ = jfsdp.fsdp_shard_params(ref.make_params(), n)
    every = [fsdp.fsdp_shard_params({k: torch.tensor(v) for k, v in params.items()},
                                    n, r) for r in range(n)]
    for r, (rows, shapes) in enumerate(every):
        assert shapes == {k: v.shape for k, v in params.items()}
        for k, row in rows.items():
            assert isinstance(row, torch.nn.Parameter)
            np.testing.assert_array_equal(row.detach().numpy(), np.asarray(jrows[k])[r])
    back = fsdp.fsdp_unshard_params([rows for rows, _ in every], every[0][1])
    for k, v in params.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_per_rank_bytes_are_a_quarter_plus_pad():
    params = {k: torch.tensor(v) for k, v in _mlp().items()}
    total = sum(v.numel() for v in params.values())
    for r in range(N):
        rows, _ = fsdp.fsdp_shard_params(params, N, r)
        per_rank = sum(row.numel() for row in rows.values())
        assert total / N <= per_rank < total / N + len(params)
        assert per_rank == sum(-(-v.numel() // N) for v in params.values())


def test_mask_matches_jax_mask():
    params = _mlp()
    _, shapes = jfsdp.fsdp_shard_params(ref.make_params(), N)
    ones = {k: jnp.ones((N, -(-v.size // N))) for k, v in params.items()}
    fn = jax.jit(shard_map(lambda u: jfsdp.fsdp_mask_updates(u, shapes, "fsdp"),
                           mesh=Mesh(np.asarray(jax.devices()[:N]), ("fsdp",)),
                           in_specs=P("fsdp"), out_specs=P("fsdp"),
                           check_vma=False))
    want = jax.tree_util.tree_map(np.asarray, fn(ones))
    for r in range(N):
        rows = {k: torch.nn.Parameter(torch.ones(-(-v.size // N)))
                for k, v in params.items()}
        fsdp.fsdp_mask_(rows, {k: v.shape for k, v in params.items()}, r)
        for k, row in rows.items():
            np.testing.assert_array_equal(row.detach().numpy(), want[k][r])


def test_gather_and_its_backward_in_a_world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    try:
        params = {k: torch.tensor(v) for k, v in _mlp().items()}
        rows, shapes = fsdp.fsdp_shard_params(params, 1, 0)
        full = fsdp.fsdp_gather_params(rows, shapes, hvd.training_groups(1, 1).fsdp_group)
        for k, v in params.items():
            assert torch.equal(full[k], v)
        weights = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
                   for k, v in params.items()}
        sum((full[k] * weights[k]).sum() for k in full).backward()
        for k, row in rows.items():
            assert torch.equal(row.grad, weights[k].reshape(-1))
    finally:
        hvd.shutdown()


# ------------------------------------------------------ the 4-rank world

def _jax_steps(params, x, dp, fs, steps=3):
    """The graft bodies: ``_fsdp_step``'s with dp = 1, ``_dp_fsdp_step``'s
    with dp = 2, ``steps`` steps in float64; the unsharded parameters."""
    if dp == 1:
        mesh, x_spec = Mesh(np.asarray(jax.devices()[:fs]), ("fsdp",)), P("fsdp")
    else:
        mesh = training_mesh(dp=dp, fsdp=fs, devices=jax.devices()[:dp * fs])
        x_spec = P(("dp", "fsdp"))
    opt = optax.adam(1e-3)
    sharded, shapes = jfsdp.fsdp_shard_params(params, fs)
    opt_state = opt.init(sharded)
    state_specs = jax.tree_util.tree_map(
        lambda l: P("fsdp") if getattr(l, "ndim", 0) > 0 else P(), opt_state)

    def step(shards, opt_state, x):
        def loss(shards):
            full = jfsdp.fsdp_gather_params(shards, shapes, "fsdp")
            return jnp.mean((jnp.tanh(x @ full["w"] + full["b"])) ** 2)

        grads = jax.grad(loss)(shards)
        if dp == 1:
            grads = jax.tree_util.tree_map(lambda g: g / fs, grads)
        else:
            grads = jax.tree_util.tree_map(
                lambda g: jax.lax.psum(g, "dp") / (dp * fs), grads)
        upd, opt_state = opt.update(grads, opt_state, shards)
        return optax.apply_updates(shards, upd), opt_state

    run = jax.jit(shard_map(step, mesh=mesh,
                            in_specs=(P("fsdp"), state_specs, x_spec),
                            out_specs=(P("fsdp"), state_specs), check_vma=False))
    for _ in range(steps):
        sharded, opt_state = run(sharded, opt_state, x)
    return {k: np.asarray(v) for k, v in jfsdp.fsdp_unshard_params(sharded, shapes).items()}


@pytest.fixture(scope="module")
def fsdp_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_world")
    graft = {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 8)) * 0.3,
                             np.float64),
             "b": np.zeros(8)}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2 * N, 8)), np.float64)
    mlp = _mlp()
    tx = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (ref.BATCH * N, ref.DIM_IN)))
    ty = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (ref.BATCH * N, ref.DIM_OUT)))
    inputs = {"graft/w": graft["w"], "graft/b": graft["b"],
              "graft/x": x.reshape(N, 2, 8),
              **{f"tail/{k}": v for k, v in mlp.items()},
              "tail/x": tx.reshape(N, ref.BATCH, -1), "tail/y": ty.reshape(N, ref.BATCH, -1)}
    np.savez(tmp / "in.npz", **inputs)
    got = _launch(N, "fsdp", tmp / "in.npz", tmp / "out")
    want = {}
    with jax.enable_x64(True):
        jparams = {k: jnp.asarray(v) for k, v in graft.items()}
        want["fsdp"] = _jax_steps(jparams, jnp.asarray(x), 1, N)
        want["dp_fsdp"] = _jax_steps(jparams, jnp.asarray(x), 2, 2)
    want["mesh"] = np.vectorize(lambda d: d.id)(
        training_mesh(dp=2, fsdp=2, devices=jax.devices()[:N]).devices).reshape(2, 2)
    return inputs, want, got


@pytest.mark.parametrize("name,fs", [("fsdp", N), ("dp_fsdp", 2)])
def test_world_matches_the_jax_step_body(fsdp_world, name, fs):
    inputs, want, got = fsdp_world
    shapes = {k: inputs[f"graft/{k}"].shape for k in ("w", "b")}
    # The fsdp group of rank r is its row of the layout; with dp = 2 both
    # dp rows must hold the same rows.
    groups = [got[d * fs:(d + 1) * fs] for d in range(N // fs)]
    for group in groups:
        rows = [{k: torch.from_numpy(g[f"{name}/row/{k}"]) for k in shapes}
                for g in group]
        full = fsdp.fsdp_unshard_params(rows, shapes)
        for k, ref_ in want[name].items():
            err = np.abs(full[k].numpy() - ref_)
            assert (err <= STEP_TOL * np.maximum(1.0, np.abs(ref_))).all(), (k, err.max())
            assert not np.array_equal(ref_, inputs[f"graft/{k}"]), "no step taken"


def test_world_layout_matches_training_mesh(fsdp_world):
    _, want, got = fsdp_world
    ids = want["mesh"]
    for rank, g in enumerate(got):
        d, f = rank // 2, rank % 2
        layout = g["dp_fsdp/layout"].tolist()
        assert layout == [*ids[:, f].tolist(), -1, *ids[d, :].tolist()]
        assert g["fsdp/layout"].tolist() == [rank, -1, 0, 1, 2, 3]


def test_world_pad_tail_stays_zero_with_the_mask(fsdp_world):
    inputs, _, got = fsdp_world
    shapes = {k: inputs[f"tail/{k}"].shape for k in MLP}
    drifted = False
    for rank, g in enumerate(got):
        for k in MLP:
            size = int(np.prod(shapes[k]))
            chunk = g[f"tail/masked/{k}"].size
            valid = min(max(size - rank * chunk, 0), chunk)
            assert not g[f"tail/masked/{k}"][valid:].any(), (rank, k)
            drifted |= bool(g[f"tail/unmasked/{k}"][valid:].any())
            np.testing.assert_array_equal(g[f"tail/masked/{k}"][:valid],
                                          g[f"tail/unmasked/{k}"][:valid])
    assert drifted, "control broken: unmasked noise did not move the tail"
