"""Sequence parallelism of the port on the CPU against the JAX package.

- Each ring kernel, one ring step: the port's plain version of B4, B5, B6
  (``rf_fwd``, ``rf_bwd_dq``, ``rf_bwd_dkv`` on CPU tensors) against the
  Pallas kernel of ``horovod_tpu.ops.ring_flash`` in interpret mode, with
  small blocks (several tiles, some skipped), nonzero carries and zigzag
  positions. The JAX side takes m/l/lse/delta as (R, 8, T) and positions as
  (8, T) / (T, 128); row 0 of each is compared.
- The zigzag layout helpers equal the JAX ones exactly.
- A 4-rank gloo world (tests/torch_port_ring_worker.py) against the JAX
  package on a 4-device virtual mesh: ring_flash_attention (contiguous,
  zigzag, GQA 4 over 2) and the dense ring_attention, output and
  gradients; the sequence-parallel flash TransformerLM's logits; one
  dp=2 × sp=2 training step.

Tolerances, float32 on both sides with JAX at highest matmul precision:
the JAX ring-flash suite's own, 2e-5 (atol and rtol) for outputs and
carries and 3e-5 for gradients; logits 1e-4 as its sp-flash model test;
the training step as tests/test_torch_port_train.py holds it (loss 1e-5
relative; every parameter element within lr of JAX's, all but 0.1% of
each tensor within 2e-6: Adam's step lr * m / (sqrt(v) + eps) moves by up
to lr where a gradient is within float32 noise of zero).
"""

import dataclasses
import importlib
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

from horovod_tpu.compat import shard_map
from horovod_tpu_torch import convert
from horovod_tpu_torch import train as port_train
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import ring_attention as ra
from horovod_tpu_torch.ops import ring_flash as rf
from launch_util import REPO, free_port

# The modules (horovod_tpu.ops re-exports functions of the same names).
jra = importlib.import_module("horovod_tpu.ops.ring_attention")
jrf = importlib.import_module("horovod_tpu.ops.ring_flash")

FWD_TOL, GRAD_TOL, LOGITS_TOL = 2e-5, 3e-5, 1e-4
WORKER = os.path.join(REPO, "tests", "torch_port_ring_worker.py")
N = 4

# ------------------------------------------------------- one ring step each

STEP_CASES = {
    # name: (my rank, source rank of the K/V block, zigzag)
    "zigzag_partial": (1, 2, True),     # q low stripe sees none, high all
    "zigzag_diagonal": (2, 2, True),
    "contiguous_diagonal": (1, 1, False),
    "contiguous_past": (2, 0, False),   # every pair live
}
B, TL, H, HKV, D, BQ, BK = 1, 32, 4, 2, 16, 8, 8


def _step_inputs(seed, my, src, zigzag):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    r, rkv = B * H, B * HKV
    x = dict(q=normal(r, TL, D), k=normal(rkv, TL, D), v=normal(rkv, TL, D),
             do=normal(r, TL, D), acc=normal(r, TL, D), m=normal(r, TL),
             l=rng.uniform(0.5, 2.0, (r, TL)).astype(np.float32),
             lse=rng.uniform(1.0, 3.0, (r, TL)).astype(np.float32),
             delta=normal(r, TL), dq=normal(r, TL, D), dk=normal(rkv, TL, D),
             dv=normal(rkv, TL, D))
    x["qpos"] = np.asarray(jrf._positions(my, TL, N, zigzag), np.int32)
    x["kpos"] = np.asarray(jrf._positions(src, TL, N, zigzag), np.int32)
    return x


def _rows8(a):
    return jnp.broadcast_to(jnp.asarray(a)[:, None, :], (a.shape[0], 8, a.shape[1]))


def _jax_step(x):
    """The three Pallas kernels of one ring step, in interpret mode."""
    j = {k: jnp.asarray(v) for k, v in x.items()}
    qpos, kpos = jrf._qpos_arr(j["qpos"], TL), jrf._kpos_arr(j["kpos"], TL)
    lse, delta = _rows8(x["lse"]), _rows8(x["delta"])
    group = H // HKV
    with jax.default_matmul_precision("highest"):
        acc, m, l = jrf._fwd_block_call(
            j["q"], j["k"], j["v"], j["acc"], _rows8(x["m"]), _rows8(x["l"]),
            qpos, kpos, BQ, BK, H, HKV, group, True)
        dq = jrf._dq_block_call(j["q"], j["k"], j["v"], j["do"], lse, delta,
                                qpos, kpos, j["dq"], BQ, BK, H, HKV, group, True)
        dk, dv = jrf._dkv_block_call(j["q"], j["k"], j["v"], j["do"], lse,
                                     delta, qpos, kpos, j["dk"], j["dv"], BQ,
                                     BK, H, HKV, group, True)
    return {"acc": acc, "m": m[:, 0], "l": l[:, 0], "dq": dq, "dk": dk, "dv": dv}


def _port_step(x):
    t = {k: torch.tensor(v) for k, v in x.items()}
    rf.rf_fwd(t["q"], t["k"], t["v"], t["acc"], t["m"], t["l"], t["qpos"],
              t["kpos"], H, HKV)
    rf.rf_bwd_dq(t["q"], t["k"], t["v"], t["do"], t["lse"], t["delta"],
                 t["qpos"], t["kpos"], t["dq"], H, HKV)
    rf.rf_bwd_dkv(t["q"], t["k"], t["v"], t["do"], t["lse"], t["delta"],
                  t["qpos"], t["kpos"], t["dk"], t["dv"], H, HKV)
    return t


@pytest.fixture(scope="module")
def step_results():
    out = {}
    for i, (case, (my, src, zigzag)) in enumerate(sorted(STEP_CASES.items())):
        x = _step_inputs(i, my, src, zigzag)
        out[case] = (_jax_step(x), _port_step(x))
    return out


@pytest.mark.parametrize("kernel,carries", [("ring_flash_fwd", ("acc", "m", "l")),
                                            ("ring_flash_bwd_dq", ("dq",)),
                                            ("ring_flash_bwd_dkv", ("dk", "dv"))])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_ring_step_matches_pallas(step_results, case, kernel, carries):
    want, got = step_results[case]
    tol = FWD_TOL if kernel == "ring_flash_fwd" else GRAD_TOL
    for name in carries:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=tol, rtol=tol, err_msg=f"{case} {name}")


def test_step_cases_skip_tiles_and_carry():
    """The cases reach what they are meant to: a q tile with no live key
    in the partial zigzag step, every pair live in the past step."""
    x = _step_inputs(0, *STEP_CASES["zigzag_partial"])
    live = x["qpos"][:, None] >= x["kpos"][None, :]
    assert not live[:BQ].any() and live[-BQ:].all()
    x = _step_inputs(0, *STEP_CASES["contiguous_past"])
    assert (x["qpos"][:, None] >= x["kpos"][None, :]).all()


def test_fully_masked_step_changes_nothing():
    x = _step_inputs(5, 0, 3, False)
    assert ra.fully_masked(0, 3, TL, N, False)
    t = _port_step(x)
    for name in ("acc", "m", "l", "dq", "dk", "dv"):
        np.testing.assert_array_equal(t[name].numpy(), x[name], err_msg=name)


def test_cpu_path_launches_no_kernel():
    rf.reset_launches()
    _port_step(_step_inputs(0, 1, 1, False))
    assert rf.launches == {"ring_flash_fwd": 0, "ring_flash_bwd_dq": 0,
                           "ring_flash_bwd_dkv": 0}


# -------------------------------------------------------------- the layout

@pytest.mark.parametrize("n,t_local", [(4, 8), (2, 12), (1, 6)])
def test_zigzag_helpers_equal_jax(n, t_local):
    for rank in range(n):
        np.testing.assert_array_equal(
            ra.zigzag_positions(rank, t_local, n).numpy(),
            np.asarray(jra.zigzag_positions(rank, t_local, n)))
        lo, hi = ra.position_range(rank, t_local, n, True)
        assert (lo, hi) == (int(ra.zigzag_positions(rank, t_local, n).min()),
                            int(ra.zigzag_positions(rank, t_local, n).max()))
    assert ra._zigzag_order(n * t_local, n) == jra._zigzag_order(n * t_local, n)
    x = np.arange(2 * n * t_local * 3).reshape(2, n * t_local, 3)
    shard = ra.zigzag_shard(torch.tensor(x), n)
    np.testing.assert_array_equal(shard.numpy(), np.asarray(jra.zigzag_shard(x, n)))
    np.testing.assert_array_equal(ra.zigzag_unshard(shard, n).numpy(), x)
    with pytest.raises(ValueError, match="even"):
        ra.zigzag_positions(0, 5, n)


def test_ring_of_one_is_flash_attention():
    """group=None, a ring of one: ring_flash_attention and ring_attention
    equal the dense reference, forward and gradients."""
    rng = np.random.default_rng(7)
    q, k, v, w = (torch.tensor(rng.standard_normal(s, dtype=np.float32))
                  for s in [(2, 96, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32), (2, 96, 4, 32)])
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves)
    (ref * w).sum().backward()
    for fn in (rf.ring_flash_attention, ra.ring_attention):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        (out * w).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                                   atol=FWD_TOL, rtol=FWD_TOL)
        for a, r in zip(leaves, ref_leaves):
            np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(),
                                       atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.fixture()
def cpu_world(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        monkeypatch.delenv(k, raising=False)
    yield
    port_train.basics.shutdown()


def test_train_sp1_is_the_ring_path(cpu_world):
    """TrainConfig(sp=1) trains through the ring of one: the same first
    loss as slice 1's path (same weights, same batch), then falling."""
    small = dict(vocab=128, dim=64, heads=2, layers=2, seq=64, dtype="float32")
    rf.reset_launches()
    ring = port_train.train(port_train.TrainConfig(**small, sp=1), 3, device="cpu")
    plain = port_train.train(port_train.TrainConfig(**small), 1, device="cpu")
    np.testing.assert_allclose(ring.losses[0], plain.losses[0], rtol=1e-5)
    assert all(np.isfinite(ring.losses)) and ring.losses[-1] < ring.losses[0]
    assert ring.tokens_per_step == 64
    assert sum(rf.launches.values()) == 0


def test_sp_must_divide_the_world_and_the_sequence(cpu_world):
    from horovod_tpu_torch.parallel.mesh import dp_sp_groups

    port_train.basics.init("cpu")
    with pytest.raises(ValueError, match="divide the world"):
        dp_sp_groups(2)
    ring_of_two = dataclasses.replace(dp_sp_groups(1), sp_size=2)
    with pytest.raises(ValueError, match="not divisible by sp"):
        port_train.make_shard(port_train.TrainConfig(seq=9), ring_of_two, "cpu")


# ------------------------------------------------------ the 4-rank world

ATTENTION_CASES = {
    # name: (kind, zigzag, (B, T, H, Hkv, D)); the worker runs the port's
    # ring_flash_attention ("flash") or ring_attention ("dense")
    "flash_contiguous": ("flash", False, (2, 64, 2, 2, 16)),
    "flash_zigzag": ("flash", True, (1, 64, 2, 2, 16)),
    "flash_gqa": ("flash", False, (1, 64, 4, 2, 16)),
    "dense_contiguous": ("dense", False, (1, 64, 4, 2, 16)),
    "dense_zigzag": ("dense", True, (1, 64, 2, 2, 16)),
}
JAX_ATTENTION = {"flash": jrf.ring_flash_attention, "dense": jra.ring_attention}
MODEL = dict(vocab=64, dim=32, heads=4, layers=2)
TRAIN = dict(vocab=64, dim=32, heads=4, layers=2, seq=32, batch=1, lr=1e-3,
             dtype="float32", attention="flash", sp=2, seed=3)


def _flatten(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    return out


def _jax_attention(mesh, case, q, k, v, w):
    kind, zigzag, _ = ATTENTION_CASES[case]
    fn = JAX_ATTENTION[kind]
    if zigzag:
        q, k, v, w = (jra.zigzag_shard(x, N) for x in (q, k, v, w))
    ring = shard_map(lambda a, b, c: fn(a, b, c, "sp", zigzag), mesh=mesh,
                     in_specs=P(None, "sp"), out_specs=P(None, "sp"),
                     check_vma=False)

    def both(a, b, c):
        out, vjp = jax.vjp(ring, a, b, c)
        return (out, *vjp(w))

    with jax.default_matmul_precision("highest"):
        res = jax.jit(both)(q, k, v)
    if zigzag:
        res = [jra.zigzag_unshard(x, N) for x in res]
    return [np.asarray(x) for x in res]


def _jax_train_step(params, tokens):
    """The dp×sp step of __graft_entry__._transformer_dp_sp_step, dense
    ring attention, float32: (loss averaged over dp and sp, new params)."""
    import horovod_tpu as hvd_tpu
    from horovod_tpu.models import TransformerLM as JaxLM

    model = JaxLM(**MODEL, dtype=jnp.float32, sp_axis="sp")
    opt = hvd_tpu.jax.DistributedOptimizer(optax.adam(TRAIN["lr"]),
                                           axis_name=("dp", "sp"))

    def loss_fn(p, tok):
        t_local = tok.shape[1]
        positions = (jax.lax.axis_index("sp") * t_local + jnp.arange(t_local))[None, :]
        logits = model.apply({"params": p}, tok, positions)
        targets = jnp.roll(tok, -1, axis=1)
        return optax.softmax_cross_entropy_with_integer_labels(logits, targets).mean()

    def step(p, s, tok):
        loss, grads = jax.value_and_grad(loss_fn)(p, tok)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), jax.lax.pmean(loss, ("dp", "sp"))

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(P(), P(), P("dp", "sp")),
                           out_specs=(P(), P()), check_vma=False))
    with jax.default_matmul_precision("highest"):
        new, loss = fn(params, opt.init(params), jnp.asarray(tokens))
    return float(loss), new


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX side, then the port's 4-rank gloo world on the same inputs;
    returns (JAX results, per-rank port results)."""
    from horovod_tpu.models import TransformerLM as JaxLM

    tmp = tmp_path_factory.mktemp("ring_world")
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("sp",))
    rng = np.random.default_rng(11)
    inputs, want = {}, {}
    for case, (_, _, (b, t, h, hkv, d)) in ATTENTION_CASES.items():
        x = [rng.standard_normal(s, dtype=np.float32)
             for s in [(b, t, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, t, h, d)]]
        inputs.update({f"{case}_{n}": a for n, a in zip("qkvw", x)})
        want[case] = _jax_attention(mesh, case, *x)

    dense = JaxLM(**MODEL, dtype=jnp.float32)
    tokens = rng.integers(0, MODEL["vocab"], (2, 32)).astype(np.int32)
    params = dense.init(jax.random.PRNGKey(0), tokens)["params"]
    with jax.default_matmul_precision("highest"):
        want["model_logits"] = np.asarray(dense.apply({"params": params}, tokens))
    inputs["attention_cases"] = np.array(json.dumps(
        {case: [kind, zigzag] for case, (kind, zigzag, _) in ATTENTION_CASES.items()}))
    inputs.update(_flatten(params, "model_params"), model_tokens=tokens,
                  model_config=np.array(json.dumps(MODEL)))

    config = port_train.TrainConfig(**TRAIN)
    batches = np.concatenate([port_train.make_batch(config, i, "cpu").numpy()
                              for i in range(2)]).astype(np.int32)
    train_params = JaxLM(**MODEL, dtype=jnp.float32).init(
        jax.random.PRNGKey(2), batches[:1, :16])["params"]
    want["train_loss"], want["train_params"] = _jax_train_step(train_params, batches)
    inputs.update(_flatten(train_params, "train_params"),
                  train_config=np.array(json.dumps(TRAIN)))

    np.savez(tmp / "in.npz", **inputs)
    port = free_port()
    procs = []
    for rank in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(N),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", RING_DEVICE="cpu",
                   RING_IN=str(tmp / "in.npz"), RING_OUT=str(tmp / "out"),
                   OMP_NUM_THREADS="1")
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
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
    return want, got


def _gather(got, key, zigzag=False, axis=1):
    full = np.concatenate([g[key] for g in got], axis=axis)
    return ra.zigzag_unshard(torch.tensor(full), N).numpy() if zigzag else full


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_ring_world_matches_jax(world, case):
    want, got = world
    zigzag = ATTENTION_CASES[case][1]
    out, dq, dk, dv = want[case]
    np.testing.assert_allclose(_gather(got, f"{case}_out", zigzag), out,
                               atol=FWD_TOL, rtol=FWD_TOL)
    for name, ref in zip(("dq", "dk", "dv"), (dq, dk, dv)):
        np.testing.assert_allclose(_gather(got, f"{case}_{name}", zigzag), ref,
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def test_sp_flash_model_matches_jax_dense(world):
    want, got = world
    np.testing.assert_allclose(_gather(got, "model_logits"), want["model_logits"],
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_dp_sp_train_step_matches_jax(world):
    want, got = world
    for g in got:
        np.testing.assert_allclose(float(g["train_loss"]), want["train_loss"],
                                   rtol=1e-5)
    for key in got[0]:
        if not key.startswith("train_param/"):
            continue
        name = key.split("/", 1)[1]
        ref = np.asarray(convert._lookup(want["train_params"], convert.flax_path(name)))
        for g in got:
            np.testing.assert_array_equal(g[key], got[0][key], err_msg=name)
        diff = np.abs(got[0][key] - ref)
        assert diff.max() <= TRAIN["lr"], (name, diff.max())
        assert np.mean(diff > 2e-6) <= 1e-3, (name, np.sort(diff.ravel())[-5:])
