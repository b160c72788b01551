"""The port's DistributedOptimizer on a 2-process gloo world against
``horovod_tpu.jax.DistributedOptimizer`` under shard_map on 2 virtual CPU
devices: the same initial parameters, the same per-rank batches, 3 Adam
steps, for wire dtypes none and bf16 and K = 1 and 3 buckets.

One world runs every configuration (one spawn for the module); each
configuration is its own test. Tolerances: with no wire cast both sides
reduce the same float32 gradients, so parameters agree to 1e-6 (float32
rounding in the two frameworks' gradients and Adam updates; measured
4e-7) and the per-step losses, computed from those parameters, to 1e-5
relative. With the bf16 wire both sides round the reduced gradient to
bf16 at the same places, but a float32 gradient near a bf16 rounding
boundary may round to the neighbour on one side only: a 2^-8 relative
change of one element's gradient moves its Adam step by up to about
2 * 2^-8 * lr per step, so parameters agree to 2.5e-4 (lr 1e-2, 3 steps)
and losses to 1e-4 relative.
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
from jax.sharding import Mesh, PartitionSpec as P

from launch_util import REPO, free_port

LR = 1e-2
STEPS = 3
THRESHOLD = 6000          # 3 greedy buckets: one below the 4096-byte floor
CONFIGS = [("none", 1), ("none", 3), ("bf16", 1), ("bf16", 3)]
BATCH, D_IN, D_HID, D_OUT = 8, 32, 64, 16


def _problem():
    rng = np.random.default_rng(42)
    params = {"b1": np.zeros(D_HID, np.float32),
              "b2": rng.standard_normal(D_OUT).astype(np.float32) * 0.1,
              "w1": rng.standard_normal((D_IN, D_HID)).astype(np.float32) * 0.3,
              "w2": rng.standard_normal((D_HID, D_OUT)).astype(np.float32) * 0.3}
    x = rng.standard_normal((2 * BATCH, D_IN)).astype(np.float32)
    y = rng.standard_normal((2 * BATCH, D_OUT)).astype(np.float32)
    return params, x, y


WORKER = r"""
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["HVD_REPO"])
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
rank = hvd.rank()
data = np.load(os.environ["PROBLEM"])
cfg = json.loads(os.environ["CONFIGS"])
sl = slice(rank * cfg["batch"], (rank + 1) * cfg["batch"])
x, y = torch.tensor(data["x"][sl]), torch.tensor(data["y"][sl])
out = {}
for wire, k in cfg["configs"]:
    named = [(n, torch.nn.Parameter(torch.tensor(data[n])))
             for n in ("b1", "b2", "w1", "w2")]
    p = dict(named)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam([t for _, t in named], lr=cfg["lr"]), named,
        compression=hvd.Compression.by_name(wire), num_buckets=k,
        fusion_threshold=cfg["threshold"])
    hvd.broadcast_parameters(named, root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    losses = []
    for _ in range(cfg["steps"]):
        opt.zero_grad()
        pred = torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        loss = ((pred - y) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(hvd.metric_average(loss.item()))
    out[f"{wire}-{k}"] = {"losses": losses, "buckets": opt.plan.num_buckets,
                          **{n: t.detach().numpy().tolist() for n, t in named}}
if rank == 0:
    with open(os.environ["RESULT"], "w") as f:
        json.dump(out, f)
hvd.shutdown()
"""


@pytest.fixture(scope="module")
def torch_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_port_opt")
    params, x, y = _problem()
    np.savez(tmp / "problem.npz", x=x, y=y, **params)
    port = free_port()
    configs = {"configs": CONFIGS, "lr": LR, "steps": STEPS,
               "threshold": THRESHOLD, "batch": BATCH}
    procs = []
    for rank in range(2):
        env = dict(os.environ, HVD_REPO=REPO, HOROVOD_RANK=str(rank),
                   HOROVOD_SIZE="2", HOROVOD_LOCAL_RANK=str(rank),
                   HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}",
                   PROBLEM=str(tmp / "problem.npz"), RESULT=str(tmp / "out.json"),
                   CONFIGS=json.dumps(configs), OMP_NUM_THREADS="1")
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
            env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    errors = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(err[-3000:])
    assert not errors, errors
    with open(tmp / "out.json") as f:
        return json.load(f)


def _jax_trajectory(wire, k):
    import horovod_tpu as hvd_tpu
    from horovod_tpu.compat import shard_map

    params, x, y = _problem()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("hvd",))
    opt = hvd_tpu.jax.DistributedOptimizer(
        optax.adam(LR), compression=hvd_tpu.Compression.by_name(wire),
        num_buckets=k, fusion_threshold=THRESHOLD)

    def loss_fn(p, x, y):
        pred = jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        return jnp.mean((pred - y) ** 2)

    def step(p, s, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, jax.lax.pmean(loss, "hvd")

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(P(), P(), P("hvd"), P("hvd")),
                           out_specs=(P(), P(), P()), check_vma=False))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = opt.init(p)
    losses = []
    with jax.default_matmul_precision("highest"):
        for _ in range(STEPS):
            p, s, loss = fn(p, s, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("wire,k", CONFIGS)
def test_trajectory_matches_jax(torch_world, wire, k):
    got = torch_world[f"{wire}-{k}"]
    losses, params = _jax_trajectory(wire, k)
    from horovod_tpu.parallel.fusion import build_plan

    atol, loss_rtol = (1e-6, 1e-5) if wire == "none" else (2.5e-4, 1e-4)
    np.testing.assert_allclose(got["losses"], losses, rtol=loss_rtol)
    for name, want in params.items():
        np.testing.assert_allclose(np.asarray(got[name], np.float32), want,
                                   atol=atol, rtol=0, err_msg=name)
    assert got["buckets"] == build_plan(_problem()[0], THRESHOLD,
                                        num_buckets=k).num_buckets


def test_bf16_wire_changes_the_result(torch_world):
    """The bf16 wire really ran: its trajectory differs from full width."""
    a, b = torch_world["none-1"], torch_world["bf16-1"]
    assert any(x != y for x, y in zip(np.ravel(a["w1"]), np.ravel(b["w1"])))
