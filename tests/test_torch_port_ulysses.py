"""Ulysses attention of the port against the JAX package.

A 4-rank gloo world (tests/torch_port_ulysses_worker.py) against
``horovod_tpu.ops.ring_attention.ulysses_attention`` on a 4-device ``sp``
virtual mesh, on the shapes of tests/test_ring_attention.py: dense and
flash (the Pallas kernel in interpret mode on the JAX side, the plain
versions of B1-B3 on the port's), MHA and GQA (8 q heads over 4 kv
heads), the output and the gradients of sum(out * w); and the three inputs
the reference rejects, with the same errors. In one process: a group of
one (None) is ``flash_attention`` and the dense reference, bit for bit and
to the same limits.

Tolerances, float32 on both sides with JAX at highest matmul precision:
those tests/test_torch_port_flash.py holds B1-B3's plain versions to (the
JAX flash suite's own), 2e-6 (atol and rtol) for the output and 5e-6 for
the gradients. The all-to-alls move data and add nothing to it.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.ops.ring_attention import ulysses_attention as jax_ulysses
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import ring_attention as ra
from launch_util import REPO, free_port

FWD_TOL, GRAD_TOL = 2e-6, 5e-6
WORKER = os.path.join(REPO, "tests", "torch_port_ulysses_worker.py")
N = 4
CASES = {
    # name: (impl, (B, T, H, Hkv, D)), as tests/test_ring_attention.py
    "dense_mha": ("dense", (2, 64, 8, 8, 16)),
    "flash_mha": ("flash", (2, 64, 8, 8, 16)),
    "dense_gqa": ("dense", (2, 64, 8, 4, 16)),
    "flash_gqa": ("flash", (2, 128, 8, 4, 16)),
}
REJECTIONS = {
    # name: (q heads, kv heads, impl, the JAX error's words)
    "bad_heads": (6, 6, "dense", "not divisible"),
    "bad_gqa": (8, 2, "dense", "GQA kv heads"),
    "bad_impl": (8, 8, "bogus", "unknown impl"),
}


def _inputs(rng, b, t, h, hkv, d):
    return [rng.standard_normal(s, dtype=np.float32)
            for s in [(b, t, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, t, h, d)]]


def _jax_ulysses(mesh, impl, q, k, v, w):
    uly = shard_map(lambda a, b, c: jax_ulysses(a, b, c, "sp", impl=impl), mesh=mesh,
                    in_specs=P(None, "sp"), out_specs=P(None, "sp"), check_vma=False)

    def both(a, b, c):
        out, vjp = jax.vjp(uly, a, b, c)
        return (out, *vjp(w))

    with jax.default_matmul_precision("highest"):
        return [np.asarray(x) for x in jax.jit(both)(q, k, v)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX side, then the port's 4-rank gloo world on the same inputs;
    returns (JAX results, JAX rejections, per-rank port results)."""
    tmp = tmp_path_factory.mktemp("ulysses_world")
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("sp",))
    rng = np.random.default_rng(17)
    inputs, want = {}, {}
    for case, (impl, shape) in CASES.items():
        x = _inputs(rng, *shape)
        inputs.update({f"{case}_{n}": a for n, a in zip("qkvw", x)})
        want[case] = _jax_ulysses(mesh, impl, *x)
    raised = {}
    for case, (h, hkv, impl, _) in REJECTIONS.items():
        q, k, _, _ = _inputs(rng, 1, 16, h, hkv, 8)
        inputs.update({f"{case}_q": q, f"{case}_k": k,
                       f"{case}_impl": np.array(impl)})
        with pytest.raises(ValueError) as e:
            _jax_ulysses(mesh, impl, q, k, k, q)
        raised[case] = str(e.value)
    inputs["cases"] = np.array(json.dumps({c: impl for c, (impl, _) in CASES.items()}))
    np.savez(tmp / "in.npz", **inputs)
    port = free_port()
    procs = []
    for rank in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(N),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", ULY_DEVICE="cpu",
                   ULY_IN=str(tmp / "in.npz"), ULY_OUT=str(tmp / "out"),
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
    return want, raised, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_world_matches_jax(world, case):
    want, _, got = world
    out, dq, dk, dv = want[case]
    np.testing.assert_allclose(np.concatenate([g[f"{case}_out"] for g in got], 1),
                               out, atol=FWD_TOL, rtol=FWD_TOL)
    for name, ref in zip(("dq", "dk", "dv"), (dq, dk, dv)):
        np.testing.assert_allclose(
            np.concatenate([g[f"{case}_{name}"] for g in got], 1), ref,
            atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_world_rejects_what_jax_rejects(world, case):
    _, raised, got = world
    words = REJECTIONS[case][3]
    assert words in raised[case]
    for g in got:
        assert str(g[f"{case}_error"]) == raised[case]


@pytest.mark.parametrize("gqa", [False, True])
def test_group_of_one_is_flash_attention(gqa):
    """group=None: no all-to-all; impl="flash" is ``flash_attention`` bit for
    bit, impl="dense" the dense reference to the flash suite's limits."""
    rng = np.random.default_rng(3)
    q, k, v, w = (torch.tensor(x) for x in _inputs(rng, 2, 48, 4, 2 if gqa else 4, 16))
    results = {}
    for name, fn in (("flash", lambda a, b, c: ra.ulysses_attention(a, b, c, impl="flash")),
                     ("dense", lambda a, b, c: ra.ulysses_attention(a, b, c)),
                     ("ref", fa.flash_attention),
                     ("dense_ref", fa.flash_attention_reference)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        (out * w).sum().backward()
        results[name] = [out.detach(), *(x.grad for x in leaves)]
    for a, b in zip(results["flash"], results["ref"]):
        assert torch.equal(a, b)
    for a, b, tol in zip(results["dense"], results["dense_ref"],
                         (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, rtol=tol)


def test_group_of_one_rejects_as_jax():
    q = torch.zeros(1, 8, 4, 8)
    with pytest.raises(ValueError, match="unknown impl"):
        ra.ulysses_attention(q, q, q, impl="bogus")
    with pytest.raises(ValueError, match="k has 4 heads but v has 2"):
        ra.ulysses_attention(q, q, q[:, :, :2])
