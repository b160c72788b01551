"""The flash kernels' tile sizes in the port against the JAX package's, on
the CPU.

- ``flash_attention(..., block_q=, block_k=)`` against
  ``horovod_tpu.ops.flash_attention.flash_attention`` with the same tiles
  (the Pallas kernels in interpret mode, where the tiles shape the grid),
  forward and all three gradients;
- ``ring_flash_attention(..., block_q=, block_k=)`` on a gloo ring of 2
  (tests/torch_port_tiles_worker.py) against the JAX ring on a 2-device
  mesh with the same tiles, contiguous and zigzag;
- ``TransformerLM(block_q=, block_k=)`` on weights from ``convert.py``
  against the JAX flash model with the same tiles, logits and every
  gradient, and the tiles reaching all three kernels of every layer;
- ``effective_blocks`` against a table written here: ceilings, a ceiling
  below the smallest built extent, None, and the float32 tile;
- ``transformer_benchmark --device cpu --sweep-blocks`` at a tiny width
  with head dim 128 (where the bf16 kernels are built for several tiles):
  one row per distinct set of effective tiles and a ``best:`` line;
  ``--attention dense --sweep-blocks`` exits with the JAX example's
  message.

On the CPU the port runs the plain versions whatever the tiles (they are
validated and resolved, and reach the wrappers); the tiled CUDA kernels
are held against the same plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py phases 3 and 7). So the
tolerances are those of the untiled comparisons, float32 on both sides
with JAX under highest matmul precision: the JAX flash suite's 2e-6
forward and 5e-6 gradients (tests/test_torch_port_flash.py), the ring
suite's 2e-5 and 3e-5 (tests/test_torch_port_ring.py), and the model's
2e-5 logits and 1e-4 gradients (tests/test_torch_port_model.py): a tile
changes the order of the JAX side's sums, not what they sum.
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
from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu.ops.ring_attention import zigzag_shard, zigzag_unshard
from horovod_tpu.ops.ring_flash import ring_flash_attention as jax_ring_flash
from horovod_tpu_torch import convert
from horovod_tpu_torch import transformer_benchmark as tb
from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
from horovod_tpu_torch.ops import flash_attention as fa
from launch_util import REPO, free_port

FWD_TOL, GRAD_TOL = 2e-6, 5e-6
RING_FWD_TOL, RING_GRAD_TOL = 2e-5, 3e-5
LOGITS_TOL, MODEL_GRAD_TOL = 2e-5, 1e-4
WORKER = os.path.join(REPO, "tests", "torch_port_tiles_worker.py")


def _inputs(seed, b, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in [(b, t, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, t, h, d)]]


# ------------------------------------------------------------ flash_attention

FLASH_CASES = {
    # name: (b, t, h, hkv, d, causal, block_q, block_k)
    "causal_32_16": (2, 128, 2, 2, 32, True, 32, 16),
    "causal_gqa_64_64": (1, 128, 4, 2, 32, True, 64, 64),
    "non_causal_128_32": (1, 128, 2, 1, 16, False, 128, 32),
    "ragged_t96_48_16": (2, 96, 2, 2, 16, True, 48, 16),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_with_tiles_matches_jax(case):
    b, t, h, hkv, d, causal, bq, bk = FLASH_CASES[case]
    q, k, v, g = _inputs(sorted(FLASH_CASES).index(case), b, t, h, hkv, d)
    with jax.default_matmul_precision("highest"):
        def f(q, k, v):
            return jax_flash(q, k, v, causal, bq, bk)

        out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
        want = [out, *vjp(jnp.asarray(g))]
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    got = fa.flash_attention(*leaves, causal, block_q=bq, block_k=bk)
    (got * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want[0]),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for name, leaf, ref in zip("qkv", leaves, want[1:]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("bad", [0, -64, 64.0, "64", True])
def test_flash_attention_rejects_bad_tiles(bad):
    q, k, v, _ = (torch.tensor(x) for x in _inputs(0, 1, 32, 2, 2, 16))
    with pytest.raises(ValueError, match="block_q must be a positive int"):
        fa.flash_attention(q, k, v, block_q=bad)
    with pytest.raises(ValueError, match="block_k must be a positive int"):
        fa.flash_attention(q, k, v, block_k=bad)


# ------------------------------------------------------ effective_blocks

BF16 = torch.bfloat16
EFFECTIVE = [
    # (t, d, dtype, block_q, block_k): (fwd, dq, dkv) as (q extent, k extent)
    ((4096, 128, BF16, None, None), ((128, 128), (128, 64), (64, 128))),
    ((4096, 128, BF16, 64, 64), ((64, 64), (64, 64), (64, 64))),
    ((4096, 128, BF16, 128, 64), ((128, 64), (128, 64), (64, 64))),
    ((4096, 128, BF16, 64, 128), ((64, 128), (64, 128), (64, 128))),
    ((4096, 128, BF16, 64, None), ((64, 128), (64, 64), (64, 128))),
    ((4096, 128, BF16, None, 64), ((128, 64), (128, 64), (64, 64))),
    # ceilings: the built pair of the largest area within them, then the
    # larger q extent (dQ has no 128/128: 128/64 and 64/128 tie)
    ((4096, 128, BF16, 128, 128), ((128, 128), (128, 64), (64, 128))),
    ((4096, 128, BF16, 1024, 1024), ((128, 128), (128, 64), (64, 128))),
    ((4096, 128, BF16, 96, 200), ((64, 128), (64, 128), (64, 128))),
    # below the smallest built extent: the smallest
    ((4096, 128, BF16, 8, 16), ((64, 64), (64, 64), (64, 64))),
    ((96, 128, BF16, 1, 128), ((64, 128), (64, 128), (64, 128))),
    # other head dims: the default pair alone
    ((4096, 64, BF16, 64, 64), ((128, 128), (128, 64), (64, 128))),
    ((4096, 32, BF16, None, None), ((128, 128), (128, 64), (64, 128))),
    # float32: the FMA kernels' one tile
    ((4096, 128, torch.float32, 128, 128), ((64, 64), (64, 64), (64, 64))),
    ((96, 32, torch.float32, None, None), ((64, 64), (64, 64), (64, 64))),
]


@pytest.mark.parametrize("args,want", EFFECTIVE, ids=[str(a) for a, _ in EFFECTIVE])
def test_effective_blocks_table(args, want):
    eff = fa.effective_blocks(*args)
    assert set(eff) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                        "ring_flash_fwd", "ring_flash_bwd_dq", "ring_flash_bwd_dkv"}
    assert (eff["flash_fwd"], eff["flash_bwd_dq"], eff["flash_bwd_dkv"]) == want
    # The ring kernels are the same templates: the same pairs.
    assert (eff["ring_flash_fwd"], eff["ring_flash_bwd_dq"],
            eff["ring_flash_bwd_dkv"]) == want


def test_effective_blocks_picks_built_pairs_only():
    for name, pairs in fa.TILE_PAIRS.items():
        for bq in (1, 63, 64, 65, 127, 128, 129, 4096):
            for bk in (1, 63, 64, 65, 127, 128, 129, 4096):
                got = fa.effective_blocks(4096, 128, BF16, bq, bk)[name]
                assert got in pairs
                within = [p for p in pairs if p[0] <= max(bq, 64) and p[1] <= max(bk, 64)]
                assert got[0] * got[1] == max(p[0] * p[1] for p in within)


# ------------------------------------------------ ring_flash_attention, 2 ranks

RING_CASES = {
    # name: (zigzag, block_q, block_k); (B, T, H, Hkv, D) = RING_SHAPE
    "contiguous_16_8": (False, 16, 8),
    "zigzag_8_8": (True, 8, 8),
    "contiguous_gqa_32_32": (False, 32, 32),
}
RING_SHAPE = (1, 64, 4, 2, 16)
RING_N = 2


def _jax_ring(mesh, q, k, v, w, zigzag, bq, bk):
    if zigzag:
        q, k, v, w = (zigzag_shard(x, RING_N) for x in (q, k, v, w))
    ring = shard_map(lambda a, b, c: jax_ring_flash(a, b, c, "sp", zigzag, bq, bk),
                     mesh=mesh, in_specs=P(None, "sp"), out_specs=P(None, "sp"),
                     check_vma=False)

    def both(a, b, c):
        out, vjp = jax.vjp(ring, a, b, c)
        return (out, *vjp(w))

    with jax.default_matmul_precision("highest"):
        res = jax.jit(both)(q, k, v)
    if zigzag:
        res = [zigzag_unshard(x, RING_N) for x in res]
    return [np.asarray(x) for x in res]


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    """The JAX ring on a 2-device mesh, then the port's 2-rank gloo ring on
    the same inputs: (JAX results, per-rank port results)."""
    tmp = tmp_path_factory.mktemp("tiles_world")
    mesh = Mesh(np.asarray(jax.devices()[:RING_N]), ("sp",))
    inputs, want = {}, {}
    for i, (case, (zigzag, bq, bk)) in enumerate(sorted(RING_CASES.items())):
        x = _inputs(100 + i, *RING_SHAPE)
        inputs.update({f"{case}_{n}": a for n, a in zip("qkvw", x)})
        want[case] = _jax_ring(mesh, *(jnp.asarray(a) for a in x), zigzag, bq, bk)
    inputs["cases"] = np.array(json.dumps(RING_CASES))
    np.savez(tmp / "in.npz", **inputs)
    port = free_port()
    procs = []
    for rank in range(RING_N):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(RING_N),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(RING_N),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}",
                   TILES_IN=str(tmp / "in.npz"), TILES_OUT=str(tmp / "out"),
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
    return want, [dict(np.load(tmp / f"out.{rank}.npz")) for rank in range(RING_N)]


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_flash_with_tiles_matches_jax(ring_world, case):
    want, got = ring_world
    zigzag = RING_CASES[case][0]

    def whole(key):
        full = np.concatenate([g[f"{case}_{key}"] for g in got], axis=1)
        return np.asarray(zigzag_unshard(jnp.asarray(full), RING_N)) if zigzag else full

    out, dq, dk, dv = want[case]
    np.testing.assert_allclose(whole("out"), out, atol=RING_FWD_TOL, rtol=RING_FWD_TOL)
    for name, ref in zip(("dq", "dk", "dv"), (dq, dk, dv)):
        np.testing.assert_allclose(whole(name), ref, atol=RING_GRAD_TOL,
                                   rtol=RING_GRAD_TOL, err_msg=name)


# ------------------------------------------------------------ TransformerLM

MODEL = dict(vocab=64, dim=32, heads=4, layers=2)
T = 64


@pytest.mark.parametrize("tiles", [(32, 16), (16, 16)])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_transformer_with_tiles_matches_jax(kv_heads, tiles, monkeypatch):
    import optax
    from horovod_tpu.models import TransformerLM as JaxLM

    bq, bk = tiles
    jmodel = JaxLM(**MODEL, kv_heads=kv_heads, dtype=jnp.float32,
                   attention="flash", block_q=bq, block_k=bk)
    tokens = np.random.default_rng(5).integers(0, MODEL["vocab"], (2, T)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, tokens)
        targets = jnp.roll(tokens, -1, axis=1)
        return optax.softmax_cross_entropy_with_integer_labels(logits, targets).mean(), logits

    with jax.default_matmul_precision("highest"):
        (ref_loss, ref_logits), ref_grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)

    seen = []
    tiles_of = fa.tiles_of
    monkeypatch.setattr(fa, "tiles_of", lambda name, x, q=None, k=None: (
        seen.append((name, q, k)), tiles_of(name, x, q, k))[1])
    model = TransformerLM(**MODEL, kv_heads=kv_heads, attention="flash",
                          dtype=torch.float32, block_q=bq, block_k=bk)
    model.load_state_dict(convert.transformer_state_dict_from_jax(
        params, model.state_dict().keys()))
    tok = torch.tensor(tokens, dtype=torch.long)
    logits = model(tok)
    loss = lm_loss(logits, tok)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        want = np.asarray(convert._lookup(ref_grads, convert.flax_path(name)))
        np.testing.assert_allclose(convert.to_flax_layout(name, p.grad), want,
                                   atol=MODEL_GRAD_TOL, rtol=MODEL_GRAD_TOL,
                                   err_msg=name)
    # Every layer's three kernels saw the model's tiles.
    assert sorted(seen) == sorted(
        (n, bq, bk) for n in fa.TILE_PAIRS for _ in range(MODEL["layers"]))


def test_train_config_carries_tiles_into_the_model():
    from horovod_tpu_torch import train

    config = train.TrainConfig(vocab=64, dim=32, heads=4, layers=2, seq=16,
                               block_q=64, block_k=32)
    model = train.build_model(config, "cpu")
    assert {(b.block_q, b.block_k) for b in model.blocks} == {(64, 32)}
    assert train.TrainConfig().block_q is None and train.TrainConfig().block_k is None


# ------------------------------------------------------------ the benchmark

def _bench(extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        env.pop(var, None)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.transformer_benchmark",
         "--device", "cpu", "--dim", "256", "--heads", "2", "--layers", "1",
         "--vocab", "64", "--seq-len", "64", "--num-warmup", "1",
         "--num-iters", "1", *extra],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)


def test_benchmark_sweeps_one_row_per_effective_tile_set():
    proc = _bench(["--sweep-blocks"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("  blocks ")]
    # Today's tiles, then 64/64, 128/64 and 128/128 of the default grid
    # (64/128 is skipped: block_k > block_q, as the JAX sweep skips it),
    # each distinct set of effective tiles once: 128/128 takes today's.
    args = tb.parse_args(["--dim", "256", "--heads", "2", "--seq-len", "64"])
    labels = [tb.tiles_label(tb.tiles(args, bq, bk))
              for bq, bk in [(None, None), (64, 64), (128, 64), (128, 128)]]
    want = list(dict.fromkeys(labels))
    assert len(want) == 3 and len(rows) == len(want)
    for row, label in zip(rows, want):
        assert row.endswith(f"tok/s  ({label})"), (row, label)
    best = proc.stdout.strip().splitlines()[-1]
    assert best.startswith("best: block_q=") and "tok/s" in best


def test_benchmark_prints_the_tiles_it_ran():
    proc = _bench(["--block-q", "64", "--block-k", "64"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ("tiles flash_fwd 64/64, flash_bwd_dq 64/64, flash_bwd_dkv 64/64"
            in proc.stdout)


def test_benchmark_sweep_refuses_dense_attention():
    proc = _bench(["--attention", "dense", "--sweep-blocks"])
    assert proc.returncode != 0
    assert ("--sweep-blocks tunes the flash kernel tiles; the dense schedule "
            "has none (use --attention flash)") in proc.stderr
