"""The slice as a whole: the port's training step (flash TransformerLM,
next-token loss, backward, DistributedOptimizer over Adam) against the JAX
package's (TransformerLM, optax.adam wrapped in its DistributedOptimizer,
under shard_map), from the same weights on the same tokens, 3 steps, in a
world of one over gloo; and ``train()`` end to end on the CPU.

Tolerances (float32 on both sides; JAX at highest matmul precision; the
JAX model runs dense attention, which its own suite holds equal to flash
at this size): losses 1e-5 relative. Parameters: Adam's step
lr * m/(sqrt(v) + eps) is insensitive to the gradient's rounding except
where the gradient is within float32 noise of zero (|g| ~ eps), where the
two frameworks' last-bit differences can move the step by up to lr. So
every element agrees to lr * steps, and all but 0.1% of each tensor's
elements to 2e-6 (3 steps at lr 1e-3).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu_torch import convert
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.train import TrainConfig, make_train_step, train

KW = dict(vocab=64, dim=32, heads=4, layers=2)
LR, STEPS, THRESHOLD = 1e-3, 3, 40000


@pytest.fixture()
def cpu_world(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        monkeypatch.delenv(k, raising=False)
    yield
    hvd.shutdown()


def _jax_run(kv_heads, tokens):
    import horovod_tpu as hvd_tpu
    from horovod_tpu.compat import shard_map
    from horovod_tpu.models import TransformerLM as JaxLM

    model = JaxLM(**KW, kv_heads=kv_heads, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]
    opt = hvd_tpu.jax.DistributedOptimizer(optax.adam(LR), fusion_threshold=THRESHOLD)

    def step(p, s, tok):
        def loss_fn(p):
            logits = model.apply({"params": p}, tok)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.roll(tok, -1, axis=1)).mean()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, jax.lax.pmean(loss, "hvd")

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("hvd",))
    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(P(), P(), P()),
                           out_specs=(P(), P(), P()), check_vma=False))
    init = jax.tree_util.tree_map(np.asarray, params)
    p, s, losses = params, opt.init(params), []
    with jax.default_matmul_precision("highest"):
        for _ in range(STEPS):
            p, s, loss = fn(p, s, jnp.asarray(tokens))
            losses.append(float(loss))
    return init, losses, p


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_train_step_matches_jax(cpu_world, kv_heads):
    tokens = np.random.default_rng(3).integers(0, KW["vocab"], (2, 64)).astype(np.int32)
    init, want_losses, want_params = _jax_run(kv_heads, tokens)

    hvd.init(device="cpu")
    model = TransformerLM(**KW, kv_heads=kv_heads, attention="flash",
                          dtype=torch.float32)
    model.load_state_dict(convert.transformer_state_dict_from_jax(
        init, model.state_dict().keys()))
    named = convert.jax_ordered(model.named_parameters())
    opt = hvd.DistributedOptimizer(torch.optim.Adam([p for _, p in named], lr=LR),
                                   named, fusion_threshold=THRESHOLD)
    assert opt.plan.num_buckets > 1
    step = make_train_step(model, opt)
    tok = torch.tensor(tokens, dtype=torch.long)
    losses = [step(tok).item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for name, p in named:
        want = np.asarray(convert._lookup(want_params, convert.flax_path(name)))
        diff = np.abs(convert.to_flax_layout(name, p) - want)
        assert diff.max() <= LR * STEPS, (name, diff.max())
        assert np.mean(diff > 2e-6) <= 1e-3, (name, np.sort(diff.ravel())[-5:])


def test_train_end_to_end_on_cpu(cpu_world, monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(1 << 14))
    fa.reset_launches()
    config = TrainConfig(vocab=128, dim=64, heads=2, layers=2, seq=64)
    result = train(config, 4, device="cpu")
    assert len(result.losses) == len(result.step_s) == 4
    assert all(np.isfinite(result.losses))
    assert result.losses[-1] < result.losses[0]
    assert result.tokens_per_step == 64 and result.num_buckets > 1
    assert result.params == sum(p.numel() for p in TransformerLM(
        vocab=128, dim=64, heads=2, layers=2).parameters())
    assert fa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_train_runs_each_step_inside_around_step(cpu_world):
    entered = []

    @contextlib.contextmanager
    def around(i):
        entered.append(("in", i))
        yield
        entered.append(("out", i))

    config = TrainConfig(vocab=16, dim=32, heads=2, layers=1, seq=8)
    result = train(config, 2, device="cpu", around_step=around)
    assert entered == [("in", 0), ("out", 0), ("in", 1), ("out", 1)]
    assert len(result.losses) == len(result.step_s) == 2
