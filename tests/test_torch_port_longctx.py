"""The port's long-context options against the JAX package's, on the same
weights (through ``horovod_tpu_torch.convert``) and tokens, at float32 and
a tiny size (vocab 64, dim 32, 4 heads, 2 layers, T 64): ``remat``
(``torch.utils.checkpoint`` per block against ``nn.remat(Block)``),
``return_hidden``, ``chunked_lm_loss`` and the bf16 LM head.

The JAX side runs ``attention="dense"`` under highest matmul precision
(its suite holds its flash model equal to its dense one at this size); the
port runs its flash path, whose kernels are held against the Pallas ones
in tests/test_torch_port_flash.py, and its dense path. Tolerances: port
against JAX, loss and every gradient 1e-5 (relative, and absolute for
gradients near 0: float32 sums in another order); port against port, the
same arithmetic in the same order, 1e-6; the bf16 head, whose logits round
at 2^-9, loss 1e-2 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu.models.transformer import chunked_lm_loss as jax_chunked
from horovod_tpu_torch import convert
from horovod_tpu_torch.models.transformer import (TransformerLM, chunked_lm_loss,
                                                  lm_loss, next_tokens)
from horovod_tpu_torch.parallel.mesh import dp_sp_groups
from horovod_tpu_torch.train import TrainConfig

KW = dict(vocab=64, dim=32, heads=4, layers=2)
T, CHUNK = 64, 16


@pytest.fixture(scope="module")
def weights():
    tokens = np.random.default_rng(11).integers(0, KW["vocab"], (2, T)).astype(np.int32)
    params = jax.jit(JaxLM(**KW, dtype=jnp.float32).init)(
        jax.random.PRNGKey(4), jnp.asarray(tokens))["params"]
    return jax.tree_util.tree_map(np.asarray, params), tokens


@pytest.fixture()
def cpu_world(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _jax_loss_grads(params, tokens, loss_of, **model_kw):
    model = JaxLM(**KW, dtype=jnp.float32, **model_kw)
    targets = jnp.roll(tokens, -1, axis=1)

    def loss_fn(p):
        return loss_of(model, p, tokens, targets)

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), grads


def _full_loss(model, p, tokens, targets):
    logits = model.apply({"params": p}, tokens)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), targets).mean()


def _chunk_loss(model, p, tokens, targets):
    hidden = model.apply({"params": p}, tokens, return_hidden=True)
    return jax_chunked(hidden, p["lm_head"]["kernel"], targets, CHUNK)


def _port(params, **kw):
    model = TransformerLM(**KW, dtype=torch.float32, **kw)
    model.load_state_dict(convert.transformer_state_dict_from_jax(
        params, model.state_dict().keys()))
    return model


def _port_loss_grads(model, tokens, chunk=0, positions=None):
    tok = torch.tensor(tokens, dtype=torch.long)
    model.zero_grad()
    if chunk:
        hidden = model(tok, positions, return_hidden=True)
        loss = chunked_lm_loss(hidden, model.lm_head.weight, next_tokens(tok), chunk)
    else:
        loss = lm_loss(model(tok, positions), tok)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _assert_grads_match_jax(grads, want, tol):
    for name, g in grads.items():
        ref = np.asarray(convert._lookup(want, convert.flax_path(name)))
        np.testing.assert_allclose(convert.to_flax_layout(name, g), ref,
                                   atol=tol, rtol=tol, err_msg=name)


def _assert_same(a, b, tol=1e-6):
    (la, ga), (lb, gb) = a, b
    np.testing.assert_allclose(la, lb, rtol=tol)
    for name in gb:
        np.testing.assert_allclose(ga[name].numpy(), gb[name].numpy(),
                                   atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_remat_matches_jax_remat(weights, attention):
    params, tokens = weights
    want_loss, want = _jax_loss_grads(params, tokens, _full_loss, remat=True)
    loss, grads = _port_loss_grads(_port(params, attention=attention, remat=True),
                                   tokens)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_grads_match_jax(grads, want, 1e-5)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_remat_matches_no_remat(weights, attention):
    params, tokens = weights
    _assert_same(_port_loss_grads(_port(params, attention=attention, remat=True), tokens),
                 _port_loss_grads(_port(params, attention=attention), tokens))


def test_remat_matches_no_remat_on_a_ring_of_one(weights, cpu_world):
    """The ring-flash Function under checkpoint: a gloo world of one, a
    ring of one (sp=1), positions passed as the sp trainer passes them."""
    params, tokens = weights
    ring = dp_sp_groups(1)
    positions = torch.arange(T)[None, :]
    res = [_port_loss_grads(_port(params, attention="flash", sp_group=ring.group,
                                  remat=remat), tokens, positions=positions)
           for remat in (True, False)]
    _assert_same(*res)


def test_remat_reruns_each_block_forward(weights, monkeypatch):
    """Under remat the backward pass recomputes each block: the attention
    forward runs twice per layer, its backward once."""
    from horovod_tpu_torch.ops import flash_attention as fa

    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for name, key in (("flash_fwd", "fwd"), ("flash_bwd_dq", "dq"),
                      ("flash_bwd_dkv", "dkv")):
        orig = getattr(fa, name)

        def counted(*a, _orig=orig, _key=key):
            calls[_key] += 1
            return _orig(*a)

        monkeypatch.setattr(fa, name, counted)
    params, tokens = weights
    _port_loss_grads(_port(params, attention="flash", remat=True), tokens)
    assert calls == {"fwd": 2 * KW["layers"], "dq": KW["layers"],
                     "dkv": KW["layers"]}


def test_return_hidden_matches_jax(weights):
    params, tokens = weights
    with jax.default_matmul_precision("highest"):
        want = JaxLM(**KW, dtype=jnp.float32).apply(
            {"params": params}, tokens, return_hidden=True)
    model = _port(params, attention="flash")
    tok = torch.tensor(tokens, dtype=torch.long)
    hidden = model(tok, return_hidden=True)
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    logits = model(tok)
    np.testing.assert_allclose(
        model.lm_head(hidden).detach().numpy(), logits.detach().numpy(),
        atol=1e-6, rtol=1e-6)


def test_chunked_loss_matches_jax_and_the_full_loss(weights):
    params, tokens = weights
    want_loss, want = _jax_loss_grads(params, tokens, _chunk_loss)
    model = _port(params, attention="flash")
    chunked = _port_loss_grads(model, tokens, chunk=CHUNK)
    np.testing.assert_allclose(chunked[0], want_loss, rtol=1e-5)
    _assert_grads_match_jax(chunked[1], want, 1e-5)
    full = _port_loss_grads(model, tokens)
    np.testing.assert_allclose(chunked[0], full[0], rtol=1e-6)
    for name in full[1]:
        np.testing.assert_allclose(chunked[1][name].numpy(), full[1][name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_remat_with_chunked_loss_matches_jax(weights):
    params, tokens = weights
    want_loss, want = _jax_loss_grads(params, tokens, _chunk_loss, remat=True)
    loss, grads = _port_loss_grads(_port(params, attention="flash", remat=True),
                                   tokens, chunk=CHUNK)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_grads_match_jax(grads, want, 1e-5)


@pytest.mark.parametrize("chunk, match", [
    (0, "must be positive"), (-4, "must be positive"), (24, "not divisible")])
def test_chunked_loss_raises_as_the_reference(chunk, match):
    hidden, w = torch.zeros(1, T, 8), torch.zeros(16, 8)
    targets = torch.zeros(1, T, dtype=torch.long)
    with pytest.raises(ValueError, match=match):
        chunked_lm_loss(hidden, w, targets, chunk)
    with pytest.raises(ValueError, match=match):
        jax_chunked(jnp.zeros((1, T, 8)), jnp.zeros((8, 16)),
                    jnp.zeros((1, T), jnp.int32), chunk)


def test_chunk_above_the_sequence_is_the_whole_sequence(weights):
    params, tokens = weights
    model = _port(params, attention="dense")
    _assert_same(_port_loss_grads(model, tokens, chunk=4 * T),
                 _port_loss_grads(model, tokens))


def test_train_config_rejects_a_bf16_head_with_a_chunked_loss():
    with pytest.raises(ValueError, match="loss_chunk"):
        TrainConfig(loss_chunk=16, logits_dtype="bfloat16")
    with pytest.raises(ValueError, match="loss_chunk"):
        TrainConfig(loss_chunk=-1)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        TrainConfig(steps_per_dispatch=0)
    base = TrainConfig()
    assert (base.remat, base.loss_chunk, base.logits_dtype,
            base.steps_per_dispatch) == (False, 0, "float32", None)
    assert dataclasses.replace(base, sp=1).sp == 1


def test_bf16_head_matches_jax_bf16_head(weights):
    params, tokens = weights
    want_loss, _ = _jax_loss_grads(params, tokens, _full_loss,
                                   logits_dtype=jnp.bfloat16)
    model = _port(params, attention="flash", logits_dtype=torch.bfloat16)
    loss, grads = _port_loss_grads(model, tokens)
    assert model(torch.tensor(tokens, dtype=torch.long)).dtype == torch.bfloat16
    np.testing.assert_allclose(loss, want_loss, rtol=1e-2)
    f32_loss, _ = _port_loss_grads(_port(params, attention="flash"), tokens)
    np.testing.assert_allclose(loss, f32_loss, rtol=1e-2)
    assert all(torch.isfinite(g).all() for g in grads.values())
