"""The port's TransformerLM against the JAX package's, on the same weights
(through ``horovod_tpu_torch.convert``) and the same tokens: logits, loss
and every parameter gradient, at float32 and a tiny size (vocab 64, dim 32,
4 heads, 2 layers, T 64), multi-head and GQA, flash and dense attention.

The JAX side runs ``attention="dense"``: the JAX suite holds its flash
model equal to its dense one at this size (tests/test_flash_attention.py),
and the port's flash kernels are held against the Pallas kernels directly
in tests/test_torch_port_flash.py. Tolerances: logits atol/rtol 2e-5 (the
JAX suite's flash-vs-dense tolerance for this model), gradients atol 1e-4,
under highest matmul precision on the JAX side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu_torch import convert
from horovod_tpu_torch.models.transformer import (TransformerLM, _rope,
                                                  causal_attention, lm_loss)

KW = dict(vocab=64, dim=32, heads=4, layers=2)
T = 64


def _jax_setup(kv_heads):
    model = JaxLM(**KW, kv_heads=kv_heads, dtype=jnp.float32)
    tokens = np.random.default_rng(5).integers(0, KW["vocab"], (2, T)).astype(np.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params), tokens


def _jax_loss_grads(model, params, tokens):
    def loss_fn(p):
        logits = model.apply({"params": p}, tokens)
        targets = jnp.roll(tokens, -1, axis=1)
        return optax.softmax_cross_entropy_with_integer_labels(logits, targets).mean(), logits

    with jax.default_matmul_precision("highest"):
        (loss, logits), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), np.asarray(logits), grads


def _port(kv_heads, attention, params):
    model = TransformerLM(**KW, kv_heads=kv_heads, attention=attention,
                          dtype=torch.float32)
    model.load_state_dict(convert.transformer_state_dict_from_jax(
        params, model.state_dict().keys()))
    return model


@pytest.mark.parametrize("attention", ["flash", "dense"])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_logits_and_grads_match_jax(kv_heads, attention):
    jmodel, params, tokens = _jax_setup(kv_heads)
    ref_loss, ref_logits, ref_grads = _jax_loss_grads(jmodel, params, tokens)
    model = _port(kv_heads, attention, params)
    tok = torch.tensor(tokens, dtype=torch.long)
    logits = model(tok)
    loss = lm_loss(logits, tok)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits,
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    for name, p in model.named_parameters():
        want = np.asarray(convert._lookup(ref_grads, convert.flax_path(name)))
        np.testing.assert_allclose(convert.to_flax_layout(name, p.grad), want,
                                   atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_name_map_covers_the_flax_tree_in_flatten_order(kv_heads):
    _, params, _ = _jax_setup(kv_heads)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    jax_paths = [tuple(k.key for k in path) for path, _ in flat]
    model = TransformerLM(**KW, kv_heads=kv_heads, dtype=torch.float32)
    ordered = convert.jax_ordered(model.named_parameters())
    assert [convert.flax_path(n) for n, _ in ordered] == jax_paths
    for (name, p), (_, leaf) in zip(ordered, flat):
        assert convert.to_flax_layout(name, p).shape == leaf.shape, name


def test_rope_and_dense_attention_match_jax():
    from horovod_tpu.models.transformer import _rope as jax_rope
    from horovod_tpu.models.transformer import causal_attention as jax_attn

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 4, 8), dtype=np.float32)
    k = rng.standard_normal((2, 16, 4, 8), dtype=np.float32)
    pos = np.arange(16)[None, :]
    np.testing.assert_allclose(
        _rope(torch.tensor(x), torch.tensor(pos)).numpy(),
        np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos))), atol=1e-6)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_attn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(k)))
    got = causal_attention(torch.tensor(x), torch.tensor(k), torch.tensor(k))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=2e-6)


def test_bf16_activations_and_f32_params():
    model = TransformerLM(**KW, attention="flash")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    tok = torch.randint(0, KW["vocab"], (1, 32), generator=torch.Generator().manual_seed(0))
    assert model(tok).dtype == torch.float32          # logits_dtype
    h = model.blocks[0].norm1(model.embed(tok).to(torch.bfloat16))
    assert h.dtype == torch.bfloat16


def test_unknown_attention_and_bad_kv_heads_rejected():
    with pytest.raises(ValueError, match="unknown attention"):
        TransformerLM(**KW, attention="Flash")
    with pytest.raises(ValueError, match="kv_heads 3"):
        TransformerLM(**KW, kv_heads=3)
