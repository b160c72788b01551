"""The port's serving model code (``horovod_tpu_torch.serving.model``)
against the JAX package's (``horovod_tpu.serving.model``), on the CPU.

The same inputs go through both: TinyLM's weights are made by the same
numpy code, so every comparison of weights is bit for bit. The model runs
in numpy in the JAX package and in torch in the port, whose CPU products
sum in another order: tokens must be equal and K/V within 1e-5 relative
(float32 rounding of a few sums of 16 terms is ~1e-7). Inside the port,
where both sides run the same torch operations, paged, verified and
resumed decode must be bitwise its own ``lm_generate``.

``mlp_builder`` serves flax weights carried across by ``convert.py``: its
output within 1e-5 relative of the flax model's (a float32 MLP of three
small products). Entry points that default to the card raise without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from horovod_tpu.serving import model as jm
from horovod_tpu_torch.serving import model as pm

RTOL = 1e-5          # K/V and logits, port (torch) against JAX (numpy)
JP = jm.tiny_lm_params()
TP = pm.lm_params_to_torch(pm.tiny_lm_params(), "cpu")
PROMPTS = [[3, 17, 5], [60], list(range(40)), [9, 2, 9, 2, 9, 2, 63, 0]]


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- weights --------------------------------------------------------------------


@pytest.mark.parametrize("shape", [dict(), dict(vocab=32, dim=8, seed=3),
                                   dict(vocab=128, dim=32, max_context=64,
                                        seed=11)])
def test_tiny_lm_params_bit_equal(shape):
    a, b = jm.tiny_lm_params(**shape), pm.tiny_lm_params(**shape)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_lm_params_to_torch_carries_every_bit():
    t = pm.lm_params_to_torch(JP, "cpu")
    for k, v in JP.items():
        if isinstance(v, np.ndarray):
            assert t[k].dtype == torch.float32 and t[k].is_contiguous()
            assert np.array_equal(t[k].numpy(), v), k
        else:
            assert t[k] == v


def test_draft_lm_params_bit_equal():
    jd, pd = jm.draft_lm_params(JP), pm.draft_lm_params(TP)
    for k, v in jd.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(pd[k].numpy(), v), k
        else:
            assert pd[k] == v


# -- TinyLM against the JAX package --------------------------------------------


@pytest.mark.parametrize("pos", [0, 1, 7, 33])
def test_lm_context_step_matches_jax(pos):
    rs = np.random.RandomState(pos)
    kc = rs.uniform(-0.2, 0.2, (pos, 16)).astype(np.float32)
    vc = rs.uniform(-0.2, 0.2, (pos, 16)).astype(np.float32)
    tok = int(rs.randint(64))
    jn, jk, jv = jm.lm_context_step(JP, tok, pos, kc, vc)
    pn, pk, pv = pm.lm_context_step(TP, tok, pos, torch.from_numpy(kc),
                                    torch.from_numpy(vc))
    assert pn == jn
    assert _rel(pk, jk) <= RTOL and _rel(pv, jv) <= RTOL
    logits, _, _ = pm.lm_logits_step(TP, tok, pos, torch.from_numpy(kc),
                                     torch.from_numpy(vc))
    assert int(logits.argmax()) == pn
    with pytest.raises(ValueError, match="max_context"):
        pm.lm_context_step(TP, tok, 512, torch.zeros(0, 16), torch.zeros(0, 16))


@pytest.mark.parametrize("prompt", PROMPTS, ids=lambda p: f"len{len(p)}")
def test_lm_prefill_matches_jax(prompt):
    jk, jv, jn = jm.lm_prefill(JP, prompt)
    pk, pv, pn = pm.lm_prefill(TP, prompt)
    assert pn == jn and pk.shape == jk.shape
    assert _rel(pk, jk) <= RTOL and _rel(pv, jv) <= RTOL
    with pytest.raises(ValueError, match="at least one"):
        pm.lm_prefill(TP, [])


@pytest.mark.parametrize("split", [0, 1, 5, 17, 39])
def test_lm_prefill_from_matches_jax_and_is_bitwise_prefill(split):
    tokens = PROMPTS[2]
    fk, fv, fn = pm.lm_prefill(TP, tokens)
    pk, pv, pn = pm.lm_prefill_from(TP, tokens, fk[:split], fv[:split])
    assert pn == fn
    assert torch.equal(pk, fk[split:]) and torch.equal(pv, fv[split:])
    jfk, jfv, _ = jm.lm_prefill(JP, tokens)
    jk, jv, jn = jm.lm_prefill_from(JP, tokens, jfk[:split], jfv[:split])
    assert jn == pn and _rel(pk, jk) <= RTOL and _rel(pv, jv) <= RTOL
    with pytest.raises(ValueError, match="prefix covers"):
        pm.lm_prefill_from(TP, tokens, fk, fv)


@pytest.mark.parametrize("prompt", PROMPTS, ids=lambda p: f"len{len(p)}")
@pytest.mark.parametrize("n", [1, 12, 30])
def test_lm_generate_matches_jax(prompt, n):
    assert pm.lm_generate(TP, prompt, n) == jm.lm_generate(JP, prompt, n)


def test_lm_generate_stops_at_eos_like_jax():
    full = jm.lm_generate(JP, [3, 17, 5], 20)
    eos = full[4]
    assert pm.lm_generate(TP, [3, 17, 5], 20, eos_id=eos) == \
        jm.lm_generate(JP, [3, 17, 5], 20, eos_id=eos) == full[:full.index(eos) + 1]


@pytest.mark.parametrize("proposals", [[], "oracle", "oracle3", [1, 2, 3],
                                       "oracle_then_wrong"])
def test_lm_verify_chain_matches_jax(proposals):
    prompt = PROMPTS[0]
    want = jm.lm_generate(JP, prompt, 8)
    if proposals == "oracle":
        proposals = want[1:6]
    elif proposals == "oracle3":
        proposals = want[1:4]
    elif proposals == "oracle_then_wrong":
        proposals = want[1:3] + [(want[3] + 1) % 64, 5]
    jk, jv, jn = jm.lm_prefill(JP, prompt)
    pk, pv, pn = pm.lm_prefill(TP, prompt)
    cap = len(prompt) + len(proposals) + 1
    jbk = np.zeros((cap, 16), np.float32)
    jbv = np.zeros_like(jbk)
    jbk[:len(prompt)], jbv[:len(prompt)] = jk, jv
    pbk = torch.zeros(cap, 16)
    pbv = torch.zeros_like(pbk)
    pbk[:len(prompt)], pbv[:len(prompt)] = pk, pv
    jout = jm.lm_verify_chain(JP, jn, proposals, len(prompt), jbk, jbv)
    pout = pm.lm_verify_chain(TP, pn, proposals, len(prompt), pbk, pbv)
    assert pout == jout
    n = len(prompt) + len(pout)
    assert _rel(pbk[:n], jbk[:n]) <= RTOL and _rel(pbv[:n], jbv[:n]) <= RTOL


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "per_row"])
def test_lm_verify_chain_bitwise_repeated_context_steps(batched, monkeypatch):
    # Both branches of the verify forward are bitwise lm_context_step: the
    # batched one is taken only where the probe says the GEMM rows are exact,
    # so force the probe's answer and hold the branch it picks.
    monkeypatch.setattr(pm, "_gemm_rows_exact", lambda *a, **k: batched)
    prompt = [3, 17, 5]
    want = pm.lm_generate(TP, prompt, 6)
    k, v, nxt = pm.lm_prefill(TP, prompt)
    proposals = want[1:5] if not batched else want[1:2]
    buf_k = torch.zeros(len(prompt) + len(proposals) + 1, 16)
    buf_v = torch.zeros_like(buf_k)
    buf_k[:3], buf_v[:3] = k, v
    out = pm.lm_verify_chain(TP, nxt, proposals, 3, buf_k, buf_v)
    assert out == want[1:1 + len(out)]
    ks, vs, tok = list(k), list(v), nxt
    for i in range(len(out)):
        t, kk, vv = pm.lm_context_step(TP, tok, 3 + i, torch.stack(ks),
                                       torch.stack(vs))
        if not batched:
            assert torch.equal(kk, buf_k[3 + i]) and torch.equal(vv, buf_v[3 + i])
        ks.append(kk)
        vs.append(vv)
        tok = t
        assert t == out[i]


def test_gemm_rows_probe_is_cached_per_device_and_rows():
    pm._GEMM_ROWS_EXACT.pop((16, "cpu", 3), None)
    first = pm._gemm_rows_exact(16, "cpu", 3)
    assert isinstance(first, bool)
    assert pm._GEMM_ROWS_EXACT[(16, "cpu", 3)] is first
    assert pm._gemm_rows_exact(16, torch.device("cpu"), 3) is first


@pytest.mark.parametrize("steps", [1, 4, 9])
def test_lm_draft_chain_matches_jax(steps):
    jd, pd = jm.draft_lm_params(JP), pm.draft_lm_params(TP)
    assert pm.lm_draft_chain(pd, 7, 3, steps) == jm.lm_draft_chain(jd, 7, 3, steps)
    with pytest.raises(ValueError):
        pm.lm_draft_chain(pd, 7, 510, 5)


# -- sharded params ------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 4])
def test_shard_lm_params_reassembles_bitwise_and_counts_like_jax(s):
    sharded = pm.shard_lm_params(TP, s)
    jsharded = jm.shard_lm_params(JP, s)
    assert sharded.model_shards == s
    for k in TP:
        if isinstance(TP[k], torch.Tensor):
            assert torch.equal(sharded[k], TP[k]), k
        else:
            assert sharded[k] == TP[k]
    assert sharded.per_chip_nbytes() == jsharded.per_chip_nbytes()
    assert pm.lm_params_nbytes(TP) == jm.lm_params_nbytes(JP)
    assert pm.lm_generate(sharded, [3, 17, 5], 10) == pm.lm_generate(TP, [3, 17, 5], 10)


def test_shard_lm_params_validates_like_jax():
    with pytest.raises(ValueError, match="not divisible"):
        pm.shard_lm_params(TP, 3)
    with pytest.raises(ValueError, match=">= 1"):
        pm.shard_lm_params(TP, 0)


# -- builders and the decode function ------------------------------------------


def test_lm_builder_reads_env_contract(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_LLM_SEED", "7")
    monkeypatch.setenv("HOROVOD_SERVE_LLM_DIM", "8")
    p = pm.lm_builder(None, device="cpu")
    assert p["dim"] == 8
    assert np.array_equal(p["embed"].numpy(),
                          jm.lm_builder(None)["embed"])
    got = pm.lm_builder({"lm_params": JP}, device="cpu")
    assert torch.equal(got["wo"], torch.from_numpy(JP["wo"]))


def _flax_mlp(features, in_features, batch=5):
    import jax

    from horovod_tpu.models import MLP

    model = MLP(features=features)
    x = np.random.RandomState(0).randn(batch, in_features).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return model, params, x


@pytest.mark.parametrize("features", [(24, 7), (32, 16, 8)])
def test_mlp_builder_serves_flax_weights_like_jax(features):
    model, params, x = _flax_mlp(features, 12)
    want = np.asarray(model.apply({"params": params}, x))
    apply_fn = pm.mlp_builder({"params": params}, device="cpu")
    with torch.no_grad():
        got = apply_fn(x).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= RTOL
    jout = np.asarray(jm.mlp_builder({"params": params})(x))
    assert _rel(got, jout) <= RTOL


def test_mlp_builder_takes_the_port_state_dict():
    from horovod_tpu_torch.models.cnn_layers import init_cnn
    from horovod_tpu_torch.models.mlp import MLP

    model = MLP(features=(16, 4), in_features=6)
    init_cnn(model, torch.Generator().manual_seed(0))
    x = torch.randn(3, 6, generator=torch.Generator().manual_seed(1))
    apply_fn = pm.mlp_builder({"params": model.state_dict()}, device="cpu")
    with torch.no_grad():
        assert torch.equal(apply_fn(x), model(x))
    with pytest.raises(ValueError, match="no Dense"):
        pm.mlp_builder({"params": {"Conv_0": {"kernel": np.ones((3, 3))}}},
                       device="cpu")


@pytest.mark.parametrize("steps", [1, 4])
def test_make_decode_fn_runs_k_steps_and_counts_shapes(steps):
    def step(x):
        return torch.tanh(x) * 1.5 + 0.25

    fn = pm.make_decode_fn(step, steps=steps, device="cpu")
    x = np.linspace(-1, 1, 12).astype(np.float32).reshape(3, 4)
    want = torch.from_numpy(x)
    for _ in range(steps):
        want = step(want)
    assert torch.equal(fn(x), want)
    fn(x)
    fn(np.zeros((5, 4), np.float32))
    assert fn.compiles == 2     # distinct shapes (captures on the card)
    with pytest.raises(ValueError):
        pm.make_decode_fn(step, steps=0)


def test_decode_fn_matches_jax_scan():
    import jax.numpy as jnp

    x = np.linspace(-1, 1, 12).astype(np.float32).reshape(3, 4)
    scanned = jm.make_decode_fn(lambda v: jnp.tanh(v) * 1.5 + 0.25, steps=4)
    fn = pm.make_decode_fn(lambda v: torch.tanh(v) * 1.5 + 0.25, 4, "cpu")
    assert _rel(fn(x), np.asarray(scanned(x))) <= RTOL


def test_shard_batch_moves_to_the_device():
    out = pm.shard_batch(np.ones((2, 3), np.float32), "cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


def test_load_for_serving_refuses_raw_training_checkpoint(tmp_path):
    from horovod_tpu_torch import checkpoint

    checkpoint.save(str(tmp_path / "train"), {"params": {"w": torch.ones(2)},
                                              "opt_state": {"m": torch.ones(2)}})
    with pytest.raises(ValueError, match="export_for_inference"):
        pm.load_for_serving(str(tmp_path / "train"))
    checkpoint.export_for_inference(str(tmp_path / "serve"),
                                    {"params": {"w": torch.ones(2)},
                                     "opt_state": {"m": torch.ones(2)}})
    assert list(pm.load_for_serving(str(tmp_path / "serve"))) == ["params"]


def test_resolve_builder_spec_errors():
    assert pm.resolve_builder(
        "horovod_tpu_torch.serving.model:mlp_builder") is pm.mlp_builder
    with pytest.raises(ValueError):
        pm.resolve_builder("no_colon")
    with pytest.raises(ImportError):
        pm.resolve_builder("not_a_module_xyz:f")
    with pytest.raises(AttributeError):
        pm.resolve_builder("horovod_tpu_torch.serving.model:nope")


def test_exact_float32_reports_tf32_off():
    got = pm.exact_float32(torch.device("cpu"))
    assert got["allow_tf32"] is False
    assert got["float32_matmul_precision"] in ("highest", "high", "medium")


# -- no card: the entry points raise -------------------------------------------


def test_entry_points_raise_without_a_card(monkeypatch):
    from horovod_tpu_torch.serving import InferenceServer
    from horovod_tpu_torch.serving.config import LLMConfig, ServeConfig
    from horovod_tpu_torch.serving.llm import LLMServer, PagedKVCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ServeConfig.from_env(port=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMServer(config=cfg, llm_config=LLMConfig.from_env())
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceServer(config=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(4, 4, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.lm_builder(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.mlp_builder({"params": {}})
    # asked for the CPU, they build
    LLMServer(config=cfg, llm_config=LLMConfig.from_env(), device="cpu")
    assert not torch.cuda.is_initialized()
