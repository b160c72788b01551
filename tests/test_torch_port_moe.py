"""Mixture-of-experts and expert parallelism of the port against the JAX
package.

In one process, against ``horovod_tpu.ops.moe`` and
``horovod_tpu.models.moe``: ``top1_route`` exactly (tests/test_moe.py's
case and random logits); ``load_balancing_loss``; ``moe_apply`` with no
group against the JAX ``moe_apply`` on a one-device mesh and against the
dense per-token oracle; ``MoEMLP`` (outputs, the load-balancing loss, the
gradients of every parameter and of the input), also where tokens
overflow the capacity; ``TransformerLM(moe_experts=...)`` at
tests/test_moe.py's shapes (vocab 32, dim 16, 2 heads, 2 layers): logits,
the loss with 0.01 x the load-balancing loss, every gradient; remat
against no remat; the converter's MoE leaves and the flatten order;
``ep_param_specs``.

A 4-rank gloo world (tests/torch_port_tp_worker.py, ``ep``): ``moe_apply``
over the world against the JAX ``moe_apply`` on a 4-device ``ep`` mesh,
tests/test_moe.py's cases (generous capacity against the dense oracle,
capacity drops, gradients, the fast case) and ``_moe_ep_step``'s shapes;
the expert-sharded ``MoEMLP`` and TransformerLM against the unsharded
ones.

Routing is an argmax: the tests compare ``expert``, ``pos`` and ``keep``
of each case exactly first, so that a flip would show as such.

Tolerances: routing exact; float32 outputs, losses and gradients 1e-5
(atol and rtol; the JAX side at highest matmul precision), against the
dense oracle rtol 1e-4 (the reference's).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import test_moe as ref
from horovod_tpu.compat import shard_map
from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu.models.moe import MoEMLP as JaxMoEMLP, ep_param_specs as jax_ep_specs
from horovod_tpu.ops import moe as jmoe
from horovod_tpu_torch import convert
from horovod_tpu_torch.models.moe import (MoEMLP, ep_merge_state_dicts,
                                          ep_param_specs, ep_state_dict)
from horovod_tpu_torch.models.transformer import TransformerLM, init_weights, lm_loss
from horovod_tpu_torch.ops import moe
from test_torch_port_tensor import _launch, _lookup, _np, world_of_one  # noqa: F401

TOL, ORACLE_RTOL, AUX = 1e-5, 1e-4, 0.01
EP = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=msg)


# ---------------------------------------------------------------- routing

def test_top1_route_positions():
    """tests/test_moe.py::test_top1_route_positions."""
    logits = [[9.0, 0.0], [9.0, 0.0], [0.0, 9.0], [9.0, 0.0]]
    expert, prob, pos, keep = moe.top1_route(torch.tensor(logits), capacity=2)
    assert expert.tolist() == [0, 0, 1, 0]
    assert pos.tolist() == [0, 1, 0, 2]
    assert keep.tolist() == [True, True, True, False]
    assert float(prob[0]) > 0.99


@pytest.mark.parametrize("capacity", [1, 5, 64])
def test_top1_route_matches_jax(capacity):
    logits = np.random.default_rng(capacity).standard_normal((64, 8)).astype(np.float32)
    want = jmoe.top1_route(jnp.asarray(logits), capacity)
    got = moe.top1_route(_t(logits), capacity)
    for g, w, name in zip(got, want, ("expert", "prob", "pos", "keep")):
        if name == "prob":
            _close(g.numpy(), w, name)
        else:
            assert np.array_equal(g.numpy(), np.asarray(w)), name


def test_load_balancing_loss():
    """Uniform routing gives 1 (tests/test_moe.py), and random logits the
    JAX value."""
    t, e = 64, 8
    expert = np.arange(t) % e
    logits = np.eye(e, dtype=np.float32)[expert] * 20.0
    assert float(moe.load_balancing_loss(_t(logits), _t(expert), e)) == \
        pytest.approx(1.0, abs=0.05)
    logits = np.random.default_rng(0).standard_normal((t, e)).astype(np.float32)
    expert = logits.argmax(-1)
    _close(moe.load_balancing_loss(_t(logits), _t(expert), e).numpy(),
           jmoe.load_balancing_loss(jnp.asarray(logits), jnp.asarray(expert), e))


# ---------------------------------------------------------- moe_apply, ep 1

def _params(seed, experts=ref.EXPERTS, dim=ref.DIM, hidden=ref.HIDDEN, ep=EP):
    return _np(jmoe.init_moe_params(jax.random.PRNGKey(seed), dim, hidden,
                                    experts, ep))


def test_moe_apply_without_group_matches_jax_and_the_oracle():
    params = _params(6)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (16, ref.DIM)))
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("ep",))
    with jax.default_matmul_precision("highest"):
        want = ref.run_ep(mesh, jmoe.MoEParams(*params), jnp.asarray(x), 16)
        oracle = ref.dense_oracle(jmoe.MoEParams(*params), jnp.asarray(x))
    got = moe.moe_apply(moe.MoEParams(*map(_t, params)), _t(x), 16).numpy()
    _close(got, want)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL, rtol=ORACLE_RTOL)


# ------------------------------------------------------------------ MoEMLP

MLP = dict(dim=16, hidden=32, n_experts=4)
MLP_CASES = {"random": 1.25, "overflow": 0.5, "identical": 1.25}


def _mlp_input(case):
    rng = np.random.default_rng(11)
    if case == "identical":
        return np.tile(rng.standard_normal((1, 1, 16)), (2, 8, 1)).astype(np.float32)
    return rng.standard_normal((2, 8, 16)).astype(np.float32)


def _jax_mlp(cf, x):
    mlp = JaxMoEMLP(**MLP, capacity_factor=cf, dtype=jnp.float32)
    params = _np(mlp.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])

    def loss_fn(p, x):
        out, inter = mlp.apply({"params": p}, x, mutable=["intermediates"])
        lb = inter["intermediates"]["moe_lb_loss"][0]
        return jnp.mean(out ** 2) + AUX * lb, (out, lb)

    with jax.default_matmul_precision("highest"):
        (_, (out, lb)), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return params, np.asarray(out), float(lb), _np(grads)


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_moe_mlp_matches_jax(case):
    cf, x = MLP_CASES[case], _mlp_input(case)
    params, out, lb, (pgrads, xgrad) = _jax_mlp(cf, x)
    mlp = MoEMLP(**MLP, capacity_factor=cf, dtype=torch.float32)
    mlp.load_state_dict({k: _t(v) for k, v in params.items()})
    tokens = x.reshape(-1, 16)
    cap = mlp.capacity(tokens.shape[0])
    want_route = jmoe.top1_route(jnp.asarray(tokens) @ params["gate"], cap)
    got_route = moe.top1_route(_t(tokens) @ mlp.gate.detach(), cap)
    for g, w in zip(got_route[::2], want_route[::2]):       # expert, pos
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got_route[3].numpy(), np.asarray(want_route[3]))
    xt = _t(x).requires_grad_(True)
    got = mlp(xt)
    (got.square().mean() + AUX * mlp.lb_loss).backward()
    _close(got.detach().numpy(), out, "out")
    _close(mlp.lb_loss.item(), lb, "lb")
    _close(xt.grad.numpy(), xgrad, "x")
    for k, p in mlp.named_parameters():
        _close(p.grad.numpy(), pgrads[k], k)
    dropped = int(mlp.dropped)
    assert dropped == int((~np.asarray(want_route[3])).sum())
    if case != "random":
        assert dropped > 0, "the case must overflow the capacity"


def test_ep_group_of_one_is_the_plain_layer(world_of_one):
    """An expert group of one rank makes no call: the layer of
    ``MoEMLP()``, bit for bit."""
    import horovod_tpu_torch as hvd

    group = hvd.sharded_groups(1, 1, 1).model_group
    x = torch.from_numpy(_mlp_input("random"))
    runs = []
    for ep_group in (None, group):
        mlp = MoEMLP(**MLP, dtype=torch.float32, ep_group=ep_group)
        init_weights(mlp, torch.Generator().manual_seed(5))
        xt = x.clone().requires_grad_(True)
        out = mlp(xt)
        out.square().mean().backward()
        runs.append([out, xt.grad, *(p.grad for p in mlp.parameters())])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ----------------------------------------------------- the MoE TransformerLM

LM = dict(vocab=32, dim=16, heads=2, layers=2)


def _lm_tokens(kind):
    if kind == "ones":
        return np.ones((2, 8), np.int32)
    return np.random.default_rng(2).integers(0, 32, (2, 8)).astype(np.int32)


def _jax_lm(experts, tokens, attention="dense"):
    model = JaxLM(**LM, moe_experts=experts, dtype=jnp.float32)
    params = _np(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"])

    def loss_fn(p):
        logits, inter = model.apply({"params": p}, tokens, mutable=["intermediates"])
        task = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(tokens, -1, axis=1)).mean()
        lb = sum(jnp.asarray(v).sum() for v in
                 jax.tree_util.tree_leaves(inter["intermediates"]))
        return task + AUX * lb, (logits, lb)

    with jax.default_matmul_precision("highest"):
        (loss, (logits, lb)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    return params, float(loss), np.asarray(logits), float(lb), _np(grads)


def _port_lm(params, experts, **kw):
    model = TransformerLM(**LM, moe_experts=experts, dtype=torch.float32, **kw)
    model.load_state_dict(convert.transformer_state_dict_from_jax(
        params, model.state_dict().keys()))
    return model


def _port_loss(model, tokens):
    tokens = torch.from_numpy(tokens.astype(np.int64))
    logits = model(tokens)
    lb = model.moe_lb_loss()
    loss = lm_loss(logits, tokens) + AUX * lb
    loss.backward()
    return loss, logits, lb


def _hold_grads(model, grads):
    for n, p in model.named_parameters():
        _close(convert.to_flax_layout(n, p.grad), _lookup(grads, convert.flax_path(n)), n)


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("tokens", ["ones", "random"])
@pytest.mark.parametrize("experts", [2, 4])
def test_moe_transformer_matches_jax(experts, tokens, attention):
    tok = _lm_tokens(tokens)
    params, loss, logits, lb, grads = _jax_lm(experts, tok)
    model = _port_lm(params, experts, attention=attention)
    got_loss, got_logits, got_lb = _port_loss(model, tok)
    _close(got_logits.detach().numpy(), logits, "logits")
    _close(got_lb.item(), lb, "lb")
    _close(got_loss.item(), loss, "loss")
    _hold_grads(model, grads)
    assert len(model.moe_lb_losses) == 1      # layers 2, moe_every 2


def test_moe_remat_reads_the_forward_lb_loss():
    """Under remat the backward reruns each block's forward, which sets the
    layer's ``lb_loss`` again; the model's list keeps the forward's, and
    loss and gradients equal the run without remat."""
    tok = _lm_tokens("random")
    params, *_ = _jax_lm(4, tok)
    runs = []
    for remat in (False, True):
        model = _port_lm(params, 4, remat=remat)
        loss, _, lb = _port_loss(model, tok)
        runs.append((loss.item(), lb.item(),
                     {n: p.grad for n, p in model.named_parameters()}))
        if remat:
            assert model.moe_lb_losses[0] is not model.blocks[1].moe.lb_loss
    (la, ba, ga), (lr, br, gr) = runs
    assert la == lr and ba == br
    for n in ga:
        _close(gr[n].numpy(), ga[n].numpy(), n)


def test_converter_round_trips_the_moe_leaves():
    model = JaxLM(**LM, moe_experts=4, moe_every=1, dtype=jnp.float32)
    params = _np(model.init(jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))["params"])
    port = TransformerLM(**LM, moe_experts=4, moe_every=1)
    sd = convert.transformer_state_dict_from_jax(params, port.state_dict().keys())
    port.load_state_dict(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    order = [tuple(k.key for k in path) for path, _ in flat]
    named = convert.jax_ordered(port.named_parameters())
    assert [convert.flax_path(n) for n, _ in named] == order
    for (n, p), (_, leaf) in zip(named, flat):
        assert np.array_equal(convert.to_flax_layout(n, p), np.asarray(leaf, np.float64)), n
    assert sum(".moe." in n for n, _ in named) == 6


def test_ep_param_specs_match_jax():
    model = JaxLM(**LM, moe_experts=4, dtype=jnp.float32)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.ones((1, 8), jnp.int32))["params"]
    specs = jax_ep_specs(params, "ep")
    got = ep_param_specs(TransformerLM(**LM, moe_experts=4))
    for name, dim in got.items():
        spec = _lookup(specs, convert.flax_path(name))
        assert dim == (0 if spec == P("ep", None, None) else None), name
        assert spec in (P("ep", None, None), P())
    assert sum(d is not None for d in got.values()) == 2
    port = TransformerLM(**LM, moe_experts=4)
    init_weights(port, torch.Generator().manual_seed(0))
    full = port.state_dict()
    parts = [ep_state_dict(full, 4, r) for r in range(4)]
    assert parts[1]["blocks.1.moe.w_in"].shape == (1, 16, 64)
    back = ep_merge_state_dicts(parts)
    assert all(torch.equal(back[k], full[k]) for k in full)


# ------------------------------------------------------------ the ep world

EP_CASES = {
    # name: (params seed, x seed, tokens per rank, capacity, experts, identical)
    "generous": (0, 1, ref.TOKENS, ref.TOKENS, ref.EXPERTS, False),
    "fast": (6, 7, 4, 4 * EP, ref.EXPERTS, False),
    "drops": (2, 3, ref.TOKENS, 1, ref.EXPERTS, True),
    "grads": (4, 5, ref.TOKENS, ref.TOKENS, ref.EXPERTS, False),
    "graft step": (0, 1, 8, 8, 2 * EP, False),
}
EP_MLP = dict(dim=16, hidden=32, n_experts=8)
EP_LM = {"ones 4": (4, "ones"), "random 8": (8, "random")}


def _ep_case(name):
    ps, xs, tpr, cap, experts, identical = EP_CASES[name]
    params = _params(ps, experts=experts)
    if identical:
        x = np.tile(np.asarray(jax.random.normal(jax.random.PRNGKey(xs), (1, ref.DIM))),
                    (tpr * EP, 1))
    else:
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(xs), (tpr * EP, ref.DIM)))
    return params, x, cap


def _jax_ep(mesh, params, x, cap):
    def body(w_in, w_out, gate, x):
        def loss(w_in, w_out, gate, x):
            out = jmoe.moe_apply(jmoe.MoEParams(gate, w_in, w_out), x, cap, "ep")
            return jnp.mean(out ** 2)

        g = jax.grad(loss, argnums=(0, 1, 2, 3))(w_in, w_out, gate, x)
        return g[0], g[1], g[2][None], g[3]

    with jax.default_matmul_precision("highest"):
        out = ref.run_ep(mesh, jmoe.MoEParams(*params), jnp.asarray(x), cap)
        grads = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(P("ep"), P("ep"), P(), P("ep")),
            out_specs=(P("ep"),) * 4, check_vma=False))(
                params.w_in, params.w_out, params.gate, jnp.asarray(x))
    return np.asarray(out), dict(zip(("w_in", "w_out", "gate", "x"), _np(grads)))


@pytest.fixture(scope="module")
def ep_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_world")
    mesh = Mesh(np.asarray(jax.devices()[:EP]), ("ep",))
    inputs, want, cases = {}, {}, []
    for name in EP_CASES:
        params, x, cap = _ep_case(name)
        for k, v in zip(("gate", "w_in", "w_out"), params):
            inputs[f"ep/{name}/{k}"] = np.asarray(v, np.float32)
        inputs[f"ep/{name}/x"] = np.asarray(x, np.float32)
        cases.append({"name": name, "capacity": cap})
        want[f"ep/{name}"] = _jax_ep(mesh, params, x, cap)
        with jax.default_matmul_precision("highest"):
            want[f"oracle/{name}"] = np.asarray(ref.dense_oracle(
                jmoe.MoEParams(*params), jnp.asarray(x))) \
                if experts_of(name) == ref.EXPERTS else None
    inputs["ep_cases"] = np.array(json.dumps(cases))

    x = _mlp_input("random")
    mlp = JaxMoEMLP(**EP_MLP, dtype=jnp.float32)
    params = _np(mlp.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"])

    def mlp_loss(p, x):
        out, inter = mlp.apply({"params": p}, x, mutable=["intermediates"])
        lb = inter["intermediates"]["moe_lb_loss"][0]
        return jnp.mean(out ** 2) + AUX * lb, (out, lb)

    with jax.default_matmul_precision("highest"):
        (_, (out, lb)), grads = jax.value_and_grad(
            mlp_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    want["moe"] = (np.asarray(out), float(lb), _np(grads))
    inputs.update({f"moe/{k}": v for k, v in params.items()})
    inputs["moe/x"] = x
    inputs["moe_cfg"] = np.array(json.dumps(EP_MLP))

    lm_cases = []
    for name, (experts, kind) in EP_LM.items():
        tok = _lm_tokens(kind)
        params, loss, logits, lb, grads = _jax_lm(experts, tok)
        port = TransformerLM(**LM, moe_experts=experts)
        sd = convert.transformer_state_dict_from_jax(params, port.state_dict().keys())
        inputs.update({f"eplm/{name}/{k}": v.numpy() for k, v in sd.items()})
        inputs[f"eplm_tokens/{name}"] = tok.astype(np.int64)
        lm_cases.append({"name": name, **LM, "moe_experts": experts})
        want[f"eplm/{name}"] = (loss, logits, lb, grads)
    inputs["eplm_cases"] = np.array(json.dumps(lm_cases))
    np.savez(tmp / "in.npz", **inputs)
    return inputs, want, _launch(EP, "ep", tmp / "in.npz", tmp / "out")


def experts_of(name):
    return EP_CASES[name][4]


@pytest.mark.parametrize("name", sorted(EP_CASES))
def test_ep_routing_matches_jax(name):
    """Every rank's routing of its tokens, exactly, before any value is
    compared."""
    params, x, cap = _ep_case(name)
    for xr in np.split(x, EP):
        want = jmoe.top1_route(jnp.asarray(xr) @ params.gate, cap)
        got = moe.top1_route(_t(xr) @ _t(params.gate), cap)
        for i in (0, 2, 3):
            assert np.array_equal(got[i].numpy(), np.asarray(want[i]))


@pytest.mark.parametrize("name", sorted(EP_CASES))
def test_ep_moe_apply_matches_jax(ep_world, name):
    _, want, got = ep_world
    out, grads = want[f"ep/{name}"]
    per = out.shape[0] // EP
    for r in range(EP):
        _close(got[r][f"ep/{name}/out"], out[r * per:(r + 1) * per], f"out {r}")
        for k in ("w_in", "w_out", "x"):
            n = grads[k].shape[0] // EP
            _close(got[r][f"ep/{name}/grad/{k}"], grads[k][r * n:(r + 1) * n], f"{k} {r}")
        _close(got[r][f"ep/{name}/grad/gate"], grads["gate"][r], f"gate {r}")
    oracle = want[f"oracle/{name}"]
    if oracle is not None and name != "drops":
        full = np.concatenate([got[r][f"ep/{name}/out"] for r in range(EP)])
        np.testing.assert_allclose(full, oracle, atol=TOL, rtol=ORACLE_RTOL)
    if name == "drops":
        # capacity 1 and one expert for all: only each rank's token 0 kept
        for r in range(EP):
            rows = got[r][f"ep/{name}/out"]
            assert [t for t in range(per) if np.abs(rows[t]).max() > 0] == [0]
    if name == "grads":
        assert any(np.abs(got[r][f"ep/{name}/grad/w_in"]).max() > 0 for r in range(EP))


def test_ep_moe_mlp_matches_unsharded(ep_world):
    """Experts sharded over 4 ranks, tokens and gate replicated: the layer
    of the unsharded model (JAX's, and the port's own). 6 experts do not
    shard over 4 ranks: ValueError."""
    _, want, got = ep_world
    assert all(bool(g["moe/indivisible_raises"]) for g in got)
    out, lb, (pgrads, xgrad) = want["moe"]
    locals_ = []
    for r in range(EP):
        for tag in ("ep", "whole"):
            _close(got[r][f"moe/{tag}/out"], out, f"{tag} out {r}")
            _close(float(got[r][f"moe/{tag}/lb"]), lb, f"{tag} lb {r}")
            _close(got[r][f"moe/{tag}/grad/x"], xgrad, f"{tag} x {r}")
            _close(got[r][f"moe/{tag}/grad/gate"], pgrads["gate"], f"{tag} gate {r}")
        locals_.append({k: torch.from_numpy(got[r][f"moe/ep/grad/{k}"])
                        for k in ("w_in", "w_out")})
    merged = torch.cat([sd["w_in"] for sd in locals_]), \
        torch.cat([sd["w_out"] for sd in locals_])
    _close(merged[0].numpy(), pgrads["w_in"], "w_in")
    _close(merged[1].numpy(), pgrads["w_out"], "w_out")


@pytest.mark.parametrize("name", sorted(EP_LM))
def test_ep_transformer_matches_unsharded(ep_world, name):
    _, want, got = ep_world
    loss, logits, lb, grads = want[f"eplm/{name}"]
    prefix = f"eplm/{name}/grad/"
    for r in range(EP):
        _close(got[r][f"eplm/{name}/logits"], logits, f"logits {r}")
        _close(float(got[r][f"eplm/{name}/lb"]), lb, f"lb {r}")
        _close(float(got[r][f"eplm/{name}/loss"]), loss, f"loss {r}")
    full = ep_merge_state_dicts([{k[len(prefix):]: torch.from_numpy(v)
                                  for k, v in g.items() if k.startswith(prefix)}
                                 for g in got])
    for n, t in full.items():
        _close(convert.to_flax_layout(n, t), _lookup(grads, convert.flax_path(n)), n)


def test_ep_build_model_cuts_the_whole_models_weights(ep_world):
    """``build_model(ep_group=)`` on 4 ranks: the experts put together are
    the whole model's, drawn from the same seed."""
    from test_torch_port_tensor import built_whole

    _, _, got = ep_world
    merged = ep_merge_state_dicts(
        [{k[len("built/"):]: torch.from_numpy(v) for k, v in g.items()
          if k.startswith("built/")} for g in got])
    whole = built_whole()
    assert merged.keys() == whole.keys()
    for n, t in whole.items():
        assert torch.equal(merged[n], t), n
