"""Tensor parallelism of the port against the JAX package.

In one process: ``tp_pair_slices``/``tp_local_pairs`` exactly, with the
reference's ValueErrors; ``dense_apply`` and ``tp_wire_bytes_per_pair``
against the JAX functions; ``tp_param_specs`` against the JAX layout on
the MHA, GQA and MoE TransformerLM; ``tp_state_dict`` cutting q, k and v
each by heads, and its inverse; the ValueErrors of the TP model; a
virtual world of 4 (each rank's ``attn_partial``/``mlp_partial`` summed in
place of the reduce, as chip_smoke's phase 17 sums them on the card)
against the whole block; the model on a model group of one against the
flat model, bit for bit and with no collective.

A 4-rank gloo world (tests/torch_port_tp_worker.py, ``tp``) against the
reference tests' cases (tests/test_tensor_parallel.py) at model sizes 1,
2 and 4 (batch 4 / model), as the reference sweeps its 8-device mesh:
forward and backward of integer-valued payloads, one pair and a chain,
bit for bit against the JAX dense oracle; generic floats through tanh;
the naive control; the collectives per pair (the two pairs of the
reference's trajectory test); model = 1 on a 2x2x1 layout
against the 2-D 2x2 plan; then the TransformerLM at tp = 4 with full
weights cut by ``tp_state_dict`` (the ``__graft_entry__._transformer_tp_step``
shapes: vocab 64, dim 64, 4 heads, 2 layers, float32; and GQA, 8 q heads
over 4 kv heads), dense and flash, against the JAX TransformerLM on the
full weights, and at tp = 2 with data parallelism over 2 batch groups
(the flat optimizer and the broadcast over the batch group) against the
whole model. An 8-rank world (``cube``): the 2x2x2 cube against the JAX
``_train_dp_pairs`` oracle.

Tolerances:
- slices, specs, state dicts, integer payloads: exact (every product and
  sum of small integers is exact in float32, so any difference is a
  routing or transpose fault);
- generic floats through tanh: atol = rtol = 1e-6 (the reference's pin:
  the reassociated hidden sum is the only rounding difference);
- the naive control: exactly model_size x the dense slice gradient;
- model = 1 on 2x2x1 against 2x2: bit for bit (no collective on the
  model group, the same plan and arithmetic);
- the TransformerLM, loss and every gradient reassembled from the ranks:
  1e-5 (atol and rtol; the JAX side at highest matmul precision; dense
  attention on the JAX side, as tests/test_torch_port_model.py does, the
  port's flash path running its kernels' plain versions on the CPU);
- the virtual world of 4 against the whole block: 1e-5;
- tp = 2 x dp 2, 5 SGD steps, against the whole model in one process:
  1e-5; the replicas and the replicated leaves bit for bit;
- the cube against dense data parallelism: 2e-5 (the reference's pin), the
  replicated ``b_row`` bit for bit across model ranks.
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
import torch

import horovod_tpu_torch as hvd
import test_tensor_parallel as ref
from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu.models.transformer import tp_param_specs as jax_tp_specs
from horovod_tpu.parallel import tensor as jtp
from horovod_tpu_torch import convert
from horovod_tpu_torch.models.transformer import (
    TransformerLM, init_weights, lm_loss, tp_merge_state_dicts, tp_param_specs,
    tp_state_dict)
from horovod_tpu_torch.parallel import tensor as tp
from launch_util import REPO, free_port

WORKER = os.path.join(REPO, "tests", "torch_port_tp_worker.py")
PAIR_KEYS = ("b_col", "b_row", "w_col", "w_row")
MODEL_SIZES = (1, 2, 4)
GENERIC_TOL, LM_TOL, CUBE_TOL = 1e-6, 1e-5, 2e-5
LM_CASES = {
    "mha dense": dict(vocab=64, dim=64, heads=4, layers=2, attention="dense"),
    "mha flash": dict(vocab=64, dim=64, heads=4, layers=2, attention="flash"),
    "gqa dense": dict(vocab=64, dim=64, heads=8, kv_heads=4, layers=2,
                      attention="dense"),
    "gqa flash": dict(vocab=64, dim=64, heads=8, kv_heads=4, layers=2,
                      attention="flash"),
}
LM_T = 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(pair):
    return {k: torch.from_numpy(np.array(v)) for k, v in pair.items()}


# ------------------------------------------------------------ one process

def test_pair_slices_match_jax():
    rng = np.random.RandomState(0)
    pair = _np(ref.int_pair(rng, 4, 8, 3))
    for m in (1, 2, 4, 8):
        want = jtp.tp_pair_slices(pair, m)
        got = tp.tp_pair_slices(_torch(pair), m)
        assert len(got) == len(want) == m
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert np.array_equal(g[k].numpy(), np.asarray(w[k])), (m, k)
    no_bias = {"w_col": pair["w_col"], "w_row": pair["w_row"]}
    assert sorted(tp.tp_pair_slices(_torch(no_bias), 2)[0]) == ["w_col", "w_row"]


@pytest.mark.parametrize("bad,m", [
    ("model", 0), ("hidden", 3), ("pair", 2)])
def test_pair_slice_errors_match_jax(bad, m):
    rng = np.random.RandomState(0)
    pair = _np(ref.int_pair(rng, 4, 8, 3))
    if bad == "pair":
        pair["w_row"] = pair["w_row"][:6]
    with pytest.raises(ValueError) as want:
        jtp.tp_pair_slices(pair, m)
    with pytest.raises(ValueError) as got:
        tp.tp_pair_slices(_torch(pair), m)
    assert str(got.value) == str(want.value)


def test_local_and_rank_pairs_match_jax():
    pairs = _np(ref._make_pairs())
    for m in (1, 2, 4):
        want = jtp.tp_local_pairs(pairs, m)
        got = tp.tp_local_pairs([_torch(p) for p in pairs], m)
        for r in range(m):
            mine = tp.tp_rank_pairs([_torch(p) for p in pairs], m, r)
            for i in range(len(pairs)):
                for k in PAIR_KEYS:
                    assert np.array_equal(got[r][i][k].numpy(), np.asarray(want[r][i][k]))
                    assert torch.equal(mine[i][k], got[r][i][k])


@pytest.mark.parametrize("final", [None, "tanh"])
def test_dense_apply_matches_jax(final):
    pairs = _np(ref._make_pairs())
    x = np.array(jax.random.normal(jax.random.PRNGKey(5), (4, 12)))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jtp.dense_apply(pairs, x, final_activation=final and jnp.tanh))
    tpairs = [_torch(p) for p in pairs]
    got = tp.dense_apply(tpairs, torch.from_numpy(x),
                         final_activation=final and torch.tanh).numpy()
    np.testing.assert_allclose(got, want, atol=GENERIC_TOL, rtol=GENERIC_TOL)
    # Without a group the TP stack is the dense arithmetic, bit for bit.
    alone = tp.tp_apply(tpairs, torch.from_numpy(x),
                        final_activation=final and torch.tanh).numpy()
    assert np.array_equal(alone, got)


def test_wire_bytes_match_jax():
    for batch, d_out, jd, td in ((8, 12, jnp.float32, torch.float32),
                                 (4096, 32000, jnp.bfloat16, torch.bfloat16)):
        assert tp.tp_wire_bytes_per_pair(batch, d_out, td) == \
            jtp.tp_wire_bytes_per_pair(batch, d_out, jd)


def _jax_spec_dim(spec):
    """flax's PartitionSpec on an (in, out) kernel as the port's dim."""
    if spec == jax.sharding.PartitionSpec(None, "tp"):
        return 0
    if spec == jax.sharding.PartitionSpec("tp", None):
        return 1
    assert spec == jax.sharding.PartitionSpec(), spec
    return None


@pytest.mark.parametrize("kw,cut", [(dict(heads=4), 9),
                                    (dict(heads=8, kv_heads=2), 11),
                                    (dict(heads=4, moe_experts=2), 7)],
                         ids=["mha", "gqa", "moe"])
def test_tp_param_specs_match_jax(kw, cut):
    model = JaxLM(vocab=64, dim=64, layers=2, dtype=jnp.float32, **kw)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.ones((1, 8), jnp.int32))["params"]
    specs = jax_tp_specs(params, "tp")
    got = tp_param_specs(TransformerLM(vocab=64, dim=64, layers=2, **kw))
    for name, dim in got.items():
        spec = specs
        for key in convert.flax_path(name):
            spec = spec[key]
        assert dim == _jax_spec_dim(spec), name
    assert sum(d is not None for d in got.values()) == cut


def _full_model(**kw):
    model = TransformerLM(vocab=64, dim=64, layers=2, dtype=torch.float32, **kw)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("kw", [dict(heads=4), dict(heads=8, kv_heads=4)],
                         ids=["mha", "gqa"])
def test_state_dict_cuts_each_of_qkv_by_heads(kw):
    full = _full_model(**kw).state_dict()
    locals_ = [tp_state_dict(full, 4, r) for r in range(4)]
    merged = tp_merge_state_dicts(locals_)
    assert all(torch.equal(merged[k], full[k]) for k in full)
    hd = 64 // kw["heads"]
    name = "blocks.0.qkv.weight" if "kv_heads" not in kw else "blocks.0.kv_proj.weight"
    fused = full[name].chunk(3 if "kv_heads" not in kw else 2)
    per = fused[0].shape[0] // 4
    assert per % hd == 0
    for r, sd in enumerate(locals_):
        want = torch.cat([t[r * per:(r + 1) * per] for t in fused])
        assert torch.equal(sd[name], want)
        assert torch.equal(sd["lm_head.weight"], full["lm_head.weight"][:, r * 16:(r + 1) * 16])
        assert torch.equal(sd["embed.weight"], full["embed.weight"])
    with pytest.raises(ValueError, match="equal slices"):
        tp_state_dict(full, 3, 0)


def test_tp_model_errors():
    # kv_heads < tp keeps kv_proj whole (each rank reads one kv head), so
    # it builds where tp is a multiple of kv_heads and raises elsewhere.
    TransformerLM(vocab=64, dim=64, heads=8, kv_heads=2, layers=1, tp_size=4)
    with pytest.raises(ValueError, match="either must divide the other"):
        TransformerLM(vocab=64, dim=96, heads=12, kv_heads=4, layers=1, tp_size=6)
    with pytest.raises(ValueError, match="divide by the tensor-parallel size 3"):
        TransformerLM(vocab=64, dim=96, heads=4, layers=1, tp_size=3)
    model = TransformerLM(vocab=64, dim=64, heads=4, layers=1, tp_size=2,
                          dtype=torch.float32)
    with pytest.raises(ValueError, match="tp_group"):
        model.blocks[0](torch.zeros(1, 4, 64), torch.arange(4)[None])


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_virtual_tp_world_matches_whole_block(attention):
    full = _full_model(heads=4, attention=attention)
    ranks = []
    for r in range(4):
        m = TransformerLM(vocab=64, dim=64, heads=4, layers=2, tp_size=4,
                          dtype=torch.float32, attention=attention)
        m.load_state_dict(tp_state_dict(full.state_dict(), 4, r))
        ranks.append(m.blocks[0])
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, LM_T, 64, generator=gen, requires_grad=True)
    pos = torch.arange(LM_T)[None]
    want = full.blocks[0](x, pos)
    g = torch.randn(want.shape, generator=gen)
    want_grads = torch.autograd.grad(want, [x] + list(full.blocks[0].parameters()), g)
    x1 = x + sum(b.attn_partial(x, pos) for b in ranks)
    got = x1 + sum(b.mlp_partial(x1) for b in ranks)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=LM_TOL, rtol=LM_TOL)
    params = [p for b in ranks for p in b.parameters()]
    grads = torch.autograd.grad(got, [x] + params, g)
    np.testing.assert_allclose(grads[0].numpy(), want_grads[0].numpy(),
                               atol=LM_TOL, rtol=LM_TOL)
    names = [n for n, _ in ranks[0].named_parameters()]
    per_rank = [dict(zip(names, grads[1 + i * len(names):1 + (i + 1) * len(names)]))
                for i in range(4)]
    for n, gw in zip(names, want_grads[1:]):
        if tp_param_specs(ranks[0]).get(n) is None:
            # replicated: each rank's partial gradient, summed
            gm = sum(sd[n] for sd in per_rank)
        else:
            gm = tp_merge_state_dicts([{f"blocks.0.{n}": sd[n]} for sd in per_rank])[
                f"blocks.0.{n}"]
        np.testing.assert_allclose(gm.numpy(), gw.numpy(), atol=LM_TOL, rtol=LM_TOL)


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR", "HOROVOD_MESH"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_model_group_of_one_is_the_flat_model(world_of_one):
    import torch.distributed as dist

    layout = hvd.sharded_groups(1, 1, 1)
    assert layout.model_group is not None and layout.model_size == 1
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, LM_T)))
    res = []
    calls = []
    saved = dist.all_reduce
    dist.all_reduce = lambda *a, **k: calls.append(1) or saved(*a, **k)
    try:
        for group in (None, layout.model_group):
            model = TransformerLM(vocab=64, dim=64, heads=4, layers=2,
                                  dtype=torch.float32, tp_group=group)
            init_weights(model, torch.Generator().manual_seed(0))
            logits = model(tokens)
            torch.nn.functional.cross_entropy(logits.reshape(-1, 64),
                                              tokens.reshape(-1)).backward()
            res.append((logits.detach(), [p.grad for p in model.parameters()]))
    finally:
        dist.all_reduce = saved
    assert calls == []
    assert torch.equal(res[0][0], res[1][0])
    assert all(torch.equal(a, b) for a, b in zip(res[0][1], res[1][1]))


# ------------------------------------------------------------ the worlds

def _launch(n, mode, inp, out, timeout=300):
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", TP_MODE=mode,
                   TP_IN=str(inp), TP_OUT=str(out), OMP_NUM_THREADS="1")
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                    "HOROVOD_MESH", "HOROVOD_SHARD_PARAMS", "HOROVOD_COMPRESSION",
                    "HOROVOD_FUSION_THRESHOLD", "HOROVOD_NUM_BUCKETS",
                    "HOROVOD_DCN_FUSION_THRESHOLD", "HOROVOD_COMPRESSION_MIN_BYTES"):
            env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    failures = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"rank {rank} exit {proc.returncode}:\n{err[-3000:]}")
    assert not failures, "\n".join(failures)
    return [dict(np.load(f"{out}.{rank}.npz")) for rank in range(n)]


def _put_pairs(inputs, prefix, pairs, x=None):
    inputs[f"{prefix}/n"] = np.array(len(pairs))
    for i, p in enumerate(pairs):
        for k, v in p.items():
            inputs[f"{prefix}/{i}/{k}"] = np.asarray(v, np.float32)
    if x is not None:
        inputs[f"{prefix}/x"] = np.asarray(x, np.float32)


def _jax_lm(case, tokens):
    kw = {k: v for k, v in case.items() if k != "attention"}
    model = JaxLM(**kw, dtype=jnp.float32)
    params = _np(jax.jit(model.init)(jax.random.PRNGKey(0),
                                     jnp.asarray(tokens))["params"])

    def loss_fn(p):
        logits = model.apply({"params": p}, tokens)
        targets = jnp.roll(tokens, -1, axis=1)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, targets).mean(), logits

    with jax.default_matmul_precision("highest"):
        (loss, logits), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    return params, float(loss), np.asarray(logits), _np(grads)


def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_world")
    inputs, want = {}, {}
    rng = np.random.RandomState(0)
    pair = _np(ref.int_pair(rng, 4, 8, 3))
    _put_pairs(inputs, "int_fwd", [pair], rng.randint(-2, 3, (5, 4)))
    rng = np.random.RandomState(0)
    pair = _np(ref.int_pair(rng, 4, 8, 3))
    _put_pairs(inputs, "int_bwd", [pair], rng.randint(-2, 3, (2, 4)))
    rng = np.random.RandomState(1)
    chain = [_np(ref.int_pair(rng, 4, 6, 4, lo=-2, hi=3)),
             _np(ref.int_pair(rng, 4, 8, 3, lo=-2, hi=3))]
    _put_pairs(inputs, "chain", chain, rng.randint(-2, 3, (3, 4)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    generic = [_np({"w_col": jax.random.normal(k1, (6, 8)) * 0.3,
                    "b_col": jnp.zeros((8,)),
                    "w_row": jax.random.normal(k2, (8, 6)) * 0.3,
                    "b_row": jnp.full((6,), 0.1)})]
    _put_pairs(inputs, "generic", generic,
               jax.random.normal(jax.random.PRNGKey(5), (4, 6)))
    train = _np(ref._make_pairs())
    x, y = ref._pairs_data(4)
    _put_pairs(inputs, "train", train)
    inputs["train/x"], inputs["train/y"] = np.asarray(x), np.asarray(y)

    dense = lambda ps, x: jnp.sum(jtp.dense_apply(ps, x, activation=None))  # noqa: E731
    want["fwd"] = np.asarray(jtp.dense_pair_apply(
        {k: inputs[f"int_fwd/0/{k}"] for k in PAIR_KEYS}, inputs["int_fwd/x"],
        activation=None))
    for name in ("int_bwd", "chain"):
        ps = [{k: inputs[f"{name}/{i}/{k}"] for k in PAIR_KEYS}
              for i in range(int(inputs[f"{name}/n"]))]
        want[name] = (ps, _np(jax.grad(dense)(ps, inputs[f"{name}/x"])))
    with jax.default_matmul_precision("highest"):
        want["generic"] = np.asarray(jtp.dense_apply(generic, inputs["generic/x"]))

    tokens = np.random.default_rng(7).integers(0, 64, (2, LM_T)).astype(np.int32)
    inputs["lm_tokens"] = tokens.astype(np.int64)
    cases = []
    for name, case in LM_CASES.items():
        params, loss, logits, grads = _jax_lm(case, tokens)
        full = TransformerLM(**case, dtype=torch.float32)
        sd = convert.transformer_state_dict_from_jax(params, full.state_dict().keys())
        for k, v in sd.items():
            inputs[f"lm/{name}/{k}"] = v.numpy()
        want[f"lm/{name}"] = (loss, logits, grads)
        cases.append({"name": name, **case})
    inputs["lm_cases"] = np.array(json.dumps(cases))
    dp_tokens = np.random.default_rng(8).integers(0, 64, (4, LM_T))
    inputs["dp_tokens"] = dp_tokens
    want["dptp"] = _sgd_whole(LM_CASES["mha dense"],
                              {k[len("lm/mha dense/"):]: v for k, v in inputs.items()
                               if k.startswith("lm/mha dense/")}, dp_tokens)
    np.savez(tmp / "in.npz", **inputs)
    return want, _launch(4, "tp", tmp / "in.npz", tmp / "out")


def _sgd_whole(case, state, tokens, steps=5):
    """The whole model, one process, the worker's SGD steps on all of
    ``tokens``: the mean of the two batch shards' mean losses."""
    model = TransformerLM(**case, dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    opt = torch.optim.SGD(model.parameters(), lr=0.1, foreach=True)
    tokens = torch.from_numpy(tokens)
    for _ in range(steps):
        opt.zero_grad()
        lm_loss(model(tokens), tokens).backward()
        opt.step()
    return {n: p.detach() for n, p in model.named_parameters()}


def _layout_ranks(m):
    """(global rank, model rank) of the first rank of each model index on
    the ``(4 / m, 1, m)`` layout, model minor."""
    return [(r, r % m) for r in range(4)]


@pytest.mark.parametrize("m", MODEL_SIZES)
def test_forward_bitwise_vs_dense(tp_world, m):
    want, got = tp_world
    for rank in range(4):
        assert ref.bitwise_equal(got[rank][f"fwd/{m}"], want["fwd"]), (m, rank)


@pytest.mark.parametrize("name,m", [("int_bwd", 1), ("int_bwd", 2), ("int_bwd", 4),
                                    ("chain", 1), ("chain", 2)])
def test_backward_bitwise_vs_dense(tp_world, m, name):
    """One pair, and a chain of two (whose first hidden dim, 6, cuts in 1
    and 2 only; the reference runs the chain at 2): the inter-pair
    cotangent arrives completed through copy_to_model's allreduce."""
    want, got = tp_world
    pairs, dgrad = want[name]
    for rank, r in _layout_ranks(m):
        for i, dg in enumerate(dgrad):
            mine = jtp.tp_pair_slices(dg, m)[r]
            for k in ("w_col", "b_col", "w_row"):
                assert ref.bitwise_equal(got[rank][f"{name}/{m}/{i}/{k}"], mine[k]), \
                    (m, rank, i, k)
            assert ref.bitwise_equal(got[rank][f"{name}/{m}/{i}/b_row"], dg["b_row"]), \
                f"pair{i}.b_row rank {rank}: the replicated gradient diverged"


@pytest.mark.parametrize("m", MODEL_SIZES)
def test_generic_floats_pinned(tp_world, m):
    want, got = tp_world
    for rank in range(4):
        np.testing.assert_allclose(got[rank][f"generic/{m}"], want["generic"],
                                   atol=GENERIC_TOL, rtol=GENERIC_TOL)


@pytest.mark.parametrize("m", MODEL_SIZES)
def test_naive_allreduce_transpose_scales_grads(tp_world, m):
    """The control: autograd's own allreduce, whose backward is another
    allreduce, scales the slice gradient by exactly the model size; the
    conjugate pair is what makes the gradients right."""
    want, got = tp_world
    _, dgrad = want["int_bwd"]
    for rank, r in _layout_ranks(m):
        dense = np.asarray(jtp.tp_pair_slices(dgrad[0], m)[r]["w_col"])
        naive = got[rank][f"naive/{m}/w_col"]
        assert np.array_equal(naive, dense * m)
        if m > 1:
            assert not np.array_equal(naive, dense)
            assert np.array_equal(got[rank][f"int_bwd/{m}/0/w_col"], dense)


@pytest.mark.parametrize("m", MODEL_SIZES)
def test_one_allreduce_per_pair_and_direction(tp_world, m):
    """Two pairs: one allreduce each forward, one each backward; none at
    model size 1."""
    _, got = tp_world
    for rank in range(4):
        assert int(got[rank][f"allreduces/{m}"]) == (0 if m == 1 else 4)


def test_model1_3d_bitwise_identical_to_2d(tp_world):
    _, got = tp_world
    for rank in range(4):
        rows = sorted(k for k in got[rank] if k.startswith("model1/3d/"))
        assert rows
        for k in rows:
            assert ref.bitwise_equal(got[rank][k], got[rank][k.replace("/3d/", "/2d/")]), \
                (rank, k)


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_tp_transformer_matches_jax(tp_world, name):
    want, got = tp_world
    loss, logits, grads = want[f"lm/{name}"]
    for rank in range(4):
        np.testing.assert_allclose(float(got[rank][f"lm/{name}/loss"]), loss,
                                   atol=LM_TOL, rtol=LM_TOL)
        np.testing.assert_allclose(got[rank][f"lm/{name}/logits"], logits,
                                   atol=LM_TOL, rtol=LM_TOL)
    prefix = f"lm/{name}/grad/"
    locals_ = [{k[len(prefix):]: torch.from_numpy(v) for k, v in g.items()
                if k.startswith(prefix)} for g in got]
    full = tp_merge_state_dicts(locals_)
    for n, t in full.items():
        want_g = np.asarray(_lookup(grads, convert.flax_path(n)))
        np.testing.assert_allclose(convert.to_flax_layout(n, t), want_g,
                                   atol=LM_TOL, rtol=LM_TOL, err_msg=n)
        if tp_param_specs(TransformerLM(**LM_CASES[name])).get(n) is None:
            for g in locals_[1:]:
                assert torch.equal(g[n], locals_[0][n]), \
                    f"{n}: replicated gradient differs across model ranks"


@pytest.fixture(scope="module")
def cube_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cube_world")
    pairs = ref._make_pairs()
    x, y = ref._pairs_data(4)
    inputs = {"train/x": np.asarray(x), "train/y": np.asarray(y)}
    _put_pairs(inputs, "train", _np(pairs))
    np.savez(tmp / "in.npz", **inputs)
    with jax.default_matmul_precision("highest"):
        want = _np(ref._train_dp_pairs(pairs, x, y, world=4, steps=5))
    return want, _launch(8, "cube", tmp / "in.npz", tmp / "out")


def test_cube_tracks_dense_dp(cube_world):
    """TP x ZeRO x DP on 2x2x2: 5 Adam steps against dense data
    parallelism over 4 ranks (the reference's
    test_tp_sharded_training_matches_dense_dp)."""
    want, got = cube_world
    by_model = {}
    for g in got:
        b, s, m = (int(c) for c in g["coords"])
        by_model.setdefault((b, s), {})[m] = g
    for (b, s), ranks in by_model.items():
        r0, r1 = ranks[0], ranks[1]
        for i, w in enumerate(want):
            assert ref.bitwise_equal(r0[f"cube/{i}.b_row"], r1[f"cube/{i}.b_row"]), \
                f"pair{i}.b_row diverged across model ranks at ({b}, {s})"
            np.testing.assert_allclose(
                np.concatenate([r0[f"cube/{i}.w_col"], r1[f"cube/{i}.w_col"]], -1),
                w["w_col"], atol=CUBE_TOL, rtol=CUBE_TOL)
            np.testing.assert_allclose(
                np.concatenate([r0[f"cube/{i}.b_col"], r1[f"cube/{i}.b_col"]]),
                w["b_col"], atol=CUBE_TOL, rtol=CUBE_TOL)
            np.testing.assert_allclose(
                np.concatenate([r0[f"cube/{i}.w_row"], r1[f"cube/{i}.w_row"]], 0),
                w["w_row"], atol=CUBE_TOL, rtol=CUBE_TOL)
            np.testing.assert_allclose(r0[f"cube/{i}.b_row"], w["b_row"],
                                       atol=CUBE_TOL, rtol=CUBE_TOL)
    # every (batch, shard) replica holds the same parameters
    first = got[0]
    for g in got:
        if int(g["coords"][2]) == 0:
            for k in first:
                if k.startswith("cube/"):
                    assert np.array_equal(g[k], first[k]), k


def test_tp_with_data_parallel_batch_groups(tp_world):
    """tp = 2 with data parallelism over 2 batch groups (2x1x2):
    ``broadcast_parameters`` over the batch group makes the replicas one
    (the worker perturbs every replica but batch rank 0 first), and the
    flat ``DistributedOptimizer(group=batch_group)`` averages over it
    alone. 5 SGD steps against the whole model on the whole batch, 1e-5;
    the replicas bit for bit alike, the replicated leaves bit for bit
    alike across model ranks."""
    want, got = tp_world
    by = {tuple(int(c) for c in g["dptp/coords"]): g for g in got}
    prefix = "dptp/"
    local = {bm: {k[len(prefix):]: torch.from_numpy(v) for k, v in g.items()
                  if k.startswith(prefix) and k != "dptp/coords"}
             for bm, g in by.items()}
    for m in (0, 1):
        for n in local[(0, m)]:
            assert torch.equal(local[(0, m)][n], local[(1, m)][n]), (m, n)
    specs = tp_param_specs(TransformerLM(**LM_CASES["mha dense"]))
    for n, dim in specs.items():
        if dim is None:
            assert torch.equal(local[(0, 0)][n], local[(0, 1)][n]), n
    full = tp_merge_state_dicts([local[(0, 0)], local[(0, 1)]])
    for n, t in full.items():
        np.testing.assert_allclose(t.numpy(), want["dptp"][n].numpy(),
                                   atol=LM_TOL, rtol=LM_TOL, err_msg=n)


def built_whole():
    """``train.build_model`` of the workers' small config, whole."""
    from horovod_tpu_torch import train as T

    config = T.TrainConfig(vocab=64, dim=64, heads=4, layers=2, seq=16,
                           dtype="float32")
    return T.build_model(config, "cpu", moe_experts=4).state_dict()


def test_build_model_cuts_the_whole_models_weights(tp_world):
    """``build_model(tp_group=)`` on 4 ranks: the ranks' states put
    together are the whole model's, drawn from the same seed."""
    _, got = tp_world
    locals_ = [{k[len("built/"):]: torch.from_numpy(v) for k, v in g.items()
                if k.startswith("built/")} for g in got]
    whole = built_whole()
    merged = tp_merge_state_dicts(locals_)
    assert merged.keys() == whole.keys()
    for n, t in whole.items():
        assert torch.equal(merged[n], t), n
