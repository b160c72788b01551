"""Pipeline parallelism of the port against the JAX package
(``horovod_tpu.parallel.pipeline``, ``horovod_tpu.models.pipeline_lm``).

In one process: ``split_lm_params``/``merge_lm_params``/``stage_state_dict``
and the converters against JAX's stacked layout, element for element
(tests/test_pipeline.py's round trip); the tick schedule; ``PPermute`` in
a group of one (no P2P call, the identity gradient); the reference's
NotImplementedError for MoE, message and all; zero activations through a
stage's blocks (RMSNorm at eps 1e-6) finite; a pp group of one against
the flat TransformerLM: 3 Adam steps at ``n_micro = 1`` bit for bit with
no P2P call, dense and flash, and loss and gradients at ``n_micro = 2``.

A 4-rank gloo world (tests/torch_port_pp_worker.py, ``cpu4``): the layouts
of ``training_groups`` against ``training_mesh``'s device order; at pp = 4
``pipeline_apply`` against the JAX ``pipeline_apply`` on a 4-device mesh
at the reference tests' shapes (DIM 16, 8 layers, 4 microbatches of 2):
outputs, gradients of the masked loss, bubble isolation; the pipelined
TransformerLM (the ``__graft_entry__._pipeline_pp_step`` shapes: vocab 64,
dim 32, 4 heads, 8 layers, 4 microbatches of 2, T 8, float32), dense and
flash, against JAX's ``pipeline_lm_loss_and_grads``; pp 2 x sp 2
(tests/test_pipeline.py's composition case: 2 layers, 2 microbatches of 2,
T 16, local-roll targets), dense and flash, each rank against its device
on a ``('pp', 'sp')`` mesh; pp 2 x dp 2 through ``train.setup_pipeline``,
3 Adam steps, against the flat whole-model DP step on the same global
batch. A 2-rank world (``cpu2``): the reference's fast two-stage gradient
case. The JAX side runs at ``default_matmul_precision("highest")`` with
the Pallas kernels in interpret mode; the port's flash path runs its
kernels' plain versions on the CPU.

Tolerances:
- layouts, state dicts, converters, schedule: exact;
- ``pipeline_apply`` outputs and gradients: atol = rtol = 1e-5 (the
  reference's); bubble isolation: the other microbatches bit for bit (the
  reference allows 1e-6), the changed one different;
- the pipelined TransformerLM at pp = 4: loss and every gradient 1e-5;
  pp x sp: loss and every gradient 2e-5 (the reference's pin for the
  composition);
- pp = 1, n_micro = 1 against the flat step: bit for bit (the same
  operations on the same rows); n_micro = 2: 1e-5 (the gradients sum over
  microbatches in another order);
- pp 2 x dp 2 against flat DP: losses and parameters 1e-5; the outer
  parameters bit for bit across stages and replicas.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
import test_pipeline as ref
from horovod_tpu.compat import shard_map
from horovod_tpu.models import TransformerLM as JaxLM
from horovod_tpu.models import pipeline_lm as jplm
from horovod_tpu.parallel import pipeline as jpipe
from horovod_tpu.parallel.mesh import training_mesh
from horovod_tpu_torch import convert
from horovod_tpu_torch import train as T
from horovod_tpu_torch.models.pipeline_lm import (
    PipelineStage, merge_lm_params, merge_stage_state_dicts,
    pipeline_lm_loss_and_grads, split_lm_params, stage_state_dict)
from horovod_tpu_torch.models.transformer import TransformerLM, init_weights, lm_loss
from horovod_tpu_torch.parallel.collectives import PPermute
from horovod_tpu_torch.parallel.pipeline import pipeline_ticks
from launch_util import REPO, free_port

WORKER = os.path.join(REPO, "tests", "torch_port_pp_worker.py")
TOL, PPSP_TOL = 1e-5, 2e-5
ATTENTIONS = ("dense", "flash")
LM = dict(vocab=64, dim=32, heads=4)
LM_LAYERS, LM_MICRO, LM_MB, LM_T = 8, 4, 2, 8           # _pipeline_pp_step
PPSP_LAYERS, PPSP_MICRO, PPSP_MB, PPSP_T = 2, 2, 2, 16  # test_pipeline.py:183
TRAIN = dict(vocab=64, dim=32, heads=4, layers=4, seq=8, batch=4)
LAYOUTS = ((1, 4, 1), (2, 2, 1), (1, 2, 2))
DEFAULTS = ((4, 1), (2, 2), (1, 4))
P2P = ("batch_isend_irecv", "isend", "irecv", "send", "recv")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(got, want, tol, where):
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                atol=tol, rtol=tol, err_msg=where),
        got, want)


def _jax_params(layers, tokens, attention, **kw):
    model = JaxLM(**LM, layers=layers, dtype=jnp.float32, attention=attention, **kw)
    seq = JaxLM(**LM, layers=layers, dtype=jnp.float32, attention=attention)
    return model, _np(jax.jit(seq.init)(jax.random.PRNGKey(0), tokens[0])["params"])


# ------------------------------------------------------------ one process

def test_split_merge_and_stage_dicts_match_jax_layout():
    tokens = np.ones((1, 1, 8), np.int32)
    _, params = _jax_params(4, tokens, "dense")
    model = TransformerLM(**LM, layers=4, dtype=torch.float32)
    full = convert.transformer_state_dict_from_jax(params, model.state_dict().keys())
    outer, blocks = split_lm_params(full, 4)
    j_outer, j_blocks = _np(jplm.split_lm_params(params, 4))
    for name, t in list(outer.items()) + [(f"blocks.0.{k}", v) for k, v in blocks.items()]:
        layer, path = convert.stacked_flax_path(name)
        want = convert._lookup(j_outer if layer is None else j_blocks, path)
        got = t.numpy()
        if path[-1] == "kernel":
            got = np.swapaxes(got, -1, -2)
        assert np.array_equal(got, want), name
    back = merge_lm_params(outer, blocks, 4)
    assert back.keys() == full.keys()
    assert all(torch.equal(back[k], full[k]) for k in full)
    stages = []
    for s in range(2):
        sd = stage_state_dict(full, 2, s)
        names = PipelineStage(**LM, layers=2, dtype=torch.float32).state_dict().keys()
        assert sd.keys() == names
        from_jax = convert.stage_state_dict_from_jax(j_outer, j_blocks, names, 2, s)
        assert all(torch.equal(sd[k], from_jax[k]) for k in names)
        assert torch.equal(sd["blocks.1.qkv.weight"], full[f"blocks.{2 * s + 1}.qkv.weight"])
        stages.append(sd)
    merged = merge_stage_state_dicts(stages)
    assert merged.keys() == full.keys()
    assert all(torch.equal(merged[k], full[k]) for k in full)
    s_outer, s_blocks = convert.stages_to_stacked_jax(stages)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
                           (s_outer, s_blocks), (j_outer, j_blocks))
    with pytest.raises(ValueError, match="equal stages"):
        stage_state_dict(full, 3, 0)


@pytest.mark.parametrize("n_micro,n_stages", [(4, 4), (1, 1), (2, 3), (5, 2)])
def test_tick_schedule_is_the_reference_scan(n_micro, n_stages):
    """Stage 0 ingests min(t, n_micro - 1); the last stage collects
    t - (n_stages - 1) when it is >= 0 (``pipeline_apply``'s scan)."""
    got = pipeline_ticks(n_micro, n_stages)
    assert len(got) == n_micro + n_stages - 1
    for t, (ingest, collect) in enumerate(got):
        m = t - (n_stages - 1)
        assert ingest == min(t, n_micro - 1)
        assert collect == (m if m >= 0 else None)
    assert sorted(c for _, c in got if c is not None) == list(range(n_micro))


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "HOROVOD_COORD_ADDR", "HOROVOD_MESH",
              "HOROVOD_SHARD_PARAMS"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


class CountP2P:
    """Count ``torch.distributed``'s point-to-point calls in the block."""

    def __init__(self):
        self.calls, self.saved = [], {}

    def __enter__(self):
        for name in P2P:
            fn = self.saved[name] = getattr(dist, name)
            setattr(dist, name, lambda *a, _fn=fn, _n=name, **k:
                    self.calls.append(_n) or _fn(*a, **k))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def test_ppermute_in_a_group_of_one_calls_nothing(world_of_one):
    group = hvd.training_groups(1, 1).pp_group
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=gen, requires_grad=True)
    g = torch.randn(3, 5, generator=gen)
    with CountP2P() as count:
        y = PPermute.apply(x, [(0, 0)], group)
        y.backward(g)
    assert count.calls == []
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert torch.equal(x.grad, g)


def test_moe_refused_as_the_reference_refuses():
    moe = JaxLM(**LM, layers=2, dtype=jnp.float32, moe_experts=2)
    with pytest.raises(NotImplementedError) as want:
        jplm.pipeline_lm_logits(moe, None, None, jnp.ones((1, 1, 8), jnp.int32))
    with pytest.raises(NotImplementedError) as got:
        PipelineStage(**LM, layers=2, moe_experts=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_zero_activations_stay_finite(attention):
    """Bubble ticks feed zeros into a stage: RMSNorm at eps 1e-6 keeps
    them, and their gradients, finite."""
    stage = PipelineStage(**LM, layers=2, dtype=torch.float32, attention=attention)
    init_weights(stage, torch.Generator().manual_seed(0))
    assert all(b.norm1.eps == 1e-6 and b.norm2.eps == 1e-6 for b in stage.blocks)
    x = torch.zeros(2, 8, 32, requires_grad=True)
    h = x
    for block in stage.blocks:
        h = block(h, torch.arange(8)[None])
    stage.norm(h).sum().backward()
    assert torch.isfinite(h).all() and torch.isfinite(x.grad).all()
    assert all(torch.isfinite(p.grad).all() for p in stage.parameters()
               if p.grad is not None)


def _config(attention):
    return T.TrainConfig(**TRAIN, dtype="float32", attention=attention)


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_pp_group_of_one_is_the_flat_step_bit_for_bit(world_of_one, attention):
    """``setup_pipeline(pp=1, n_micro=1)`` against ``setup`` (the flat
    step): 3 Adam steps, every loss and parameter bit for bit, and no P2P
    call."""
    config = _config(attention)
    tokens = T.make_batch(config, 0, "cpu")
    s = T.setup_pipeline(config, 1, 1, device="cpu")
    assert (s.layout.pp_size, s.layout.dp_size) == (1, 1)
    with CountP2P() as count:
        losses = [s.step(tokens).item() for _ in range(3)]
    assert count.calls == []
    flat = T.setup(config, "cpu")
    want = [flat.step(tokens).item() for _ in range(3)]
    assert losses == want
    got = dict(s.stage.named_parameters())
    for name, p in flat.model.named_parameters():
        assert torch.equal(got[name], p), name


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_pp_group_of_one_microbatched_matches_flat(world_of_one, attention):
    config = _config(attention)
    tokens = T.make_batch(config, 0, "cpu")
    stage = T.build_pipeline_stage(config, hvd.training_groups(1, 1).pp_group, "cpu")
    loss, grads = pipeline_lm_loss_and_grads(stage, tokens.reshape(2, 2, -1))
    flat = T.build_model(config, "cpu")
    want = lm_loss(flat(tokens), tokens)
    want.backward()
    np.testing.assert_allclose(loss.item(), want.item(), atol=TOL, rtol=TOL)
    for name, p in flat.named_parameters():
        np.testing.assert_allclose(grads[name].numpy(), p.grad.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=name)


# ------------------------------------------------------------ the worlds

def _launch(n, mode, inp, out, timeout=300):
    """``n`` worker ranks over gloo; a rank that hangs is killed at
    ``timeout`` and fails the test."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", PP_MODE=mode,
                   PP_IN=str(inp), PP_OUT=str(out), OMP_NUM_THREADS="1")
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                    "HOROVOD_MESH", "HOROVOD_SHARD_PARAMS", "HOROVOD_COMPRESSION",
                    "HOROVOD_FUSION_THRESHOLD", "HOROVOD_NUM_BUCKETS",
                    "HOROVOD_HIERARCHICAL_ALLREDUCE"):
            env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    failures = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            _, err = proc.communicate()
            failures.append(f"rank {rank} hung past {timeout} s")
        if proc.returncode != 0:
            failures.append(f"rank {rank} exit {proc.returncode}:\n{err[-3000:]}")
    assert not failures, "\n".join(failures)
    return [dict(np.load(f"{out}.{rank}.npz")) for rank in range(n)]


def _mlp_inputs(inputs, prefix, rng, layers, dim, n_micro, mb, zero=None):
    inputs[f"{prefix}/w"] = (rng.normal(size=(layers, dim, dim)) * 0.3).astype(np.float32)
    inputs[f"{prefix}/b"] = (rng.normal(size=(layers, dim)) * 0.1).astype(np.float32)
    inputs[f"{prefix}/micro"] = rng.normal(size=(n_micro, mb, dim)).astype(np.float32)
    inputs[f"{prefix}/target"] = np.full((n_micro, mb, dim), 0.1, np.float32)
    if zero is not None:
        inputs[f"{prefix}/micro2"] = inputs[f"{prefix}/micro"].copy()
        inputs[f"{prefix}/micro2"][zero] = 0.0


def _jax_mlp(inputs, prefix, n_stages):
    """JAX's pipeline_apply of the reference layer on an ``n_stages``
    mesh: the output, the gradients of the masked loss (stacked), and the
    output on ``micro2``."""
    mesh = Mesh(np.asarray(jax.devices()[:n_stages]), ("pp",))
    stacked = {"w": inputs[f"{prefix}/w"], "b": inputs[f"{prefix}/b"]}
    target = inputs[f"{prefix}/target"]

    def fwd(sp, micro):
        return jpipe.last_stage_value(jpipe.pipeline_apply(ref.layer_fn, sp, micro, "pp"),
                                      "pp")

    def pipe_loss(sp, micro):
        out = jpipe.pipeline_apply(ref.layer_fn, sp, micro, "pp")
        return jpipe.masked_last_stage_loss(jnp.mean((out - target) ** 2), "pp")

    run = jax.jit(shard_map(fwd, mesh=mesh, in_specs=(P("pp"), P()), out_specs=P(),
                            check_vma=False))
    grad = jax.jit(shard_map(jax.grad(pipe_loss), mesh=mesh, in_specs=(P("pp"), P()),
                             out_specs=P("pp"), check_vma=False))
    with jax.default_matmul_precision("highest"):
        want = {"out": np.asarray(run(stacked, inputs[f"{prefix}/micro"])),
                "grads": _np(grad(stacked, inputs[f"{prefix}/micro"]))}
        if f"{prefix}/micro2" in inputs:
            want["out2"] = np.asarray(run(stacked, inputs[f"{prefix}/micro2"]))
        layers = [{"w": w, "b": b} for w, b in zip(stacked["w"], stacked["b"])]
        want["seq"] = np.stack([np.asarray(ref.sequential(layers, m))
                                for m in inputs[f"{prefix}/micro"]])
    return want


def _expand(tree, n):
    return jax.tree_util.tree_map(lambda x: x[(None,) * n], tree)


def _jax_lm(inputs, prefix, mesh, axes, layers, tokens, attention, pp, **kw):
    """JAX's pipeline_lm_loss_and_grads on ``mesh``: (loss, outer grads,
    block grads), each with a leading dim per mesh axis (the value on
    every device); each stage's state dict into the inputs."""
    model, params = _jax_params(layers, tokens, attention, **kw)
    outer, blocks = _np(jplm.split_lm_params(params, layers))
    names = PipelineStage(**LM, layers=layers // pp, dtype=torch.float32) \
        .state_dict().keys()
    for s in range(pp):
        for k, v in convert.stage_state_dict_from_jax(outer, blocks, names, pp, s).items():
            inputs[f"{prefix}/s{s}/{k}"] = v.numpy()
    inputs[f"{prefix}/tokens"] = tokens.astype(np.int64)

    def fn(o, b, tok):
        loss, (og, bg) = jplm.pipeline_lm_loss_and_grads(model, o, b, tok, "pp")
        return _expand((loss, og, bg), len(axes))

    tok_spec = P(None, None, "sp") if "sp" in axes else P()
    run = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P(), P("pp"), tok_spec),
                            out_specs=P(*axes), check_vma=False))
    with jax.default_matmul_precision("highest"):
        return _np(run(outer, blocks, tokens))


@pytest.fixture(scope="module")
def pp_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_world")
    inputs, want = {}, {}
    rng = np.random.default_rng(0)
    _mlp_inputs(inputs, "mlp", rng, ref.N_LAYERS, ref.DIM, ref.N_MICRO, ref.MB, zero=1)
    want["mlp"] = _jax_mlp(inputs, "mlp", ref.N_STAGES)
    pp4 = Mesh(np.asarray(jax.devices()[:4]), ("pp",))
    ppsp = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("pp", "sp"))
    for attention in ATTENTIONS:
        tokens = rng.integers(0, 64, (LM_MICRO, LM_MB, LM_T)).astype(np.int32)
        want[f"lm/{attention}"] = _jax_lm(inputs, f"lm/{attention}", pp4, ("pp",),
                                          LM_LAYERS, tokens, attention, 4)
        tokens = rng.integers(0, 64, (PPSP_MICRO, PPSP_MB, PPSP_T)).astype(np.int32)
        want[f"ppsp/{attention}"] = _jax_lm(inputs, f"ppsp/{attention}", ppsp,
                                            ("pp", "sp"), PPSP_LAYERS, tokens,
                                            attention, 2, sp_axis="sp")
    for k, v in TRAIN.items():
        inputs[f"train/{k}"] = np.array(v)
    np.savez(tmp / "in.npz", **inputs)
    return want, _launch(4, "cpu4", tmp / "in.npz", tmp / "out")


@pytest.fixture(scope="module")
def pp2_world(tmp_path_factory):
    """The reference's fast case: 2 stages of one 4x4 layer, 2
    microbatches of 1."""
    tmp = tmp_path_factory.mktemp("pp2_world")
    inputs = {}
    _mlp_inputs(inputs, "fast", np.random.default_rng(9), 2, 4, 2, 1)
    want = _jax_mlp(inputs, "fast", 2)
    np.savez(tmp / "in.npz", **inputs)
    return want, _launch(2, "cpu2", tmp / "in.npz", tmp / "out")


def _mesh_ids(**sizes):
    mesh = training_mesh(**sizes, devices=jax.devices()[:4])
    return np.vectorize(lambda d: d.id)(mesh.devices), mesh.axis_names


def _axis_ranks(ids, pos, axis):
    index = list(pos)
    index[axis] = slice(None)
    return list(ids[tuple(index)])


@pytest.mark.parametrize("dp,pp,sp", LAYOUTS)
def test_training_groups_match_training_mesh(pp_world, dp, pp, sp):
    _, got = pp_world
    ids, names = _mesh_ids(dp=dp, pp=pp, sp=sp)
    axes = {a: names.index(a) for a in ("dp", "fsdp", "pp", "sp")}
    for rank in range(4):
        pos = [int(i[0]) for i in np.nonzero(ids == rank)]
        key = f"layout/{dp}x{pp}x{sp}"
        assert list(got[rank][f"{key}/index"]) == [pos[axes[a]] for a in axes]
        for a, axis in axes.items():
            assert list(got[rank][f"{key}/{a}"]) == _axis_ranks(ids, pos, axis), (rank, a)


@pytest.mark.parametrize("dp,fsdp", DEFAULTS)
def test_training_groups_defaults_unchanged(pp_world, dp, fsdp):
    """At pp = sp = 1 the (dp, fsdp) groups are the two-axis layout's:
    rank d * fsdp + f, dp groups ``range(f, world, fsdp)``."""
    _, got = pp_world
    for rank in range(4):
        d, f = rank // fsdp, rank % fsdp
        key = f"default/{dp}x{fsdp}"
        assert list(got[rank][f"{key}/index"]) == [d, f]
        assert list(got[rank][f"{key}/dp"]) == list(range(f, 4, fsdp))
        assert list(got[rank][f"{key}/fsdp"]) == list(range(d * fsdp, (d + 1) * fsdp))


def _stacked_grads(got, prefix, ranks):
    return {"w": np.concatenate([got[r][f"{prefix}/gw"] for r in ranks]),
            "b": np.concatenate([got[r][f"{prefix}/gb"] for r in ranks])}


def test_pipeline_apply_matches_jax(pp_world):
    want, got = pp_world
    for rank in range(4):
        np.testing.assert_allclose(got[rank]["mlp/out"], want["mlp"]["out"], atol=TOL,
                                   rtol=TOL)
        # and the sequential model's output, the reference's own oracle
        np.testing.assert_allclose(got[rank]["mlp/out"], want["mlp"]["seq"], atol=TOL,
                                   rtol=TOL)


def test_pipeline_apply_grads_match_jax(pp_world):
    want, got = pp_world
    _assert_tree_close(_stacked_grads(got, "mlp", range(4)), want["mlp"]["grads"], TOL,
                       "pipeline_apply gradients")


def test_pipeline_bubble_isolation(pp_world):
    """Microbatch 1 set to zero: the other microbatches' outputs stay bit
    for bit, microbatch 1's changes (as JAX's does)."""
    want, got = pp_world
    for rank in range(4):
        out, out2 = got[rank]["mlp/out"], got[rank]["mlp/out2"]
        assert np.array_equal(out[0], out2[0]) and np.array_equal(out[2:], out2[2:])
        assert not np.allclose(out[1], out2[1])
        np.testing.assert_allclose(out2, want["mlp"]["out2"], atol=TOL, rtol=TOL)


def test_pipeline_grads_fast_two_stages(pp2_world):
    want, got = pp2_world
    for rank in range(2):
        np.testing.assert_allclose(got[rank]["fast/out"], want["out"], atol=TOL, rtol=TOL)
    _assert_tree_close(_stacked_grads(got, "fast", range(2)), want["grads"], TOL,
                       "two-stage gradients")


def _at(tree, *index):
    """Device ``index``'s value of each leaf of a tree stacked over the
    mesh."""
    return jax.tree_util.tree_map(lambda x: x[index], tree)


def _port_grads(got, prefix, rank):
    return {k[len(f"{prefix}/grad/"):]: v for k, v in got[rank].items()
            if k.startswith(f"{prefix}/grad/")}


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_pipelined_transformer_matches_jax(pp_world, attention):
    want, got = pp_world
    prefix = f"lm/{attention}"
    loss, outer, blocks = want[prefix]
    for rank in range(4):
        np.testing.assert_allclose(float(got[rank][f"{prefix}/loss"]), loss[rank],
                                   atol=TOL, rtol=TOL)
    stages = [{k: torch.from_numpy(v) for k, v in _port_grads(got, prefix, r).items()}
              for r in range(4)]
    g_outer, g_blocks = convert.stages_to_stacked_jax(stages)
    stacked = jax.tree_util.tree_map(lambda x: x.reshape(-1, *x.shape[2:]), blocks)
    _assert_tree_close(g_blocks, stacked, TOL, f"{attention} block gradients")
    for rank in range(4):
        # psummed over pp: every stage holds the whole outer gradient.
        r_outer, _ = convert.stages_to_stacked_jax([stages[rank]])
        _assert_tree_close(r_outer, _at(outer, rank), TOL,
                           f"{attention} outer, rank {rank}")
    assert g_outer.keys() == outer.keys()


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_pp_x_sp_transformer_matches_jax(pp_world, attention):
    """Rank p * 2 + s against device (p, s) of the ('pp', 'sp') mesh: its
    shard's loss (psummed over pp) and its gradients."""
    want, got = pp_world
    prefix = f"ppsp/{attention}"
    loss, outer, blocks = want[prefix]
    for rank in range(4):
        p, s = divmod(rank, 2)
        np.testing.assert_allclose(float(got[rank][f"{prefix}/loss"]), loss[p, s],
                                   atol=PPSP_TOL, rtol=PPSP_TOL)
        g = {k: torch.from_numpy(v) for k, v in _port_grads(got, prefix, rank).items()}
        g_outer, g_blocks = convert.stages_to_stacked_jax([g])
        _assert_tree_close(g_outer, _at(outer, p, s), PPSP_TOL,
                           f"{attention} outer {rank}")
        _assert_tree_close(g_blocks, _at(blocks, p, s), PPSP_TOL,
                           f"{attention} blocks {rank}")


def _flat_dp(config, dp, steps):
    """The flat whole-model DP step in one process: each replica's batch
    through the model, the gradients summed then divided by ``dp`` (the
    DP average), Adam. Per step, each replica's loss."""
    model = T.build_model(config, "cpu")
    opt = T.adam(list(model.parameters()), config)
    batches = [T.make_batch(config, d, "cpu") for d in range(dp)]
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        step = []
        for tokens in batches:
            loss = lm_loss(model(tokens), tokens)
            loss.backward()
            step.append(loss.item())
        for p in model.parameters():
            p.grad.div_(dp)
        opt.step()
        losses.append(step)
    return np.array(losses), {n: p.detach() for n, p in model.named_parameters()}


def test_pp_x_dp_trainer_matches_flat_dp(pp_world):
    _, got = pp_world
    config = T.TrainConfig(**TRAIN, dtype="float32", attention="flash")
    losses, params = _flat_dp(config, 2, 3)
    by_index = {tuple(got[r]["train/index"]): got[r] for r in range(4)}
    assert sorted(by_index) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for d in range(2):
        for p in range(2):
            np.testing.assert_allclose(by_index[d, p]["train/losses"], losses[:, d],
                                       atol=TOL, rtol=TOL)
        stages = [{k[len("train/param/"):]: torch.from_numpy(v)
                   for k, v in by_index[d, p].items() if k.startswith("train/param/")}
                  for p in range(2)]
        merged = merge_stage_state_dicts(stages)
        assert merged.keys() == params.keys()
        for name, want in params.items():
            np.testing.assert_allclose(merged[name].numpy(), want.numpy(), atol=TOL,
                                       rtol=TOL, err_msg=name)
    for name in ("embed.weight", "norm.scale", "lm_head.weight"):
        first = got[0][f"train/param/{name}"]
        for rank in range(1, 4):
            assert np.array_equal(got[rank][f"train/param/{name}"], first), (name, rank)
