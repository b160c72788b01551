"""The port's CNN zoo against the JAX package's, on the CPU.

- Each model (ResNet-18 and ResNet-50 at 64x64, so both block types;
  ResNet-18 with the space-to-depth stem; VGG-16 at 64x64, which leaves
  2x2 before the flatten; Inception V3 at 96x96; MLP on 8x8x3 images;
  ConvNet at 28x28, 7x7 before the flatten), num_classes 10, on the same
  numpy-seeded NHWC images (NCHW views on the port's side) and labels,
  from the JAX model's weights converted by
  ``convert.cnn_state_dict_from_jax``: training-mode logits and loss, every
  parameter's gradient, the BatchNorm running statistics after the step,
  and eval-mode logits on the converted running statistics. Both sides
  run in float64 (JAX with 64-bit types enabled), the heads in float32 as
  both models fix them; test_float32_forward_matches_jax_float64 says why
  not in float32. The BatchNorm scales, biases and statistics and every
  bias are drawn from a numpy seed first: straight from a JAX init, the
  last BatchNorm scale of every residual branch is 0, so the gradients of
  the branch's convolutions are exactly 0 on both sides whatever the port
  does.
- The port's float32 forward, and ResNet-18 in bf16 against the JAX bf16
  model.
- The padding, pooling, space-to-depth, BatchNorm and init traps of the
  JAX models, each against flax or the JAX code.
- ResNet-50's fusion plan (from ``jax.eval_shape``) against the JAX plan.
- ``train_cnn`` and its pieces on the CPU.
- A 4-process gloo world (tests/torch_port_cnn_worker.py) of ResNet-18
  data parallelism against the JAX package's per-rank-statistics step of
  ``bench.py``, rebuilt on a 4-device virtual mesh.

Tolerances (float64 but for the float32 heads, whose rounding, ~1e-7,
sets the scale; JAX under highest matmul precision): logits and loss
|err| <= 1e-4 * max(1, max|ref|); each gradient relative norm error
<= 1e-4; the running statistics |err| <= 1e-5 * max|ref| of each tensor.
The port matches to ~2e-7 on an x86 CPU; a semantic slip (a pad on the
wrong side, a channel order, an unbiased variance) lands far above each
limit.
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
from flax import linen as flax_nn
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu import models as jzoo
from horovod_tpu.parallel import fusion as jax_fusion
from horovod_tpu_torch import convert, models
from horovod_tpu_torch.models import cnn_layers
from horovod_tpu_torch.models.resnet import space_to_depth
from horovod_tpu_torch.parallel import fusion
from horovod_tpu_torch.train_cnn import (CNNConfig, build_cnn, forward_macs,
                                         make_cnn_train_step, make_images,
                                         train_cnn)
from launch_util import REPO, free_port

LOGITS_TOL, GRAD_TOL, STATS_TOL, BF16_TOL = 1e-4, 1e-4, 1e-5, 2e-2

# name: (JAX model, port model, NHWC input shape); each factory takes the
# activation dtype.
CASES = {
    "resnet18": (lambda dt: jzoo.ResNet18(num_classes=10, dtype=dt),
                 lambda dt: models.ResNet18(num_classes=10, dtype=dt),
                 (4, 64, 64, 3)),
    "resnet50": (lambda dt: jzoo.ResNet50(num_classes=10, dtype=dt),
                 lambda dt: models.ResNet50(num_classes=10, dtype=dt),
                 (4, 64, 64, 3)),
    "resnet18_s2d": (
        lambda dt: jzoo.ResNet18(num_classes=10, dtype=dt, space_to_depth=True),
        lambda dt: models.ResNet18(num_classes=10, dtype=dt, space_to_depth=True),
        (4, 64, 64, 3)),
    "vgg16": (lambda dt: jzoo.VGG16(num_classes=10, dtype=dt),
              lambda dt: models.VGG16(num_classes=10, dtype=dt, image_size=64),
              (4, 64, 64, 3)),
    "inception_v3": (lambda dt: jzoo.InceptionV3(num_classes=10, dtype=dt),
                     lambda dt: models.InceptionV3(num_classes=10, dtype=dt),
                     (4, 96, 96, 3)),
    "mlp": (lambda dt: jzoo.MLP(dtype=dt),
            lambda dt: models.MLP(dtype=dt, in_features=8 * 8 * 3), (4, 8, 8, 3)),
    "convnet": (lambda dt: jzoo.ConvNet(dtype=dt), lambda dt: models.ConvNet(dtype=dt),
                (4, 28, 28)),
}
BN_CASES = [c for c in CASES if c not in ("mlp", "convnet")]


def _randomized(variables, seed):
    """The JAX init's variables with every BatchNorm scale drawn from
    [0.5, 1.5], every bias and running mean from N(0, 0.1^2) and every
    running variance from [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = path[-1].key
        leaf = np.asarray(leaf)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if key in ("bias", "mean"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, variables)


def _jax_case(model, x, y, params, stats):
    """Training-mode loss, logits, gradients and new batch statistics, and
    eval-mode logits, in one compiled call."""
    has_bn = bool(stats)

    def run(p, s):
        def loss_fn(p):
            if has_bn:
                logits, new = model.apply({"params": p, "batch_stats": s}, x,
                                          train=True, mutable=["batch_stats"])
                new = new["batch_stats"]
            else:
                logits, new = model.apply({"params": p}, x), {}
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
            return loss, (logits, new)

        (loss, (logits, new)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        evals = (model.apply({"params": p, "batch_stats": s}, x, train=False)
                 if has_bn else logits)
        return loss, logits, grads, new, evals

    with jax.default_matmul_precision("highest"):
        out = jax.jit(run)(params, stats)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_input(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the NCHW-shaped, channels-last tensor over it."""
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _port_model(model, params, stats):
    model.load_state_dict(convert.cnn_state_dict_from_jax(
        params, stats, model.state_dict().keys()))
    return model


def _port_case(model, x, y):
    """The port's eval-mode logits on the converted statistics, then one
    training-mode forward and backward."""
    xt, yt = _port_input(x), torch.from_numpy(y).long()
    with torch.no_grad():
        evals = model.eval()(xt)
    logits = model.train()(xt)
    loss = torch.nn.functional.cross_entropy(logits, yt)
    loss.backward()
    return dict(loss=loss.item(), logits=logits.detach().numpy(),
                evals=evals.numpy(),
                grads={n: p.grad for n, p in model.named_parameters()},
                state=dict(model.state_dict()))


def _setup(make_jax, shape, seed, has_bn):
    """A JAX model, numpy images and labels, and its randomized variables."""
    jmodel = make_jax(jnp.float32)
    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    y = rng.integers(0, 10, shape[0]).astype(np.int32)
    kwargs = {"train": False} if has_bn else {}
    variables = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(seed), x,
                                              **kwargs))(x)
    return x, y, _randomized(variables, seed)


def _run_case(name, seed=0):
    """Both models in float64 (JAX with 64-bit types enabled), from the
    same float32-drawn weights: see test_float32_gradients_are_not_comparable
    for why not in float32."""
    make_jax, make_port, shape = CASES[name]
    x, y, variables = _setup(make_jax, shape, seed, name in BN_CASES)
    params, stats = variables["params"], variables.get("batch_stats", {})
    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     (params, stats))
        loss, logits, grads, new_stats, evals = _jax_case(
            make_jax(jnp.float64), x.astype(np.float64), y, *f64)
    model = _port_model(make_port(torch.float64).double(), params, stats)
    return dict(want=dict(loss=loss, logits=logits, grads=grads, stats=new_stats,
                          evals=evals, params=params),
                got=_port_case(model, x.astype(np.float64), y))


_CACHE = {}


@pytest.fixture(scope="module")
def results():
    def get(name):
        if name not in _CACHE:
            _CACHE[name] = _run_case(name)
        return _CACHE[name]
    return get


def _hold_abs(got, want, tol, what):
    limit = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= limit, f"{what}: max abs err {err:.3e} > {limit:.3e}"


def _relnorm(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_and_loss_match_jax(results, name):
    r = results(name)
    _hold_abs(r["got"]["logits"], r["want"]["logits"], LOGITS_TOL, "logits")
    _hold_abs(r["got"]["loss"], r["want"]["loss"], LOGITS_TOL, "loss")


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_gradient_matches_jax(results, name):
    r = results(name)
    grads = r["got"]["grads"]
    assert len(grads) == len(jax.tree_util.tree_leaves(r["want"]["grads"]))
    for pname, g in grads.items():
        path = convert.cnn_param_path(pname)
        want = np.asarray(convert._lookup(r["want"]["grads"], path))
        got = convert.to_flax_layout(pname, g, convert.cnn_param_path)
        assert np.abs(want).max() > 0, f"{pname}: zero reference gradient"
        err = _relnorm(got, want)
        assert err <= GRAD_TOL, f"{pname}: relative norm error {err:.3e}"


@pytest.mark.parametrize("name", BN_CASES)
def test_batch_norm_statistics_after_a_step_match_jax(results, name):
    r = results(name)
    checked = 0
    for sname, t in r["got"]["state"].items():
        collection, path = convert.cnn_flax_path(sname)
        if collection != "batch_stats":
            continue
        want = np.asarray(convert._lookup(r["want"]["stats"], path))
        err = float(np.abs(t.numpy() - want).max())
        assert err <= STATS_TOL * np.abs(want).max(), (sname, err)
        checked += 1
    assert checked == len(jax.tree_util.tree_leaves(r["want"]["stats"]))


@pytest.mark.parametrize("name", BN_CASES)
def test_eval_mode_logits_match_jax(results, name):
    r = results(name)
    _hold_abs(r["got"]["evals"], r["want"]["evals"], LOGITS_TOL, "eval logits")
    # Eval mode reads the running statistics instead of the batch's.
    assert np.abs(r["want"]["evals"] - r["want"]["logits"]).max() > 1e-2


@pytest.mark.parametrize("name", sorted(CASES))
def test_names_cover_the_flax_trees(results, name):
    """Every parameter and statistic of the port has a flax leaf of the
    converted shape and every flax leaf has one port name; the parameters
    in ``jax_ordered`` order are the flax tree's flatten order."""
    r = results(name)
    _, make_port, _ = CASES[name]
    model = make_port(torch.float32)
    trees = {"params": r["want"]["params"], "batch_stats": r["want"]["stats"]}
    flat = {(c, tuple(k.key for k in path)): leaf
            for c, tree in trees.items()
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    mapped = {}
    for sname, t in model.state_dict().items():
        c, path = convert.cnn_flax_path(sname)
        mapped[(c, path)] = sname
        assert convert.to_flax_layout(sname, t, lambda n: path).shape == \
            np.shape(flat[(c, path)]), sname
    assert set(mapped) == set(flat)
    order = [n for n, _ in convert.jax_ordered(model.named_parameters(),
                                               convert.cnn_param_path)]
    want = [mapped[("params", tuple(k.key for k in path))] for path, _ in
            jax.tree_util.tree_flatten_with_path(trees["params"])[0]]
    assert order == want


def test_float32_forward_matches_jax_float64():
    """Why the parity above runs in float64. In float32 the two frameworks
    round at different places, so an activation that sits within rounding
    of 0 passes a ReLU on one side and not on the other, and the gradient
    below it differs by that pixel's share, which at these sizes is a large
    one. The JAX package's own float32 gradients are that far from its
    float64 ones (on an x86 CPU: ResNet-18 2.4e-3, VGG-16 2.1e-2, ResNet-50
    5.5e-2 relative norm, the worst tensor), and the port's are as far, so
    no float32 gradient can be held to 1e-4. The forward is continuous in
    the rounding: the port's float32 logits, loss and BatchNorm statistics
    are held to JAX's float64 ones at the float32 limits above."""
    make_jax, make_port, shape = CASES["resnet18"]
    x, y, variables = _setup(make_jax, shape, 3, True)
    p, s = variables["params"], variables["batch_stats"]
    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), (p, s))
        loss, logits, _, new_stats, evals = _jax_case(
            make_jax(jnp.float64), x.astype(np.float64), y, *f64)
    got = _port_case(_port_model(make_port(torch.float32), p, s), x, y)
    assert got["logits"].dtype == np.float32
    _hold_abs(got["logits"], logits, LOGITS_TOL, "logits")
    _hold_abs(got["evals"], evals, LOGITS_TOL, "eval logits")
    _hold_abs(got["loss"], loss, LOGITS_TOL, "loss")
    for sname, t in got["state"].items():
        collection, path = convert.cnn_flax_path(sname)
        if collection == "batch_stats":
            want = np.asarray(convert._lookup(new_stats, path))
            err = float(np.abs(t.numpy() - want).max())
            assert err <= STATS_TOL * np.abs(want).max(), (sname, err)


def test_resnet_bf16_matches_jax_bf16():
    """ResNet-18 in bf16 activations (float32 parameters and statistics)
    against the JAX model in bf16, from the same weights. The eval-mode
    logits, the loss and the running statistics after the step are held to
    JAX's by relative norm, <= 2e-2. The training-mode logits and the
    gradients are not: batch statistics over 16 values and the ReLU flips
    above make bf16 rounding noise large here (the JAX model's own bf16
    logits are 1.7e-2 from its float32 ones, its gradients 0.35, on an
    x86 CPU). So each is held to the float32 step, no farther from it than
    twice the JAX bf16 model's distance, or 2e-2: a port that rounded
    somewhere the JAX model does not (statistics or the head in bf16)
    would land several times farther."""
    make_jax, make_port, shape = CASES["resnet18"]
    x, y, variables = _setup(make_jax, shape, 7, True)
    p, s = variables["params"], variables["batch_stats"]
    ref = _jax_case(make_jax(jnp.float32), x, y, p, s)
    jbf = _jax_case(make_jax(jnp.bfloat16), x, y, p, s)
    got = _port_case(_port_model(make_port(torch.bfloat16), p, s), x, y)
    assert got["logits"].dtype == np.float32
    assert _relnorm(got["evals"], jbf[4]) <= BF16_TOL
    assert abs(got["loss"] - float(jbf[0])) <= BF16_TOL * abs(float(jbf[0]))
    for sname, t in got["state"].items():
        collection, path = convert.cnn_flax_path(sname)
        if collection == "batch_stats":
            want = np.asarray(convert._lookup(jbf[3], path))
            assert _relnorm(t.numpy(), want) <= BF16_TOL, sname

    names = list(got["grads"])

    def flat(tree):
        return np.concatenate([np.asarray(convert._lookup(
            tree, convert.cnn_param_path(n))).ravel() for n in names])

    port_grads = np.concatenate([convert.to_flax_layout(
        n, got["grads"][n], convert.cnn_param_path).ravel() for n in names])
    for what, port, jax_bf16, f32 in [
            ("logits", got["logits"], jbf[1], ref[1]),
            ("gradients", port_grads, flat(jbf[2]), flat(ref[2]))]:
        limit = max(BF16_TOL, 2 * _relnorm(jax_bf16, f32))
        assert _relnorm(port, f32) <= limit, what


# ------------------------------------------------------------ the traps

@pytest.mark.parametrize("size,kernel,strides,want", [
    (224, 7, 2, (2, 3)),     # ResNet's stem
    (32, 7, 2, (2, 3)),
    (56, 3, 2, (0, 1)),      # a 3x3/s2 on an even size, and the max-pool
    (57, 3, 2, (1, 1)),
    (112, 4, 1, (1, 2)),     # the space-to-depth stem
    (28, 5, 1, (2, 2)),
    (7, 1, 2, (0, 0)),
])
def test_same_pads_are_xla_same(size, kernel, strides, want):
    got = cnn_layers.same_pads((size,), (kernel,), (strides,))[0]
    xla = jax.lax.padtype_to_pads((size,), (kernel,), (strides,), "SAME")[0]
    assert got == tuple(xla) == want


@pytest.mark.parametrize("size", [8, 9])
def test_pools_match_flax(size):
    """SAME max-pool pads with -inf (all inputs negative here, so a 0 pad
    would win), SAME avg-pool counts the padded zeros."""
    rng = np.random.default_rng(size)
    x = -1.0 - rng.random((2, size, size, 3), dtype=np.float32)
    xt = _port_input(x)
    for port_pool, flax_pool, window, strides in [
            (cnn_layers.max_pool, flax_nn.max_pool, (3, 3), (2, 2)),
            (cnn_layers.avg_pool, flax_nn.avg_pool, (3, 3), (1, 1)),
            (cnn_layers.avg_pool, flax_nn.avg_pool, (3, 3), (2, 2))]:
        want = np.asarray(flax_pool(x, window, strides=strides, padding="SAME"))
        got = port_pool(xt, window, strides, "SAME").permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("strides", [(1, 1), (2, 2)])
@pytest.mark.parametrize("size", [8, 9])
def test_conv_same_and_channels_last_match_flax(size, strides):
    rng = np.random.default_rng(size + strides[0])
    x = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    conv = flax_nn.Conv(5, (3, 3), strides, padding="SAME")
    params = conv.init(jax.random.PRNGKey(0), x)["params"]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(conv.apply({"params": params}, x))
    port = cnn_layers.Conv2d(3, 5, (3, 3), strides, bias=True)
    port.load_state_dict({"weight": torch.from_numpy(
        np.asarray(params["kernel"]).transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(np.array(params["bias"]))})
    out = port(_port_input(x))
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_space_to_depth_channel_order_is_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 3)).astype(np.float32)
    n, h, w, c = x.shape
    want = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    want = want.reshape(n, h // 2, w // 2, 4 * c)
    got = space_to_depth(_port_input(x))
    assert got.shape == (n, 4 * c, h // 2, w // 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_batch_norm_uses_the_biased_variance_and_flax_momentum():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 5, 5), dtype=np.float32) * 3 + 1
    bn = cnn_layers.BatchNorm(6)
    cnn_layers.init_cnn(bn, torch.Generator().manual_seed(0))
    bn.running_mean.fill_(0.5)
    bn.running_var.fill_(2.0)
    y = bn(torch.from_numpy(x))
    mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))     # biased
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.9 * 0.5 + 0.1 * mean,
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * 2.0 + 0.1 * var,
                               rtol=1e-6)
    want = (x - mean[:, None, None]) / np.sqrt(var[:, None, None] + 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_init_zeroes_the_last_scale_of_every_branch_as_jax():
    config = CNNConfig(model="ResNet50", num_classes=10, image_size=32)
    model = build_cnn(config, "cpu")
    jinit = jax.jit(lambda x: jzoo.ResNet50(num_classes=10).init(
        jax.random.PRNGKey(0), x, train=False))(jnp.zeros((1, 32, 32, 3)))
    zero = [n for n, p in model.named_parameters() if n.endswith(".weight")
            and convert.cnn_param_path(n)[-1] == "scale" and not p.any()]
    want = [n for n, _ in model.named_parameters()
            if convert.cnn_param_path(n)[-1] == "scale"
            and not np.asarray(convert._lookup(jinit["params"],
                                               convert.cnn_param_path(n))).any()]
    assert zero == want and len(zero) == 16
    assert all(n.endswith("BatchNorm_2.weight") for n in zero)


def test_forward_macs_from_the_layer_shapes():
    # ConvNet at 28x28: two 5x5 convs, two Dense.
    want = (28 * 28 * 32 * 25 + 14 * 14 * 64 * 25 * 32 + 7 * 7 * 64 * 512
            + 512 * 10)
    assert forward_macs(models.ConvNet(), torch.zeros(1, 28, 28)) == want
    macs = forward_macs(models.ResNet50(dtype=torch.float32).eval(),
                        torch.zeros(1, 3, 224, 224))
    assert macs == 4_089_184_256    # ~4.1 G, the figure usually quoted


# ------------------------------------------------------- the bucket plan

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("threshold", [64 << 20, 1 << 20])
def test_resnet50_bucket_plan_matches_jax(threshold, k):
    params = jax.eval_shape(lambda x: jzoo.ResNet50().init(
        jax.random.PRNGKey(0), x, train=False),
        jnp.zeros((1, 224, 224, 3)))["params"]
    with torch.device("meta"):
        model = models.ResNet50()
    named = convert.jax_ordered(model.named_parameters(), convert.cnn_param_path)
    want = jax_fusion.build_plan(params, threshold, num_buckets=k)
    got = fusion.build_plan([p for _, p in named], threshold, num_buckets=k)
    assert [[(d.index, d.size) for d in b] for b in got.buckets] == \
        [[(d.index, d.size) for d in b] for b in want.buckets]
    assert sum(len(b) for b in got.buckets) == 161
    if threshold == 64 << 20 and k == 1:
        assert got.num_buckets == 2


# ----------------------------------------------------- the trainer, CPU

@pytest.fixture()
def cpu_world(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        monkeypatch.delenv(k, raising=False)
    yield
    hvd.shutdown()


SMALL = dict(model="ResNet18", num_classes=10, image_size=32, batch=4,
             dtype="float32")


def test_train_cnn_on_the_cpu_learns(cpu_world):
    result = train_cnn(CNNConfig(**SMALL), 4, device="cpu")
    assert result.images_per_step == 4 and result.num_buckets == 1
    assert result.params == 11_181_642
    assert all(np.isfinite(result.losses)) and len(result.step_s) == 4
    assert result.losses[-1] < result.losses[0]


def test_train_cnn_equals_its_pieces(cpu_world):
    """train_cnn is build_cnn + broadcasts + DistributedOptimizer(SGD) +
    make_cnn_train_step on make_images: the same losses, bit for bit."""
    config = CNNConfig(**SMALL, seed=4)
    losses = train_cnn(config, 3, device="cpu").losses
    model = build_cnn(config, "cpu")
    named = convert.jax_ordered(model.named_parameters(), convert.cnn_param_path)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        [p for _, p in named], lr=config.lr, momentum=0.9), named)
    step = make_cnn_train_step(model, opt)
    images, labels = make_images(config, 0, "cpu")
    assert [step(images, labels).item() for _ in range(3)] == losses


def test_make_images_draws_per_rank():
    config = CNNConfig(**SMALL)
    a, la = make_images(config, 0, "cpu")
    b, _ = make_images(config, 1, "cpu")
    again, la2 = make_images(config, 0, "cpu")
    assert a.shape == (4, 3, 32, 32) and a.dtype == torch.float32
    assert a.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(a, again) and torch.equal(la, la2)
    assert not torch.equal(a, b)
    assert a.std() > 0.9 and 0 <= la.min() and la.max() < 10
    c, _ = make_images(CNNConfig(**SMALL, channels_last=False), 0, "cpu")
    assert c.is_contiguous() and torch.equal(c, a)


def test_train_cnn_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cnn(CNNConfig(**SMALL), 1)
    assert not hvd.is_initialized()


def test_build_cnn_rejects_unknown_models():
    with pytest.raises(ValueError, match="MLP"):
        build_cnn(CNNConfig(model="MLP"), "cpu")


# ------------------------------------------- the data-parallel world, gloo

WORKER = os.path.join(REPO, "tests", "torch_port_cnn_worker.py")
N = 4
WIRES = ["none", "bf16"]
WORLD_CONFIG = dict(model="ResNet18", num_classes=10, image_size=64, batch=2,
                    dtype="float64", seed=5)
WORLD_THRESHOLD = 32 << 20      # 3 buckets of ResNet-18's float64 gradients
WORLD_STEPS = 2


def _jax_dp_steps(params, stats, x, y, wire):
    """``bench.py``'s step: per-rank BatchNorm statistics (a leading rank
    dim, sharded over the mesh, never averaged), SGD(0.01 x 4, momentum
    0.9) in the JAX DistributedOptimizer; WORLD_STEPS of it on a 4-device
    virtual mesh. Returns (losses, parameters after each step, statistics
    after the last with the rank dim)."""
    import horovod_tpu as hvd_tpu
    from horovod_tpu.compat import shard_map
    from horovod_tpu.parallel.mesh import HVD_AXIS as A

    model = CASES["resnet18"][0](jnp.float64)
    opt = hvd_tpu.jax.DistributedOptimizer(
        optax.sgd(0.01 * N, momentum=0.9), fusion_threshold=WORLD_THRESHOLD,
        compression=hvd_tpu.Compression.by_name(wire))

    def loss_fn(p, s, x, y):
        logits, new = model.apply({"params": p, "batch_stats": s}, x, train=True,
                                  mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return loss, new["batch_stats"]

    def train_step(p, s, o, x, y):
        local = jax.tree_util.tree_map(lambda t: t[0], s)
        (loss, local), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, local, x, y)
        updates, o = opt.update(grads, o, p)
        p = optax.apply_updates(p, updates)
        s = jax.tree_util.tree_map(lambda t: t[None], local)
        return p, s, o, jax.lax.pmean(loss, A)

    mesh = Mesh(np.asarray(jax.devices()[:N]), (A,))
    step = jax.jit(shard_map(train_step, mesh=mesh,
                             in_specs=(P(), P(A), P(), P(A), P(A)),
                             out_specs=(P(), P(A), P(), P()), check_vma=False))
    stats = jax.tree_util.tree_map(lambda t: np.broadcast_to(t, (N,) + t.shape), stats)
    o, losses, after = opt.init(params), [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(WORLD_STEPS):
            params, stats, o, loss = step(params, stats, o, x, y)
            losses.append(float(loss))
            after.append(jax.tree_util.tree_map(np.asarray, params))
    return losses, after, jax.tree_util.tree_map(np.asarray, stats)


def _flatten(tree, prefix):
    return {prefix + "/" + "/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def cnn_world(tmp_path_factory):
    """The JAX side, then the port's 4-rank gloo world on the same weights
    and images; returns (initial params, JAX results per wire, per-rank
    port results)."""
    tmp = tmp_path_factory.mktemp("cnn_world")
    config = CNNConfig(**WORLD_CONFIG)
    batches = [make_images(config, r, "cpu") for r in range(N)]
    x = np.concatenate([b[0].permute(0, 2, 3, 1).numpy() for b in batches])
    y = np.concatenate([b[1].numpy() for b in batches]).astype(np.int32)
    jmodel = CASES["resnet18"][0](jnp.float32)
    variables = _randomized(jax.jit(lambda x: jmodel.init(
        jax.random.PRNGKey(5), x, train=False))(x[:1]), 5)
    want = {}
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            (variables["params"], variables["batch_stats"]))
        for wire in WIRES:
            want[wire] = _jax_dp_steps(params, stats, x.astype(np.float64), y, wire)
    np.savez(tmp / "in.npz", config=np.array(json.dumps(WORLD_CONFIG)),
             wires=np.array(",".join(WIRES)), threshold=np.array(WORLD_THRESHOLD),
             **_flatten(variables["params"], "params"),
             **_flatten(variables["batch_stats"], "batch_stats"))
    port = free_port()
    procs = []
    for rank in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(N),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", CNN_DEVICE="cpu",
                   CNN_IN=str(tmp / "in.npz"), CNN_OUT=str(tmp / "out"),
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
    return variables["params"], want, got


# Float64 on both sides, except the heads, which both models run in
# float32. Each parameter's update (its value after a step less its
# initial value) is held by relative norm. The full-width wire: the same
# sums in another order and the heads' float32 rounding (~1e-7): losses,
# updates and each rank's statistics to 1e-6. The bf16 wire: both sides
# cast each bucket to bf16, but gloo rounds the partial sum of the four
# ranks' values to bf16 after each add where XLA rounds the sum once, up to
# two bf16 roundings (2^-8 relative each) apart: step 1's updates to 1e-2.
# Step 2's gradients are then taken at parameters that far apart, through
# ReLU masks that flip under such differences (see
# test_float32_forward_matches_jax_float64): its loss to 1e-3, its updates
# to 5e-2 (the wire alone moves them ~1e-2 from the full-width ones), each
# rank's statistics to 1e-3 of the largest.
WORLD_TOL = {  # wire: (losses, updates after each step, statistics)
    "none": (1e-6, (1e-6, 1e-6), 1e-6),
    "bf16": (1e-3, (1e-2, 5e-2), 1e-3),
}


@pytest.mark.parametrize("wire", WIRES)
def test_world_parameters_match_the_jax_dp_step(cnn_world, wire):
    init, want, got = cnn_world
    losses, after, _ = want[wire]
    loss_tol, update_tols, _ = WORLD_TOL[wire]
    for g in got:
        np.testing.assert_allclose(g[f"{wire}/losses"], losses, rtol=loss_tol)
    for i, (params, tol) in enumerate(zip(after, update_tols)):
        keys = [k for k in got[0] if k.startswith(f"{wire}/step{i}/")]
        assert len(keys) == len(jax.tree_util.tree_leaves(params))
        for key in keys:
            name = key.split("/", 2)[2]
            for g in got[1:]:
                np.testing.assert_array_equal(g[key], got[0][key], err_msg=name)
            path = convert.cnn_param_path(name)
            start = np.asarray(convert._lookup(init, path), np.float64)
            ref = np.asarray(convert._lookup(params, path)) - start
            err = _relnorm(got[0][key] - start, ref)
            assert err <= tol, (i, name, err)


@pytest.mark.parametrize("wire", WIRES)
def test_world_keeps_each_ranks_batch_norm_statistics(cnn_world, wire):
    _, want, got = cnn_world
    _, _, stats = want[wire]
    stats_tol = WORLD_TOL[wire][2]
    for rank, g in enumerate(got):
        keys = [k for k in g if k.startswith(f"{wire}/stat/")]
        assert len(keys) == len(jax.tree_util.tree_leaves(stats))
        for key in keys:
            _, path = convert.cnn_flax_path(key.split("/", 2)[2])
            ref = np.asarray(convert._lookup(stats, path))[rank]
            err = np.abs(g[key] - ref).max()
            assert err <= stats_tol * np.abs(ref).max(), (key, rank, err)
    key = next(k for k in got[0] if k.startswith(f"{wire}/stat/"))
    assert not np.array_equal(got[0][key], got[1][key])
