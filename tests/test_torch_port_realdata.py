"""The port's real-data input path (``examples/torch_realdata_benchmark.py``,
``train_cnn.make_cnn_scan_loop``, ``loop.TrainingState(module=)``) against
the JAX package's, on the CPU at a small size: ResNet-18 on 32 x 32
images, float32, a few images per rank.

- ``TrainingState`` with the module puts BatchNorm's running statistics
  back bit for bit (without it they stay moved).
- The loop's K steps per dispatch with ``module=`` equal K eager cache
  steps bit for bit: losses, parameters, statistics, momentum.
- ``ensure_dataset`` writes the JAX example's bytes; ``DeviceCache``
  normalizes uint8 as the JAX example's ``cast_norm`` does, bit for bit.
- The example's ``--json`` line has exactly the JAX example's keys for the
  same ``--modes`` (the JAX example run with a tiny stand-in for
  ``bench._build``, whose ResNet-50 the key set does not depend on).

Tolerance: none; every comparison is bitwise.
"""

import importlib.util
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import data
from horovod_tpu_torch.loop import TrainingState
from horovod_tpu_torch.train_cnn import (CNNConfig, cnn_cache_step,
                                         make_cnn_scan_loop, setup_cnn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = CNNConfig(model="ResNet18", num_classes=10, image_size=32, batch=4,
                   dtype="float32", channels_last=False)
ENV_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_realdata_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cpu_world(monkeypatch):
    for k in ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def _cache(n=16, seed=3):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, CONFIG.num_classes, n)
    return data.DeviceCache(images, labels, batch_size=CONFIG.batch, seed=5,
                            device="cpu")


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().numpy().tobytes()


def _snapshot(s) -> dict:
    out = {k: _bytes(v) for k, v in s.model.state_dict().items()}
    for i, p in enumerate(s.opt.optimizer.param_groups[0]["params"]):
        buf = s.opt.optimizer.state.get(p, {}).get("momentum_buffer")
        out[f"momentum.{i}"] = None if buf is None else _bytes(buf)
    return out


def test_training_state_restores_batch_norm_statistics(cpu_world):
    s = setup_cnn(CONFIG, "cpu")
    cache = _cache()
    step = cnn_cache_step(s)
    stats = {k: v for k, v in s.model.state_dict().items() if "running" in k}
    before = {k: _bytes(v) for k, v in s.model.state_dict().items()}

    def steps(ctr):
        for _ in range(2):
            x, y, nxt = cache.sample(ctr)
            step(x, y)
            ctr.copy_(nxt)

    ctr = cache.counter()
    without = TrainingState(s.opt.optimizer, ctr)
    steps(ctr)
    without.restore()
    assert int(ctr) == 0
    assert all(_bytes(p) == before[k] for k, p in s.model.named_parameters())
    assert any(_bytes(v) != before[k] for k, v in stats.items()), \
        "the steps moved no BatchNorm statistic"

    with torch.no_grad():
        for k, v in s.model.state_dict().items():
            v.copy_(torch.from_numpy(np.frombuffer(
                before[k], dtype=v.numpy().dtype).reshape(v.shape).copy()))
    s.opt.optimizer.state.clear()
    state = TrainingState(s.opt.optimizer, ctr, s.model)
    steps(ctr)
    state.restore()
    assert int(ctr) == 0
    assert {k: _bytes(v) for k, v in s.model.state_dict().items()} == before
    assert all(not st["momentum_buffer"].any()
               for st in s.opt.optimizer.state.values())


def test_scan_loop_with_the_module_equals_eager_cache_steps(cpu_world):
    K, dispatches = 2, 2
    s = setup_cnn(CONFIG, "cpu")
    initial = {k: v.detach().clone() for k, v in s.model.state_dict().items()}
    cache = _cache()
    step = cnn_cache_step(s)
    ctr, want = cache.counter(), []
    for _ in range(K * dispatches):
        x, y, ctr = cache.sample(ctr)
        want.append(step(x, y).item())
    want_state = _snapshot(s)

    with torch.no_grad():
        for k, v in s.model.state_dict().items():
            v.copy_(initial[k])
    s.opt.optimizer.state.clear()
    loop = make_cnn_scan_loop(s, cache, K)
    assert loop.module is s.model
    got = []
    for _ in range(dispatches):
        loop()
        got.extend(loop.losses.tolist())
    assert got == want
    assert _snapshot(s) == want_state
    assert int(loop.counter) == K * dispatches


@pytest.mark.parametrize("n,image", [(5, 8), (513, 4)])
def test_ensure_dataset_writes_the_jax_examples_bytes(tmp_path, n, image):
    jax_ex, port_ex = _example("realdata_benchmark"), _example(
        "torch_realdata_benchmark")
    jax_ex.ensure_dataset(str(tmp_path / "jax"), n, image)
    port_ex.ensure_dataset(str(tmp_path / "port"), n, image)
    for name in ("images.npy", "labels.npy"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


def test_device_cache_normalizes_as_the_jax_cast():
    rng = np.random.default_rng(11)
    images = np.concatenate([np.arange(256, dtype=np.uint8).reshape(16, 4, 4, 1)
                             .repeat(3, axis=3),
                             rng.integers(0, 256, (16, 4, 4, 3), dtype=np.uint8)])
    labels = np.arange(len(images))
    cache = data.DeviceCache(images, labels, batch_size=len(images), seed=2,
                             device="cpu")
    x, y, _ = cache.sample(cache.counter())
    rows = y.numpy()
    want = images[rows].astype(np.float32) / 127.5 - 1
    assert x.dtype == torch.float32
    assert x.numpy().tobytes() == want.tobytes()
    assert sorted(rows) == list(range(len(images)))


def _jax_key_set(monkeypatch, capsys, tmp_path, modes) -> set:
    """The JAX example's JSON keys for ``modes``: its main() run as it is,
    with a linear stand-in for bench._build (the keys come from the modes,
    not from the model)."""
    import horovod_tpu as jhvd

    def build():
        n_dev = len(jax.devices())
        batch = n_dev
        opt = optax.sgd(0.01)
        params = jnp.zeros((32 * 32 * 3, 10))

        def step(params, bstats, ostate, x, y):
            def loss_fn(p):
                logits = x.reshape(x.shape[0], -1).astype(jnp.float32) @ p
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, y).mean()

            loss, g = jax.value_and_grad(loss_fn)(params)
            up, ostate = opt.update(g, ostate, params)
            return optax.apply_updates(params, up), bstats, ostate, loss

        x = jnp.ones((batch, 32, 32, 3), jnp.float32)
        y = jnp.zeros((batch,), jnp.int32)
        return (jax.jit(step), (params, jnp.zeros(()), opt.init(params)),
                (x, y), batch, n_dev)

    monkeypatch.setitem(sys.modules, "bench", types.SimpleNamespace(_build=build))
    monkeypatch.setenv("HVD_BENCH_BATCH", "1")
    monkeypatch.setattr(sys, "argv", [
        "realdata_benchmark.py", "--json", "--modes", modes,
        "--data-dir", str(tmp_path / "jax"), "--n-images", "16",
        "--num-warmup", "1", "--window", "1", "--reps", "1",
        "--scan-steps", "2"])
    jhvd.init()
    assert _example("realdata_benchmark").main() == 0
    return set(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))


@pytest.mark.parametrize("modes", [
    "synthetic,stream,device-cache,device-cache-scan", "stream,device-cache"])
def test_json_keys_are_the_jax_examples(monkeypatch, capsys, tmp_path, modes):
    want = _jax_key_set(monkeypatch, capsys, tmp_path, modes)
    for k in ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    assert _example("torch_realdata_benchmark").main([
        "--device", "cpu", "--model", "ResNet18", "--image-size", "32",
        "--batch", "2", "--n-images", "8", "--dtype", "float32", "--json",
        "--modes", modes, "--data-dir", str(tmp_path / "port"),
        "--num-warmup", "1", "--window", "1", "--reps", "1",
        "--scan-steps", "2"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == want
    assert got["batch"] == 2 and got["n_images"] == 8
    assert all(got[f"{m}_img_s"] > 0 for m in modes.split(","))
