"""The port's input pipeline and K-steps-per-dispatch loop against the JAX
package's (``horovod_tpu.data``, ``horovod_tpu.jax.make_scan_train_loop``),
on the CPU.

``DistributedSampler``, the memmap writer and reader are numpy copies: the
same indices and the same bytes, exactly. ``DeviceCache`` keeps the JAX
cache's contract (every row once per epoch, a seeded order that changes
from epoch to epoch, uint8 normalized) with its own order, a hash of
(seed, epoch, row) held here against a numpy rendering of the same hash in
uint64. The loop on the CPU is K eager steps: equal, exactly, to the
stepwise calls, and the trajectory of the rows it drew matches the JAX
``train_step`` with ``optax.sgd`` on them to 1e-6 (float32, the same sums
in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import data as ref_data
from horovod_tpu_torch import data
from horovod_tpu_torch.loop import TrainingState, make_scan_train_loop
from horovod_tpu_torch.optimizer import DistributedOptimizer
from horovod_tpu_torch.train import TrainConfig, make_cache, setup, train

import horovod_tpu_torch as hvd


@pytest.fixture()
def cpu_world(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        monkeypatch.delenv(k, raising=False)
    yield
    hvd.shutdown()


# ------------------------------------------------------------ the sampler

@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("size", [1, 3, 4])
@pytest.mark.parametrize("n", [1, 7, 32, 33])
def test_sampler_matches_the_reference(n, size, shuffle):
    for rank in range(size):
        for seed in (0, 5):
            ours = data.DistributedSampler(n, rank=rank, size=size,
                                           shuffle=shuffle, seed=seed)
            ref = ref_data.DistributedSampler(n, rank=rank, size=size,
                                              shuffle=shuffle, seed=seed)
            assert len(ours) == len(ref)
            for epoch in range(3):
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
                np.testing.assert_array_equal(ours.indices(), ref.indices())
                assert list(ours) == list(ref)
                for batch in (1, 2, 5):
                    for drop_last in (True, False):
                        got = list(ours.batches(batch, drop_last))
                        want = list(ref.batches(batch, drop_last))
                        assert len(got) == len(want)
                        for g, w in zip(got, want):
                            np.testing.assert_array_equal(g, w)


def test_sampler_rejects_bad_world():
    with pytest.raises(ValueError, match="outside world"):
        data.DistributedSampler(10, rank=3, size=2)
    with pytest.raises(ValueError, match="empty dataset"):
        data.DistributedSampler(0, rank=0, size=1)


# ------------------------------------------------------- files on disk

def test_memmap_writer_and_reader_match_the_reference(tmp_path):
    ours = data.write_synthetic_shards(str(tmp_path / "ours"), 37, (3, 4, 4),
                                       10, seed=2, chunk=8)
    ref = ref_data.write_synthetic_shards(str(tmp_path / "ref"), 37, (3, 4, 4),
                                          10, seed=2, chunk=8)
    for name in ("images.npy", "labels.npy"):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    ds, ref_ds = data.MemmapArrayDataset(ours), ref_data.MemmapArrayDataset(ref)
    assert len(ds) == len(ref_ds) == 37
    assert isinstance(ds.images, np.memmap)
    idx = [5, 0, 36, 5]
    for got, want in zip(ds[idx], ref_ds[idx]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_memmap_reader_rejects_a_length_mismatch(tmp_path):
    np.save(tmp_path / "images.npy", np.zeros((4, 2), np.float32))
    np.save(tmp_path / "labels.npy", np.zeros(3, np.int64))
    with pytest.raises(ValueError, match="length mismatch"):
        data.MemmapArrayDataset(str(tmp_path))


# ------------------------------------------------------- the device cache

def test_device_cache_epoch_contract():
    """Every shard row exactly once per epoch, in an order that changes
    across epochs; uint8 normalized (tests/test_data.py's contract)."""
    n, batch = 32, 8
    images = np.arange(n, dtype=np.uint8).reshape(n, 1, 1, 1)
    labels = np.arange(n, dtype=np.int64)
    cache = data.DeviceCache(images, labels, batch_size=batch, seed=3,
                             device="cpu")
    ctr = cache.counter()
    assert ctr.dtype == torch.int64 and ctr.dim() == 0
    epochs = []
    for _ in range(2):
        seen = []
        for _ in range(n // batch):
            x, y, ctr = cache.sample(ctr)
            rows = y.numpy()
            assert x.dtype == torch.float32 and y.dtype == torch.int64
            np.testing.assert_allclose(x.numpy().reshape(batch),
                                       rows.astype(np.float32) / 127.5 - 1.0,
                                       rtol=1e-6)
            seen.extend(rows.tolist())
        assert sorted(seen) == list(range(n))
        epochs.append(seen)
    assert epochs[0] != epochs[1]
    assert int(ctr) == 2 * (n // batch)


def test_device_cache_keeps_other_dtypes_and_drops_the_ragged_tail():
    tokens = np.arange(10 * 3, dtype=np.int64).reshape(10, 3)
    cache = data.DeviceCache(tokens, tokens[:, 0], batch_size=4, device="cpu")
    assert cache.steps_per_epoch == 2
    x, y, _ = cache.sample(cache.counter())
    assert x.dtype == torch.int64
    np.testing.assert_array_equal(x[:, 0].numpy(), y.numpy())


def test_device_cache_validation():
    with pytest.raises(ValueError, match="mismatch"):
        data.DeviceCache(np.zeros((4, 1)), np.zeros(3), batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="cannot fill"):
        data.DeviceCache(np.zeros((2, 1)), np.zeros(2), batch_size=4, device="cpu")


_M32 = np.uint64(0xFFFFFFFF)


def _mix32_np(x):
    x = (((x >> np.uint64(16)) ^ x) * np.uint64(0x45D9F3B)) & _M32
    x = (((x >> np.uint64(16)) ^ x) * np.uint64(0x45D9F3B)) & _M32
    return (x >> np.uint64(16)) ^ x


def _order_np(seed, epoch, n):
    """The hash order in uint64 numpy: no product reaches 2^63, so it must
    agree with the int64 tensor ops bit for bit."""
    key = _mix32_np(_mix32_np(np.uint64(seed)) ^ np.uint64(epoch))
    rows = np.arange(n, dtype=np.uint64)
    hi = _mix32_np(key ^ rows)
    lo = _mix32_np(hi ^ _mix32_np(key ^ np.uint64(0x5BD1E995)))
    return np.argsort((hi << np.uint64(31)) | (lo >> np.uint64(1)), kind="stable")


@pytest.mark.parametrize("n", [1, 8, 1000])
def test_hash_order_is_reproducible_from_the_seed(n):
    orders = {}
    for seed in (0, 7):
        for epoch in (0, 1, 2**33 + 5):
            got = data.epoch_order(seed, torch.tensor(epoch), n).numpy()
            np.testing.assert_array_equal(got, _order_np(seed, epoch % 2**32, n))
            np.testing.assert_array_equal(
                got, data.epoch_order(seed, torch.tensor(epoch), n).numpy())
            assert sorted(got.tolist()) == list(range(n))
            orders[seed, epoch] = got.tolist()
    if n > 1:
        assert orders[0, 0] != orders[0, 1] and orders[0, 0] != orders[7, 0]


# ------------------------------------------------------------- the loop

N, BATCH, K = 32, 4, 4


def _problem():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (N, 3), dtype=np.uint8)
    labels = (images.sum(axis=1) % 5).astype(np.int64)
    return images, labels


def _linear():
    w = torch.nn.Parameter(torch.zeros(3, 5))
    b = torch.nn.Parameter(torch.zeros(5))
    opt = torch.optim.SGD([w, b], lr=0.1)

    def train_step(x, y):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(x @ w + b, y)
        loss.backward()
        opt.step()
        return loss.detach()

    return (w, b), opt, train_step


def test_cpu_loop_matches_stepwise_calls():
    """K steps per dispatch, twice, equal to 2K stepwise calls on the same
    draws (tests/test_data.py's oracle for the JAX scan loop)."""
    images, labels = _problem()
    cache = data.DeviceCache(images, labels, batch_size=BATCH, seed=7, device="cpu")
    (w, b), _, step = _linear()
    ctr, want = cache.counter(), []
    for _ in range(2 * K):
        x, y, ctr = cache.sample(ctr)
        want.append(step(x, y).item())
    want_w, want_b = w.detach().clone(), b.detach().clone()

    (w, b), opt, step = _linear()
    loop = make_scan_train_loop(step, cache, steps_per_dispatch=K, optimizer=opt)
    means, per_step = [], []
    for _ in range(2):
        means.append(loop().item())
        per_step.extend(loop.losses.tolist())
    assert per_step == want
    np.testing.assert_allclose(means, [np.mean(want[:K]), np.mean(want[K:])],
                               rtol=1e-7)
    assert torch.equal(w, want_w) and torch.equal(b, want_b)
    assert int(loop.counter) == 2 * K


def test_loop_trajectory_matches_jax_on_the_rows_it_drew():
    images, labels = _problem()
    cache = data.DeviceCache(images, labels, batch_size=BATCH, seed=7, device="cpu")
    ctr, draws = cache.counter(), []
    for _ in range(K):
        x, y, ctr = cache.sample(ctr)
        draws.append((x.numpy(), y.numpy()))
    (w, b), opt, step = _linear()
    loop = make_scan_train_loop(step, cache, steps_per_dispatch=K, optimizer=opt)
    mean = loop().item()

    sgd = optax.sgd(0.1)

    def jax_step(p, o, x, y):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                x @ p["w"] + p["b"], y).mean()

        loss, g = jax.value_and_grad(loss_fn)(p)
        up, o = sgd.update(g, o, p)
        return optax.apply_updates(p, up), o, loss

    p = {"w": jnp.zeros((3, 5)), "b": jnp.zeros((5,))}
    o, losses = sgd.init(p), []
    with jax.default_matmul_precision("highest"):
        for x, y in draws:
            p, o, loss = jax_step(p, o, jnp.asarray(x), jnp.asarray(y, jnp.int32))
            losses.append(float(loss))
    np.testing.assert_allclose(loop.losses.numpy(), losses, rtol=1e-6)
    np.testing.assert_allclose(mean, np.mean(losses), rtol=1e-6)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(p["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(p["b"]),
                               rtol=1e-6, atol=1e-7)


def test_loop_rejects_what_a_graph_cannot_replay(cpu_world):
    images, labels = _problem()
    cache = data.DeviceCache(images, labels, batch_size=BATCH, device="cpu")
    (w, b), opt, step = _linear()
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        make_scan_train_loop(step, cache, steps_per_dispatch=0, optimizer=opt)
    hvd.init(device="cpu")
    dist_opt = DistributedOptimizer(opt, [("w", w), ("b", b)],
                                    backward_passes_per_step=2)
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        make_scan_train_loop(step, cache, steps_per_dispatch=2, optimizer=dist_opt)
    loop = make_scan_train_loop(step, cache, steps_per_dispatch=2, optimizer=opt)
    with pytest.raises(RuntimeError, match="CPU"):
        loop.warm_up()


def test_training_state_restore_undoes_steps_as_the_warm_up_needs(cpu_world):
    """What the warm-up relies on: steps from a fresh Adam, then restore(),
    then the same steps again give what they gave the first time (state
    the steps created zeroed, which is where Adam's first step starts)."""
    hvd.init(device="cpu")
    config = TrainConfig(vocab=32, dim=32, heads=2, layers=1, seq=16)
    s = setup(config, "cpu")
    cache = make_cache(config, None, "cpu")
    ctr = cache.counter()
    state = TrainingState(s.opt.optimizer, ctr)
    runs = []
    for _ in range(2):
        losses = []
        for _ in range(3):
            x, y, nxt = cache.sample(ctr)
            losses.append(s.step(x, y).item())
            ctr.copy_(nxt)
        runs.append((losses, [p.detach().clone() for p in s.model.parameters()]))
        state.restore()
        assert int(ctr) == 0
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("sp", [None, 1])
def test_train_with_steps_per_dispatch_matches_stepwise(cpu_world, sp):
    """``train`` with K = 2 on the CPU: each dispatch's loss is the mean of
    K stepwise calls of the same step on the same cache draws."""
    config = TrainConfig(vocab=64, dim=32, heads=4, layers=2, seq=32, sp=sp,
                         steps_per_dispatch=2)
    result = train(config, 4, device="cpu")
    assert result.losses == [] and len(result.dispatch_s) == 2
    hvd.shutdown()
    s = setup(config, "cpu")
    cache = make_cache(config, s.sp, "cpu")
    ctr, losses = cache.counter(), []
    for _ in range(4):
        x, y, ctr = cache.sample(ctr)
        losses.append(s.step(x, y).item())
    np.testing.assert_allclose(result.dispatch_losses,
                               [np.mean(losses[:2]), np.mean(losses[2:])],
                               rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        train(config, 3, device="cpu")


def test_make_cache_rows_are_the_batch_stream_of_each_rank(cpu_world):
    """The cache holds CACHE_ROWS sequences from (seed, rank); with sp, the
    ring's rows cut to this rank's columns; targets rolled within them."""
    from horovod_tpu_torch.train import CACHE_ROWS, make_batch, make_shard
    from horovod_tpu_torch.parallel.mesh import dp_sp_groups

    hvd.init(device="cpu")
    config = TrainConfig(vocab=64, seq=16)
    cache = make_cache(config, None, "cpu")
    rows = make_batch(config, 0, "cpu", CACHE_ROWS)
    assert torch.equal(cache.data, rows)
    assert torch.equal(cache.labels, torch.roll(rows, -1, dims=1))
    assert torch.equal(cache.data[:1], make_batch(config, 0, "cpu"))
    ring = dp_sp_groups(1)
    shard = make_cache(config, ring, "cpu")
    assert torch.equal(shard.data, make_shard(config, ring, "cpu", CACHE_ROWS)[0])
