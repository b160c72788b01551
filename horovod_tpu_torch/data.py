"""Rank-sharded input pipeline: the counterpart of ``horovod_tpu.data``.

``DistributedSampler``, ``MemmapArrayDataset`` and
``write_synthetic_shards`` are numpy copies of the JAX package's: for the
same arguments they give the same indices and write the same bytes.
``DeviceCache`` keeps this rank's shard on the device and draws every
batch there, from a step counter that is itself a device tensor, so a
training step that samples from it runs with no host work and can be
captured in a CUDA graph (``loop.make_scan_train_loop``)::

    ds = MemmapArrayDataset(data_dir)             # images.npy + labels.npy
    sampler = DistributedSampler(len(ds))          # rank/size from init()
    for epoch in range(E):
        sampler.set_epoch(epoch)                   # per-epoch reshuffle
        for idx in sampler.batches(batch_size):
            x, y = ds[idx]                         # memmap slice -> RAM
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .common import basics


class DistributedSampler:
    """Torch ``DistributedSampler`` semantics in numpy, index for index the
    JAX package's:

    - the index space is split round-robin after a per-epoch shuffle;
    - every rank gets exactly ``ceil(n / size)`` indices, the tail padded
      by wrapping, so all ranks run the same number of steps;
    - ``set_epoch(e)`` reseeds the shuffle with ``seed + e``.
    """

    def __init__(self, n: int, rank: Optional[int] = None,
                 size: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0) -> None:
        if n <= 0:
            raise ValueError(f"empty dataset (n={n})")
        self.n = n
        self.rank = rank if rank is not None else basics.rank()
        self.size = size if size is not None else basics.size()
        if not (0 <= self.rank < self.size):
            raise ValueError(f"rank {self.rank} outside world {self.size}")
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.per_rank = -(-n // self.size)  # ceil

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        total = self.per_rank * self.size
        if total > self.n:  # pad by wrapping
            order = np.concatenate([order, order[: total - self.n]])
        return order[self.rank::self.size]

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices())

    def __len__(self) -> int:
        return self.per_rank

    def batches(self, batch_size: int, drop_last: bool = True) -> Iterator[np.ndarray]:
        """Index batches for one epoch; ``drop_last`` keeps every batch of
        every rank the same size."""
        idx = self.indices()
        end = (len(idx) // batch_size) * batch_size if drop_last else len(idx)
        for i in range(0, end, batch_size):
            yield idx[i:i + batch_size]


class MemmapArrayDataset:
    """File-backed (images, labels) pairs through ``np.memmap``. Layout:
    ``<dir>/images.npy`` [N, ...] and ``<dir>/labels.npy`` [N]."""

    def __init__(self, data_dir: str) -> None:
        self.images = np.load(os.path.join(data_dir, "images.npy"), mmap_mode="r")
        self.labels = np.load(os.path.join(data_dir, "labels.npy"), mmap_mode="r")
        if len(self.images) != len(self.labels):
            raise ValueError(
                f"images ({len(self.images)}) / labels ({len(self.labels)}) "
                f"length mismatch in {data_dir}")

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx):
        """The selected rows, copied from the memmap into RAM."""
        idx = np.asarray(idx)
        return np.ascontiguousarray(self.images[idx]), \
            np.ascontiguousarray(self.labels[idx])


def write_synthetic_shards(data_dir: str, n: int, image_shape: Sequence[int],
                           num_classes: int, seed: int = 0,
                           chunk: int = 1024) -> str:
    """Write a synthetic dataset to ``<dir>/{images,labels}.npy``: float32
    standard-normal images, filled through a memmap ``chunk`` rows at a
    time, and int64 labels, the JAX package's bytes for the same seed."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = np.lib.format.open_memmap(
        os.path.join(data_dir, "images.npy"), mode="w+", dtype=np.float32,
        shape=(n, *image_shape))
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        out[i:i + m] = rng.standard_normal((m, *image_shape), dtype=np.float32)
    out.flush()
    del out
    labels = rng.integers(0, num_classes, size=(n,), dtype=np.int64)
    np.save(os.path.join(data_dir, "labels.npy"), labels)
    return data_dir


_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B          # below 2^31: a 32-bit value times it stays below 2^63


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values in [0, 2^32):
    every product is below 2^63, so the CPU and the card agree bit for bit."""
    x = (((x >> 16) ^ x) * _MUL) & _M32
    x = (((x >> 16) ^ x) * _MUL) & _M32
    return (x >> 16) ^ x


def epoch_order(seed: int, epoch: torch.Tensor, n: int) -> torch.Tensor:
    """The order in which epoch ``epoch`` (an int64 tensor, 0-d) visits
    rows 0..n-1: a stable argsort of a counter-based hash of (seed, epoch,
    row), computed with tensor ops on ``epoch``'s device. It draws nothing
    from a generator, so a captured graph replays it from the counter alone,
    and every intermediate stays below 2^63, so the CPU and the card give
    the same order."""
    rows = torch.arange(n, dtype=torch.int64, device=epoch.device)
    key = _mix32(_mix32(torch.full_like(epoch, seed & _M32)) ^ (epoch & _M32))
    hi = _mix32(key ^ rows)
    lo = _mix32(hi ^ _mix32(key ^ 0x5BD1E995))
    # 63-bit sort keys: ties need two equal 32-bit hashes and a 31-bit one.
    return torch.argsort((hi << 31) | (lo >> 1), stable=True)


class DeviceCache:
    """This rank's shard on the device, with the batch drawn on the device:
    the counterpart of ``horovod_tpu.data.DeviceCache``.

    The shard is uploaded once. ``counter()`` is the step counter, a 0-d
    int64 tensor on the device; ``sample(ctr)`` returns ``(x, y, ctr + 1)``.
    Epoch ``ctr // steps_per_epoch`` visits every row exactly once, in the
    seeded order of ``epoch_order`` (a hash, where the JAX package draws
    ``jax.random.permutation``; the two orders differ, the contract is the
    same), and the orders of two epochs differ. uint8 rows are normalized
    to ``x / 127.5 - 1`` in float32. Labels are int64, the dtype PyTorch's
    cross entropy takes.

    As in the JAX package, the shard is fixed at upload and each epoch
    reshuffles within it: weaker than ``DistributedSampler``, whose global
    shuffle changes a rank's subset every epoch.
    """

    def __init__(self, images, labels, batch_size: int, seed: int = 0,
                 normalize: bool = True, device=None) -> None:
        if len(images) != len(labels):
            raise ValueError(
                f"images ({len(images)}) / labels ({len(labels)}) mismatch")
        if len(images) < batch_size:
            raise ValueError(
                f"shard of {len(images)} rows cannot fill a batch of "
                f"{batch_size}")
        device = basics.resolve_device(device)
        self.data = torch.as_tensor(np.asarray(images)).to(device)
        self.labels = torch.as_tensor(
            np.asarray(labels).astype(np.int64)).to(device)
        self.n = int(len(images))
        self.batch = int(batch_size)
        self.steps_per_epoch = self.n // self.batch
        self.seed = int(seed)
        self.normalize = normalize
        self._offsets = torch.arange(self.batch, dtype=torch.int64, device=device)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def counter(self) -> torch.Tensor:
        """The step counter at step 0."""
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def sample(self, ctr: torch.Tensor):
        """(x, y, ctr + 1): batch ``ctr % steps_per_epoch`` of epoch
        ``ctr // steps_per_epoch``, drawn with tensor ops only."""
        epoch = ctr // self.steps_per_epoch
        i = ctr % self.steps_per_epoch
        perm = epoch_order(self.seed, epoch, self.n)
        idx = perm.index_select(0, i * self.batch + self._offsets)
        x = self.data.index_select(0, idx)
        if self.normalize and x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        return x, self.labels.index_select(0, idx), ctr + 1
