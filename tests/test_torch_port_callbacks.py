"""``horovod_tpu_torch.callbacks`` against ``horovod_tpu.callbacks``.

- The learning-rate callbacks act on ``torch.optim`` optimizers in both
  packages: each is driven on one of two twin SGD optimizers (the same
  parameters, gradients and epochs), and the lr sequences and momentum
  buffers must be bit-equal.
- ``warmup_schedule``, a plain ``step -> lr`` here, against the JAX
  package's optax schedule at steps 0..40, within 1e-7 (the optax schedule
  computes in float32, this one in float64).
- In a gloo world of two (tests/torch_port_callbacks_worker.py):
  ``BroadcastGlobalVariablesCallback`` gives every rank rank 0's
  parameters and momentum buffers, ``MetricAverageCallback`` averages the
  epoch logs in place, and ``MetricsCallback`` merges every rank's
  snapshot on rank 0 as the JAX package's ``merge_snapshots`` merges them.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import callbacks as ref
from horovod_tpu.metrics import merge_snapshots as ref_merge
from horovod_tpu_torch import callbacks as port
from launch_util import REPO, free_port

WORKER = os.path.join(REPO, "tests", "torch_port_callbacks_worker.py")
ENV_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT", "HOROVOD_COORD_ADDR")


def _twins(momentum=0.9):
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (3,), (2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(8)]
    opts = []
    for _ in range(2):
        params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
        opts.append(torch.optim.SGD([{"params": params[:2]},
                                     {"params": params[2:], "lr": 0.05}],
                                    lr=0.1, momentum=momentum))
    return opts, grads


CASES = {
    "warmup": lambda m, opt: m.LearningRateWarmupCallback(opt, warmup_epochs=3, size=4),
    "warmup_no_correction": lambda m, opt: m.LearningRateWarmupCallback(
        opt, warmup_epochs=2.5, size=8, momentum_correction=False),
    "schedule_window": lambda m, opt: m.LearningRateScheduleCallback(
        opt, lambda e: 0.5 ** e, start_epoch=1, end_epoch=5),
    "schedule_open": lambda m, opt: m.LearningRateScheduleCallback(
        opt, lambda e: 1.0 + 0.25 * e),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lr_callbacks_bit_equal_to_the_reference(case):
    (opt_ref, opt_port), grads = _twins()
    cbs = [CASES[case](ref, opt_ref), CASES[case](port, opt_port)]
    seen = [[], []]
    for epoch, g in enumerate(grads):
        for i, (cb, opt) in enumerate(zip(cbs, (opt_ref, opt_port))):
            cb.on_epoch_begin(epoch)
            params = [p for group in opt.param_groups for p in group["params"]]
            for p, a in zip(params, g):
                p.grad = torch.from_numpy(a.copy())
            opt.step()
            cb.on_epoch_end(epoch)
            seen[i].append(([group["lr"] for group in opt.param_groups],
                            [opt.state[p]["momentum_buffer"].clone() for p in params],
                            [p.detach().clone() for p in params]))
    for (lr_r, buf_r, p_r), (lr_p, buf_p, p_p) in zip(*seen):
        assert lr_p == lr_r
        assert all(torch.equal(a, b) for a, b in zip(buf_p, buf_r))
        assert all(torch.equal(a, b) for a, b in zip(p_p, p_r))


def test_adam_has_no_momentum_to_correct():
    w = torch.nn.Parameter(torch.ones(2))
    opt = torch.optim.Adam([w], lr=0.1)
    w.grad = torch.ones(2)
    opt.step()
    cb = port.LearningRateWarmupCallback(opt, warmup_epochs=2, size=2)
    cb.on_epoch_begin(1)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.15)


@pytest.mark.parametrize("kw", [
    dict(base_lr=0.0125, warmup_epochs=1, steps_per_epoch=8, size=4),
    dict(base_lr=0.1, warmup_epochs=2.5, steps_per_epoch=4, size=8),
    dict(base_lr=0.01, warmup_epochs=3, steps_per_epoch=5, size=1),
    dict(base_lr=0.02, warmup_epochs=0, steps_per_epoch=5, size=4),
    dict(base_lr=0.05, warmup_epochs=2, steps_per_epoch=6, size=2,
         after=lambda s: 0.1 * 0.9 ** s)],
    ids=["example", "fractional", "size-1", "no-warmup", "after"])
def test_warmup_schedule_matches_the_optax_schedule(kw):
    want = ref.warmup_schedule(**kw)
    got = port.warmup_schedule(**kw)
    for step in range(41):
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert abs(got(step) - w) <= 1e-7, (step, got(step), w)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_port_callbacks_two")
    port_no = free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
        env.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port_no}",
                   CB_OUT=str(tmp / "out"), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    errors = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(err[-3000:])
    assert not errors, errors
    out = []
    for rank in range(2):
        with open(tmp / f"out.{rank}.json") as f:
            out.append(json.load(f))
    with open(tmp / "out.pod.json") as f:
        pod = json.load(f)
    return out, pod


def test_broadcast_callback_gives_every_rank_rank_zeros_state(two):
    out, _ = two
    assert out[1]["params"] == out[0]["params"]
    assert out[1]["buffers"] == out[0]["buffers"]


def test_metric_average_callback_averages_in_place(two):
    out, _ = two
    want = {"loss": 1.5, "acc": [0.5, 1.0], "steps": 10}
    assert [r["logs"] for r in out] == [[want, want], [want, want]]
    assert [r["mixed"] for r in out] == [{"t": ["torch.float64", [1.5, 4.5]],
                                          "n": ["float32", 0.5]}] * 2


def test_metrics_callback_merges_the_pod_as_the_reference(two):
    out, pod = two
    assert [r["pod_on_rank"] for r in out] == [True, False]
    want = ref_merge([r["snapshot"] for r in out])
    strip = lambda s: {k: v for k, v in s.items() if k != "time_unix_s"}  # noqa: E731
    assert strip(pod) == strip(want)
    assert pod["ranks"] == 2 and pod["counters"]["horovod_epochs_total"] == 4.0
    assert set(pod["gauges"]["horovod_steps_per_sec"]) == {"min", "max", "mean"}
