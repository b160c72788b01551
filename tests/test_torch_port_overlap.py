"""The gradient exchange started from the gradient hooks
(HOROVOD_LATENCY_HIDING) and ``horovod_tpu_torch.metrics.overlap``, on the
CPU.

Two gloo worlds run tests/torch_port_overlap_worker.py, one spawn each:

- 2 ranks, with HOROVOD_LATENCY_HIDING=1: the optimizer tests' MLP, 3 Adam
  steps per configuration (wires none and bf16 x K 1 and 3) with the hooks
  on, against ``horovod_tpu.jax.DistributedOptimizer`` under shard_map on 2
  virtual CPU devices at tests/test_torch_port_optimizer.py's tolerances
  (parameters 1e-6 with no wire cast and 2.5e-4 with bf16, losses 1e-5 /
  1e-4 relative; the reasons are given there); and, bit for bit in every
  loss and parameter, against the serial exchange in the same world: every
  configuration, two backward passes per step, and ``b2`` unused on one
  rank only. The first exchange launches in plan order, every later one in
  the order the buckets completed on rank 0's first backward pass, the
  same on every rank. At each landing the collectives issued so far must
  be the buckets, in launch order, whose leaves had all landed by then (the
  forward plan of K = 1 completes its buckets against plan order). A
  gradient that lands twice before ``step()`` raises, as ``zero_grad()``
  after the backward pass does.
- 4 ranks: hooked against serial, bit for bit: flat, ``group=``, the
  hierarchical ladder on 2 x 2 (plain and with a bf16 DCN wire), ZeRO 2 x 2
  and 1 x 4 on the MLP, and a small TransformerLM through ``train.setup``,
  flat and ZeRO 2 x 2.

Both exchanges make the same buffers and the same calls with the same
divisions, and gloo sums a buffer in one fixed order, so bit-equality is
the expectation, not a tolerance. ``record_plan`` and ``parse_overlap`` are
held to the reference's on the same leaves and the same seeded spans.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from launch_util import REPO, free_port
from test_torch_port_optimizer import (BATCH, CONFIGS, LR, STEPS, THRESHOLD,
                                       _jax_trajectory, _problem)

from horovod_tpu_torch.metrics import overlap
from horovod_tpu_torch.parallel import fusion

WORKER = os.path.join(REPO, "tests", "torch_port_overlap_worker.py")


def _spawn(mode: str, n: int, tmp) -> list:
    params, x, y = _problem()
    np.savez(tmp / "problem.npz", x=x, y=y, **params)
    cfg = {"configs": CONFIGS, "lr": LR, "steps": STEPS,
           "threshold": THRESHOLD, "batch": BATCH}
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}",
                   HOROVOD_LATENCY_HIDING="1", OVERLAP_MODE=mode,
                   OVERLAP_IN=str(tmp / "problem.npz"), OVERLAP_CFG=json.dumps(cfg),
                   OVERLAP_OUT=str(tmp / "out"), OMP_NUM_THREADS="1")
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                    "HOROVOD_NUM_BUCKETS", "HOROVOD_FUSION_THRESHOLD",
                    "HOROVOD_COMPRESSION", "HOROVOD_MESH", "HOROVOD_SHARD_PARAMS"):
            env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    errors = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(err[-3000:])
    assert not errors, errors
    out = []
    for rank in range(n):
        with open(tmp / f"out.{rank}.json") as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn("two", 2, tmp_path_factory.mktemp("torch_port_overlap_two"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn("four", 4, tmp_path_factory.mktemp("torch_port_overlap_four"))


def test_env_switch_reaches_the_config(two):
    assert all(r["env_latency_hiding"] for r in two)


@pytest.mark.parametrize("wire,k", CONFIGS)
def test_hooked_trajectory_matches_jax(two, wire, k):
    got = two[0][f"{wire}-{k}/hooked"]
    losses, params = _jax_trajectory(wire, k)
    atol, loss_rtol = (1e-6, 1e-5) if wire == "none" else (2.5e-4, 1e-4)
    np.testing.assert_allclose(got["losses"], losses, rtol=loss_rtol)
    for name, want in params.items():
        np.testing.assert_allclose(np.asarray(got[name], np.float32), want,
                                   atol=atol, rtol=0, err_msg=name)


TWO_CASES = [f"{w}-{k}" for w, k in CONFIGS] + ["passes2", "missing"]
FOUR_CASES = ["flat", "group", "hier", "hier-dcn-bf16", "zero-2x2", "zero-1x4",
              "lm", "lm-zero-2x2"]


def _assert_bit_equal(ranks, case):
    for rank, res in enumerate(ranks):
        got, want = res[f"{case}/hooked"], res[f"{case}/serial"]
        assert got["losses"] == want["losses"], (rank, case)
        keys = [k for k in want
                if k not in ("losses", "launches", "landings", "order")]
        for key in keys:
            assert got[key] == want[key], (rank, case, key)


@pytest.mark.parametrize("case", TWO_CASES)
def test_hooked_equals_serial_two_ranks(two, case):
    _assert_bit_equal(two, case)


@pytest.mark.parametrize("case", FOUR_CASES)
def test_hooked_equals_serial_four_ranks(four, case):
    _assert_bit_equal(four, case)


@pytest.mark.parametrize("case", TWO_CASES + FOUR_CASES)
def test_launches_in_plan_order_on_every_rank(two, four, case):
    """Without the hooks every bucket starts in ``synchronize``, in plan
    order. With them the first exchange starts in plan order and every
    later one in the agreed order: one permutation of the buckets, the same
    on every rank."""
    ranks = two if case in TWO_CASES else four
    order = ranks[0][f"{case}/hooked"]["order"]
    assert sorted(order) == list(range(len(order)))
    for rank, res in enumerate(ranks):
        n = len(res[f"{case}/serial"]["order"])
        assert res[f"{case}/serial"]["order"] == list(range(n))
        for step in res[f"{case}/serial"]["launches"]:
            assert step == [[b, None] for b in range(n)], (rank, case)
        run = res[f"{case}/hooked"]
        assert run["order"] == order, (rank, case)
        for i, step in enumerate(run["launches"]):
            want = list(range(n)) if i == 0 else order
            assert [b for b, _ in step] == want, (rank, case, i)


def _completed(buckets, log) -> list:
    """The buckets in the order a step's landings completed them."""
    landed, done = set(), []
    for name, _ in log:
        landed.add(NAMES.index(name))
        done += [b for b, leaves in enumerate(buckets)
                 if b not in done and all(i in landed for i in leaves)]
    return done


def _prefix_ready(order, buckets, landed) -> int:
    """Buckets, from the first in ``order``, whose leaves have all landed."""
    n = 0
    while n < len(order) and all(i in landed for i in buckets[order[n]]):
        n += 1
    return n


NAMES = ["b1", "b2", "w1", "w2"]


@pytest.mark.parametrize("case", ["none-3", "bf16-3", "missing"])
def test_launch_order_is_rank_zeros_first_completion_order(two, case):
    """From the second exchange on, the buckets start in the order they
    completed on rank 0's first backward pass; a bucket that never
    completed there comes last."""
    run0 = two[0][f"{case}/hooked"]
    done = _completed(run0["buckets"], run0["landings"][0])
    rest = [b for b in range(len(run0["buckets"])) if b not in done]
    assert done and run0["order"] == done + rest


@pytest.mark.parametrize("case", ["none-1", "none-3", "bf16-3", "missing"])
def test_each_launch_waits_for_its_bucket_and_the_ones_before(two, case):
    """At every landing the optimizer has issued exactly the buckets, in
    launch order, whose leaves had all landed; a leaf that never lands
    holds back its bucket and every later one until ``synchronize``."""
    for rank, res in enumerate(two):
        run = res[f"{case}/hooked"]
        for step, log in enumerate(run["landings"]):
            order = [b for b, _ in run["launches"][step]]
            landed = set()
            for name, calls in log:
                landed.add(NAMES.index(name))
                assert calls == _prefix_ready(order, run["buckets"], landed), \
                    (rank, step, name, calls, run["buckets"])
            in_hooks = [b for b, at in run["launches"][step] if at is not None]
            assert len(in_hooks) == _prefix_ready(order, run["buckets"], landed)
            for pos, (b, at) in enumerate(run["launches"][step]):
                # started at the landing that completed the order's prefix
                if at is not None:
                    prefix = {NAMES.index(n) for n, _ in log[:at]}
                    assert _prefix_ready(order, run["buckets"], prefix) > pos
                    assert _prefix_ready(order, run["buckets"], prefix - {
                        NAMES.index(log[at - 1][0])}) <= pos


def test_forward_plan_completes_against_plan_order(two):
    """K = 1's greedy plan puts the first leaves in bucket 0, whose gradient
    the backward pass makes last: on the first exchange a later bucket
    lands complete first and still launches after bucket 0; from the
    second on it launches at the landing that completes it."""
    run = two[0]["none-1/hooked"]
    assert run["buckets"] == [[0, 1], [2], [3]]
    assert run["order"] == _completed(run["buckets"], run["landings"][0])
    assert run["order"][0] == 2 and run["order"] != [0, 1, 2]
    for step, (log, launches) in enumerate(zip(run["landings"], run["launches"])):
        w2 = [name for name, _ in log].index("w2")
        assert len(log) == 4
        if step == 0:
            assert log[w2][1] < 3 and w2 < 3    # bucket 2 complete, not started
            assert launches[-1] == [2, 4]
        else:
            assert launches[0] == [2, w2 + 1] and launches[-1][1] == 4


def test_unused_parameter_on_one_rank_waits_for_synchronize(two):
    """``b2`` is unused on rank 1: there its bucket and every later one in
    the launch order start in ``synchronize``, from the hooks on rank 0."""
    run0, run1 = two[0]["missing/hooked"], two[1]["missing/hooked"]
    b2_bucket = next(b for b, leaves in enumerate(run0["buckets"]) if 1 in leaves)
    for step in range(STEPS):
        assert all(at is not None for _, at in run0["launches"][step])
        order = [b for b, _ in run1["launches"][step]]
        held = order.index(b2_bucket)
        assert [at is not None for _, at in run1["launches"][step]] == \
            [pos < held for pos in range(len(order))]


def test_gradient_landing_twice_raises(two):
    for res in two:
        assert "Gradient ready before optimizer.step()" in res["failures"]["twice"]


def test_zero_grad_after_backward_raises(two):
    for res in two:
        assert "zero_grad() called after gradients landed" in res["failures"]["zero_grad"]
        assert res["failures"]["stepped"] is True


# ------------------------------------------------------- the overlap metrics

def _leaves(seed):
    rng = np.random.default_rng(seed)
    shapes = [tuple(int(s) for s in rng.integers(1, 40, size=rng.integers(1, 3)))
              for _ in range(9)]
    dtypes = ["float32"] * 6 + ["bfloat16"] * 3
    rng.shuffle(dtypes)
    return shapes, dtypes


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("pad_to", [1, 4])
def test_record_plan_matches_reference(k, pad_to):
    from horovod_tpu.metrics.overlap import record_plan
    from horovod_tpu.metrics.registry import registry
    from horovod_tpu.parallel import fusion as jax_fusion

    shapes, dtypes = _leaves(k * 10 + pad_to)
    threshold = 1200
    tree = {f"leaf_{i:02d}": jnp.zeros(s, getattr(jnp, d))
            for i, (s, d) in enumerate(zip(shapes, dtypes))}
    want = record_plan(jax_fusion.build_plan(tree, threshold, pad_to=pad_to,
                                             num_buckets=k), threshold)
    reg = registry()
    leaves = [torch.empty(s, dtype=getattr(torch, d)) for s, d in zip(shapes, dtypes)]
    got = overlap.record_plan(fusion.build_plan(leaves, threshold, k, pad_to),
                              threshold)
    assert got["buckets"] == want and len(want) > 1
    assert got["total_bytes"] == sum(n for _, n in want)
    assert got["occupancy"] == reg.gauge("horovod_fusion_buffer_occupancy").value
    assert got["planned_efficiency"] == \
        reg.gauge("horovod_overlap_efficiency_planned").value
    assert (got["planned_efficiency"] > 0) == (k > 1)


COLLECTIVE_NAMES = ["ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                    "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL",
                    "ncclDevKernel_AllGather_RING_LL"]
COMPUTE_NAMES = ["fwd_tc_kernel<128, 0>", "nvjet_tst_256x128_64x4_1x2_h_ssched",
                 "void at::native::vectorized_elementwise_kernel<4>"]


def _spans(seed, collectives=True):
    """(device, name, start us, duration us) of seeded kernels on 2 cards."""
    rng = np.random.default_rng(seed)
    out = []
    for dev in (0, 1):
        t = 1000.0 * (dev + 1)
        for _ in range(40):
            names = COLLECTIVE_NAMES + COMPUTE_NAMES if collectives else COMPUTE_NAMES
            name = names[rng.integers(len(names))]
            dur = float(rng.integers(1, 400))
            out.append((dev, name, t, dur))
            t += float(rng.integers(-300, 300)) + dur / 2
    return out


def _xla_trace(spans):
    events = [{"ph": "M", "name": "process_name", "pid": 10 + d,
               "args": {"name": f"/device:GPU:{d}"}} for d in (0, 1)]
    events += [{"ph": "X", "pid": 10 + d, "tid": 1, "ts": t, "dur": dur, "name": n,
                "args": {"device_duration_ps": dur * 1e6, "hlo_category": ""}}
               for d, n, t, dur in spans]
    events.append({"ph": "X", "pid": 99, "tid": 1, "ts": 0.0, "dur": 1e6,
                   "name": "host step"})
    return events


def _torch_trace(spans):
    events = [{"ph": "X", "cat": "kernel", "pid": d, "tid": 7, "ts": t, "dur": dur,
               "name": n, "args": {"device": d, "stream": 7}}
              for d, n, t, dur in spans]
    events.append({"ph": "X", "cat": "cpu_op", "pid": 123, "tid": 123, "ts": 0.0,
                   "dur": 1e6, "name": "aten::all_reduce"})
    return events


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_overlap_matches_reference(seed):
    from horovod_tpu.metrics.overlap import parse_overlap

    spans = _spans(seed)
    want = parse_overlap(_xla_trace(spans))
    got = overlap.parse_overlap(_torch_trace(spans))
    assert want["ok"] and 0 < want["hidden_ms"] < want["collective_ms"]
    assert {k: got[k] for k in want} == want
    # no copies among the seeded kernels: the model hid all of it
    assert (got["model_hidden_ms"], got["model_overlap_efficiency"]) == \
        (got["hidden_ms"], got["overlap_efficiency"])


def test_parse_overlap_leaves_out_nccl_p2p_and_copies():
    """A SendRecv kernel hides nothing and is no collective; a copy hides
    the collective in ``hidden_ms`` but not in ``model_hidden_ms``."""
    spans = [(0, "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.0, 100.0),
             (0, "ncclDevKernel_SendRecv", 0.0, 100.0),
             (0, "fwd_tc_kernel<128, 0>", 0.0, 20.0),
             (0, "void at::native::direct_copy_kernel_cuda", 50.0, 30.0),
             (0, "void at::native::CatArrayBatchedCopy<float>", 70.0, 20.0)]
    got = overlap.parse_overlap(_torch_trace(spans))
    assert (got["collectives"], got["collective_ms"], got["hidden_ms"],
            got["overlap_efficiency"], got["model_hidden_ms"],
            got["model_overlap_efficiency"]) == (1, 0.1, 0.06, 0.6, 0.02, 0.2)


def test_parse_overlap_without_collectives():
    from horovod_tpu.metrics.overlap import parse_overlap

    spans = _spans(3, collectives=False)
    assert parse_overlap(_xla_trace(spans))["ok"] is False
    got = overlap.parse_overlap(_torch_trace(spans))
    assert got["ok"] is False and "no collective kernels" in got["reason"]


def test_measure_overlap_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        overlap.measure_overlap(lambda: None)
