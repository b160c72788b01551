"""The port's autotuner against the JAX package's.

``autotune.gp_fit_predict`` (the native ``GaussianProcess`` of the port's
own core, which ``tune`` ranks with) against ``horovod_tpu.autotune
.gp_fit_predict`` (the JAX package's core) on the same inputs, drawn from
a numpy seed, in 1 to 5 dimensions, at the points ``tune`` measures (its
seed grid: 5 log-spaced values per knob, mapped to the unit cube, and the
log2 thresholds of the 1-D search), random points of the cube included:
bit for bit. The two cores are one source built with the same flags.

``tune`` and ``OnlineTuner`` against ``horovod_tpu.jax.autotune``'s with
``measure_steps_per_s`` replaced, in both modules, by the same
deterministic function of the candidate's knobs: the same candidates in
the same order, the same table, the same best and the same CSV bytes, for
every dimension; and on rates that make a near tie (mirrored about the
middle of the threshold range, so that two candidates' expected
improvements are equal in exact arithmetic and differ by rounding), the
same pick. A GP whose arithmetic rounds apart (the header's loops in
Python, every product rounded, against the core's fused multiply-adds:
1.1e-12 at 34.8 on 9 random points) can break such a tie the other way.
No test times anything.

``train.TuneStepFactory`` on the CPU at a small size: each candidate's
bucket count is the fusion plan's for its knobs, every candidate starts
from the same weights on the same draws (in a world of one the exchange
changes no value, so their first losses are bit-equal), and ZeRO at
``"1x1"`` is bit-equal to the flat step.
"""

import math

import numpy as np
import pytest

from horovod_tpu import autotune as jax_gp
from horovod_tpu.jax import autotune as jax_at
from horovod_tpu_torch import autotune as at


def _gp_problem(seed, dims, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "threshold_grid":       # _ei_suggest's raw log2 thresholds
        X = np.log2(np.array(jax_at.DEFAULT_THRESHOLDS[:n], float))[:, None]
        X = np.tile(X, (1, dims)) + rng.random((n, dims)) * 0.1
    elif kind == "seed_grid":          # distinct points of tune's seed grid,
        grid = np.stack(np.meshgrid(*[np.linspace(0, 1, 5)] * dims),   # in the
                        -1).reshape(-1, dims)                          # unit cube
        X = grid[rng.choice(len(grid), size=min(n, len(grid)), replace=False)]
    else:                              # anywhere in the unit cube
        X = rng.random((n, dims))
    y = rng.normal(size=len(X)) * rng.uniform(0.1, 50) + rng.uniform(-5, 100)
    return X, y, rng.random(dims) * (X.max() - X.min()) + X.min()


def _gp_problems(dims, n, kind):
    for seed in range(20):
        yield _gp_problem(1000 * dims + 10 * n + seed, dims, n, kind)


GP_CASES = [(1, "seed_grid"), (2, "seed_grid"), (3, "seed_grid"),
            (5, "seed_grid"), (8, "seed_grid"), (5, "threshold_grid"),
            (3, "cube"), (6, "cube"), (17, "cube")]


@pytest.mark.parametrize("dims", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n,kind", GP_CASES)
def test_gp_matches_the_native_gp(dims, n, kind):
    for X, y, xs in _gp_problems(dims, n, kind):
        assert at.gp_fit_predict(X, y, xs) == jax_gp.gp_fit_predict(X, y, xs)


def test_gp_raises_where_the_native_gp_fails():
    X = [[0.5], [0.5]]
    # Two equal points are positive definite only by the noise term.
    for fn in (jax_gp.gp_fit_predict, at.gp_fit_predict):
        assert math.isfinite(fn(X, [1.0, 2.0], [0.4])[0])
    with pytest.raises(RuntimeError):
        jax_gp.gp_fit_predict(np.zeros((0, 1)), [], [0.0])
    with pytest.raises(RuntimeError):
        at.gp_fit_predict(np.zeros((0, 1)), [], [0.0])


def _score(knobs: dict) -> float:
    """A deterministic steps/s surface: a peak in log2 threshold near 22.7
    (6.5 MiB), a gain from buckets up to 4, and offsets per category."""
    lt = math.log2(knobs["fusion_threshold"])
    nb = knobs.get("num_buckets", 1)
    rate = 10.0 - 0.35 * (lt - 22.7) ** 2 + 0.8 * math.log2(min(nb, 4)) \
        - 0.2 * max(0, math.log2(nb) - 2)
    rate += {"none": 0.0, "bf16": 0.6, "topk@0.01": -1.1}.get(
        knobs.get("compression", "none"), 0.0)
    rate += 0.45 if knobs.get("hierarchical") else 0.0
    rate += {"": 0.0, "8x1": 0.0, "4x2": 0.3, "2x4": -0.25}.get(
        knobs.get("mesh_shape", ""), 0.0)
    return rate + 0.01 * len(knobs.get("lr", ""))


def _scripted(module, monkeypatch, calls):
    def fake_measure(run_step, warmup=2, iters=5, reps=3, sync=None):
        calls.append(dict(run_step.knobs))
        return _score(run_step.knobs)

    monkeypatch.setattr(module, "measure_steps_per_s", fake_measure)

    def factory(fusion_threshold, **kw):
        def run():
            raise AssertionError("the scripted rate never runs a step")
        run.knobs = {"fusion_threshold": fusion_threshold, **kw}
        return run

    return factory


def _table(report):
    return [(m.branch, m.fusion_threshold, m.steps_per_s, m.num_buckets,
             m.compression, m.hierarchical, m.mesh_shape) for m in report.table]


@pytest.mark.parametrize("kw", [
    {},
    {"num_buckets": (1, 4, 8)},
    {"compressions": ("none", "bf16", "topk@0.01")},
    {"hierarchicals": (False, True)},
    {"mesh_shapes": ("8x1", "4x2", "2x4")},
    {"num_buckets": (1, 4), "compressions": ("none", "bf16"),
     "hierarchicals": (False, True), "mesh_shapes": ("8x1", "4x2")},
    {"branches": [{"lr": "a"}, {"lr": "bb"}], "num_buckets": (2, 8)},
    {"thresholds": (4 << 20, 64 << 20, 256 << 20), "gp_rounds": 4},
], ids=["threshold", "buckets", "compression", "ladder", "mesh", "all",
        "branches", "gp-rounds"])
def test_tune_visits_the_reference_candidates(kw, monkeypatch, tmp_path):
    runs = {}
    for name, module in (("jax", jax_at), ("port", at)):
        calls = []
        factory = _scripted(module, monkeypatch, calls)
        log = tmp_path / f"{name}.csv"
        report = module.tune(factory, log_path=str(log), **kw)
        runs[name] = (calls, _table(report), report.best.config,
                      report.knob_curve(), log.read_bytes())
    assert runs["port"][0] == runs["jax"][0]            # candidates, in order
    assert runs["port"][1] == runs["jax"][1]            # the table, best first
    assert runs["port"][2] == runs["jax"][2]            # the best config
    assert runs["port"][3] == runs["jax"][3]            # the knob curve
    assert runs["port"][4] == runs["jax"][4]            # the CSV, byte for byte
    # The refinement ran: more candidates than the seed grid.
    grid = len(kw.get("thresholds", jax_at.DEFAULT_THRESHOLDS))
    for key in ("num_buckets", "compressions", "hierarchicals", "mesh_shapes",
                "branches"):
        grid *= len(kw.get(key, (1,)))
    assert len(runs["port"][0]) > grid


# Rates of log2(threshold) mirrored about the middle of the thresholds'
# range: the GP's fit is mirrored too, so each candidate of the 1-D search
# and its mirror image have equal expected improvements in exact
# arithmetic, and the first round's pick is a near tie.
NEAR_TIES = {
    "ends_high": ((1 << 20, 1 << 24, 1 << 28), lambda lt: 10.0 + 0.1 * (lt - 24) ** 2),
    "middle_high": ((1 << 20, 1 << 24, 1 << 28), lambda lt: 10.0 - 0.1 * (lt - 24) ** 2),
    "five_points": ((1 << 20, 1 << 22, 1 << 24, 1 << 26, 1 << 28),
                    lambda lt: 7.0 + math.cos(lt - 24)),
    "wide_pair": ((1 << 21, 1 << 27), lambda lt: 3.0 + 1e-3 * (lt - 24) ** 4),
}


@pytest.mark.parametrize("case", sorted(NEAR_TIES))
def test_tune_breaks_a_near_tie_as_the_reference_does(case, monkeypatch):
    thresholds, rate = NEAR_TIES[case]

    def factory(fusion_threshold, **kw):
        def run():
            raise AssertionError("the scripted rate never runs a step")
        run.threshold = fusion_threshold
        return run

    picks, eis = {}, {}
    for name, module in (("jax", jax_at), ("port", at)):
        calls, seen = [], []
        real_ei = module._expected_improvement

        def recorded_ei(mu, sigma, best, real_ei=real_ei, seen=seen):
            seen.append(real_ei(mu, sigma, best))
            return seen[-1]

        def fake_measure(run_step, warmup=2, iters=5, reps=3, sync=None, calls=calls):
            calls.append(run_step.threshold)
            return rate(math.log2(run_step.threshold))

        monkeypatch.setattr(module, "_expected_improvement", recorded_ei)
        monkeypatch.setattr(module, "measure_steps_per_s", fake_measure)
        module.tune(factory, thresholds=thresholds, gp_rounds=1)
        picks[name], eis[name] = calls, seen
    # The same candidates, the GP's pick included, from the same expected
    # improvements, bit for bit.
    assert picks["port"] == picks["jax"]
    assert len(picks["port"]) == len(thresholds) + 1
    assert eis["port"] == eis["jax"]
    # It was a near tie: the two best candidates within 1e-9 of each other.
    top = sorted(eis["jax"], reverse=True)[:2]
    assert top[0] > 0 and top[1] >= top[0] * (1 - 1e-9), top


def _online(module, seed=None, steps=14):
    tuner = module.OnlineTuner(seed=seed)
    seen = []
    for _ in range(steps):
        nxt = tuner.suggest()
        seen.append(nxt)
        if nxt is None:
            break
        tuner.observe(*nxt, _score({"fusion_threshold": nxt[0],
                                    "num_buckets": nxt[1]}))
    return seen, tuner.best(), dict(tuner.measured)


@pytest.mark.parametrize("warm", ["cold", "dict", "report"])
def test_online_tuner_suggests_what_the_reference_suggests(warm, monkeypatch):
    seeds = {"cold": (None, None)}
    if warm == "dict":
        points = {(1 << 20, 1): 7.0, (16 << 20, 1): 9.5, (64 << 20, 4): 8.0}
        seeds["dict"] = (points, points)
    elif warm == "report":
        reports = []
        for module in (jax_at, at):
            factory = _scripted(module, monkeypatch, [])
            reports.append(module.tune(factory, num_buckets=(1, 2), gp_rounds=1))
        seeds["report"] = tuple(reports)
    want = _online(jax_at, seeds[warm][0])
    got = _online(at, seeds[warm][1])
    assert got == want
    assert any(s is not None for s in got[0])


# ------------------------------------------------------- the step factory

SMALL = dict(vocab=64, dim=32, heads=4, layers=2, seq=32)


@pytest.fixture()
def world_of_one():
    from horovod_tpu_torch.common import basics

    yield
    basics.shutdown()


def test_step_factory_candidates_share_weights_and_plans(world_of_one):
    import torch

    from horovod_tpu_torch.convert import jax_ordered
    from horovod_tpu_torch.parallel import fusion
    from horovod_tpu_torch.train import (TrainConfig, TuneStepFactory,
                                         build_model)

    config = TrainConfig(**SMALL, steps_per_dispatch=2)
    factory = TuneStepFactory(config, "cpu")
    thresholds = (1 << 10, 1 << 14, 1 << 20)
    report = at.tune(factory, thresholds=thresholds, num_buckets=(1, 3),
                     compressions=("none", "bf16"), warmup=1, iters=1,
                     reps=1, gp_rounds=1)
    factory.close()
    params = [p for _, p in jax_ordered(build_model(config, "cpu").named_parameters())]
    assert len(factory.records) == len(report.table)
    for r in factory.records:
        plan = fusion.build_plan(params, r["fusion_threshold"], r["num_buckets"])
        assert r["planned_buckets"] == plan.num_buckets, r
        assert r["graphed"] and len(r["losses"]) == 2
        assert all(math.isfinite(x) for x in r["losses"])
    assert len({r["planned_buckets"] for r in factory.records}) > 2
    none = [r["losses"] for r in factory.records if r["compression"] == "none"]
    assert all(losses == none[0] for losses in none)
    bf16 = [r["losses"] for r in factory.records if r["compression"] == "bf16"]
    assert bf16 and all(abs(a - b) <= 1e-2 * abs(b)
                        for losses in bf16 for a, b in zip(losses, none[0]))
    # The wire reached the optimizer. (Its losses cannot show it here: in a
    # world of one the bf16 gradient moves Adam's first update, a sign with
    # |g| / (|g| + eps), by far less than float32 keeps.)
    for r in factory.records:
        bf16_buckets = [w for w in r["wires"] if w == "bfloat16"]
        assert len(r["wires"]) == r["planned_buckets"]
        assert bool(bf16_buckets) == (r["compression"] == "bf16"), r
    assert torch.isfinite(torch.tensor(none[0])).all()


def test_step_factory_zero_at_one_shard_is_the_flat_step(world_of_one):
    from horovod_tpu_torch.train import TrainConfig, TuneStepFactory

    factory = TuneStepFactory(TrainConfig(**SMALL, steps_per_dispatch=3), "cpu")
    flat = at.tune(factory, thresholds=(1 << 12,), warmup=1, iters=2, reps=1,
                   gp_rounds=0)
    zero = at.tune(factory, thresholds=(1 << 12,), mesh_shapes=("1x1",),
                   warmup=1, iters=2, reps=1, gp_rounds=0)
    factory.close()
    assert zero.best.mesh_shape == "1x1" and not flat.best.mesh_shape
    first, second = factory.records
    assert first["graphed"] and second["graphed"]
    assert second["losses"] == first["losses"]
    assert second["planned_buckets"] == first["planned_buckets"]


def _gloo_world(script: str, **env_extra) -> str:
    """``tests/<script>`` on four gloo ranks laid out 2 x 2; rank 0's
    stdout, after every rank exited 0."""
    import os
    import subprocess
    import sys

    from launch_util import REPO, free_port

    port = free_port()
    procs = []
    for rank in range(4):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
        env.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE="4",
                   HOROVOD_LOCAL_RANK=str(rank % 2), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", OMP_NUM_THREADS="1",
                   **env_extra)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", script)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs, failures = [], []
    for rank, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failures.append(f"rank {rank} exit {proc.returncode}:\n{err[-3000:]}")
    assert not failures, "\n".join(failures)
    print(outs[0])
    return outs[0]


def test_autotune_world_on_gloo():
    """tests/torch_port_autotune_worker.py on four gloo ranks laid out
    2 x 2, a small model: tune over the ZeRO layouts and the ladder, and
    each candidate's updates after 3 steps against flat DP's."""
    out = _gloo_world("torch_port_autotune_worker.py", AUTOTUNE_MODE="cpu")
    assert "ok autotune world 4" in out
    assert out.count("step ms per rank") == 8     # 3 meshes x 2 + flat x 2


def test_tune_and_controller_agree_across_ranks():
    """tests/torch_port_agree_worker.py on four gloo ranks: ``tune`` with
    two GP/EI rounds and the ``TrainingController`` fed rates and clocks
    that differ by rank make the same choices on every rank, from the
    slowest rank's rates and rank 0's clock."""
    assert "ok agree world 4" in _gloo_world("torch_port_agree_worker.py")
