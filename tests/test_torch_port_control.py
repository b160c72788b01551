"""The port's runtime controller against the JAX package's.

Every case of the training side of tests/test_controller.py (the knob
table, the propose -> canary -> commit/rollback loop, the decision
counters, the training rules, the mesh knob) runs on both packages with
the same hand-fed scores and explicit clocks, and must give the same
answers, the same applied changes and the same decision history (the
wall-clock stamp of each decision excepted). Then a long run of the hill
climb on a deterministic throughput surface: the same proposals, in the
same order, with the same verdicts. No thread, no sleep.

Then ``train.TrainRecapture``, the ``rejit`` hook, on a small
TransformerLM on the CPU in a world of one: rebuilding the optimizer
with other knobs mid-run keeps the model, Adam's state and the cache's
position, so the losses stay bit-equal to a run that never changed; and
a ``TrainingController`` driving it decides while the losses stay equal.
"""

import math

import pytest

import horovod_tpu.control as jax_control
import horovod_tpu.control.training as jax_training
import horovod_tpu_torch.control as port_control
import horovod_tpu_torch.control.training as port_training
from horovod_tpu.metrics.registry import MetricsRegistry as JaxRegistry
from horovod_tpu_torch.metrics.registry import MetricsRegistry as PortRegistry

PACKAGES = {
    "jax": (jax_control, jax_training, JaxRegistry),
    "port": (port_control, port_training, PortRegistry),
}


def _history(loop):
    return [{k: v for k, v in p.items() if k != "time_unix_s"}
            for p in loop.history]


def _both(scenario):
    """The scenario's record on each package; asserts they are equal."""
    out = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def _loop(control, Reg, applied, canary_steps=3, tolerance=0.05,
          cooldown_s=0.0, knobs=None):
    knobs = knobs or {"x": control.Knob("x", "int", lo=1, hi=64)}
    return control.ControlLoop(knobs, lambda n, v: applied.append((n, v)),
                               canary_steps=canary_steps, tolerance=tolerance,
                               cooldown_s=cooldown_s, reg=Reg())


def _settle(loop, score=10.0, n=8):
    for _ in range(n):
        loop.observe(score, now=0.0)


def test_knob_clamp_bounds_and_ladders():
    def scenario(control, training, Reg):
        Knob = control.Knob
        k, f = Knob("t", "int", lo=4, hi=32), Knob("r", "float", lo=0.5, hi=2.0)
        c = Knob("c", "choice", choices=training.WIRE_LADDER)
        b, n = Knob("b", "bool"), Knob("n", "int", lo=1, hi=8)
        return ([k.clamp(v) for v in (1, 100, 8)],
                [k.in_bounds(v) for v in (4, 32, 33, "x")],
                [f.clamp(10), f.in_bounds(1.0)],
                [c.clamp("zzz"), c.in_bounds("bf16"), c.in_bounds("zzz")],
                [c.step(v, d) for v in training.WIRE_LADDER for d in (1, -1)],
                [n.step(v, d) for v in (1, 2, 8) for d in (1, -1)],
                [b.step(False, 1), b.step(True, 1), b.step(True, -1)])

    _both(scenario)


def test_propose_refusals_one_in_flight_and_cooldown():
    def scenario(control, training, Reg):
        applied = []
        loop = _loop(control, Reg, applied, canary_steps=2, cooldown_s=10.0)
        loop.set_current("x", 8)
        _settle(loop)
        out = [loop.propose("x", 8, "same value", now=100.0),
               loop.propose("nope", 4, "unknown knob", now=100.0),
               loop.propose("x", 16, "first", now=100.0), loop.in_canary,
               loop.propose("x", 32, "second while canarying", now=100.0),
               loop.observe(10.0, now=101.0), loop.observe(10.0, now=102.0),
               loop.propose("x", 32, "inside cooldown", now=105.0),
               loop.cooldown_remaining(105.0),
               loop.propose("x", 32, "after cooldown", now=113.0)]
        loop.set_current("x", 64)
        out.append(loop.propose("x", 10_000, "clamps onto current", now=200.0))
        return out, applied, _history(loop), dict(loop.values)

    _both(scenario)


def test_apply_veto_leaves_the_loop_as_it_was():
    def scenario(control, training, Reg):
        def veto(name, value):
            raise RuntimeError("actuator says no")

        loop = control.ControlLoop({"x": control.Knob("x", "int", lo=1, hi=64)},
                                   veto, canary_steps=2, cooldown_s=0.0, reg=Reg())
        loop.set_current("x", 8)
        _settle(loop)
        return loop.propose("x", 16, "vetoed", now=1.0), loop.in_canary, \
            dict(loop.values)

    assert _both(scenario) == (False, False, {"x": 8})


@pytest.mark.parametrize("scores,tolerance", [
    ((10.1, 9.9, 10.0), 0.05),       # steady: commit
    ((5.0, 5.0, 5.0), 0.05),         # halved: rollback
    ((9.6, 9.6, 9.6), 0.10),         # 4% down inside 10%: commit
    ((9.6, 9.6, 9.6), 0.01),         # 4% down outside 1%: rollback
], ids=["commit", "rollback", "tolerance-commit", "tolerance-rollback"])
def test_canary_verdicts(scores, tolerance):
    def scenario(control, training, Reg):
        applied = []
        loop = _loop(control, Reg, applied, tolerance=tolerance)
        loop.set_current("x", 8)
        _settle(loop, 10.0)
        assert loop.propose("x", 16, "try wider", now=1.0)
        verdicts = [loop.observe(s, now=2.0) for s in scores]
        return (verdicts, applied, _history(loop), dict(loop.values),
                loop.baseline)

    _both(scenario)


def test_decision_counters_and_history():
    def scenario(control, training, Reg):
        reg = Reg()
        loop = control.ControlLoop({"x": control.Knob("x", "int", lo=1, hi=64)},
                                   lambda n, v: None, canary_steps=2,
                                   cooldown_s=0.0, reg=reg)
        loop.set_current("x", 8)
        _settle(loop, 10.0)
        loop.propose("x", 16, "a", now=1.0)
        loop.observe(10.0, now=1.0), loop.observe(10.0, now=1.0)
        loop.propose("x", 32, "b", now=2.0)
        loop.observe(1.0, now=2.0), loop.observe(1.0, now=2.0)
        counters = {k: v for k, v in reg.snapshot()["counters"].items()
                    if k.startswith("horovod_controller_decisions_total")}
        return counters, _history(loop)

    counters, history = _both(scenario)
    assert [p["verdict"] for p in history] == ["commit", "rollback"]
    assert counters['horovod_controller_decisions_total'
                    '{action="propose",plane="training"}'] == 2


class _FakeEngine:
    def __init__(self):
        self.tables = []
        self._knobs = {"compression": "none", "topk_ratio": 0.01}

    def set_knobs(self, table):
        self.tables.append(dict(table))
        self._knobs.update(table)
        return len(self.tables)


def _controller(control, Reg, **kw):
    kw.setdefault("canary_steps", 2)
    return control.TrainingController(cooldown_s=0.0, reg=Reg(), **kw)


@pytest.mark.parametrize("scores", [
    [10.0] * 8 + [2.0] * 3 + [9.8] * 2,                 # degrade, commit
    [10.0] * 8 + [2.0] * 3 + [9.8] * 2 + [10.0] * 20,   # then recover
    [10.0] * 8 + [2.0] * 3 + [2.0] * 2,                 # degrade, roll back
], ids=["degradation", "recovery", "rollback"])
def test_training_rules_on_an_engine(scores):
    def scenario(control, training, Reg):
        eng = _FakeEngine()
        tc = _controller(control, Reg, engine=eng)
        verdicts = [tc.on_step(s) for s in scores]
        rep = tc.report()
        rep["decisions"] = _history(tc.loop)
        return verdicts, eng.tables, rep

    verdicts, tables, rep = _both(scenario)
    assert tables and tables[0] == {"compression": "bf16"}


def test_training_rejit_knobs_need_the_callback():
    def scenario(control, training, Reg):
        tc = _controller(control, Reg, engine=_FakeEngine())
        for _ in range(8):
            tc.on_step(10.0)
        refused = tc.loop.propose("fusion_threshold", 128 << 20, "no rejit")
        rejits = []
        tc2 = _controller(control, Reg, engine=_FakeEngine(), rejit=rejits.append)
        for _ in range(8):
            tc2.on_step(10.0)
        return refused, rejits, _history(tc2.loop)

    refused, rejits, _ = _both(scenario)
    assert refused is False and rejits
    assert all(set(r) <= {"fusion_threshold", "num_buckets"} for r in rejits)


def test_training_without_an_engine_sends_the_wire_through_rejit():
    def scenario(control, training, Reg):
        rejits = []
        tc = _controller(control, Reg, rejit=rejits.append)
        for s in [10.0] * 3 + [2.0] * 3 + [2.0] * 2:
            tc.on_step(s)
        return rejits, _history(tc.loop)

    rejits, _ = _both(scenario)
    assert {"compression": "bf16"} in rejits


def test_training_mesh_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_MESH", "4x2x1")

    def scenario(control, training, Reg):
        rejits = []
        kw = {"world_size": 8} if control is port_control else {}
        tc = _controller(control, Reg, engine=_FakeEngine(), rejit=rejits.append,
                         mesh_choices=("4x2x1", "2x2x2"), **kw)
        start = tc.loop.values["mesh"]
        proposed = tc.loop.propose("mesh", "2x2x2", "operator reshape")
        verdicts = [tc.on_step(10.0) for _ in range(3)]
        return start, proposed, rejits, verdicts, tc.loop.values["mesh"]

    start, proposed, rejits, verdicts, final = _both(scenario)
    assert start == "4x2x1" and proposed and {"mesh": "2x2x2"} in rejits
    assert "commit" in verdicts and final == "2x2x2"


def test_training_mesh_knob_validates_choices():
    import jax

    with pytest.raises(ValueError):
        jax_control.TrainingController(engine=_FakeEngine(),
                                       reg=JaxRegistry(),
                                       mesh_choices=("16x1x1",))
    with pytest.raises(ValueError):
        port_control.TrainingController(engine=_FakeEngine(),
                                        reg=PortRegistry(),
                                        mesh_choices=("16x1x1",),
                                        world_size=jax.device_count())
    tc = port_control.TrainingController(engine=_FakeEngine(),
                                         reg=PortRegistry())
    assert "mesh" not in tc.loop.values
    assert not tc.loop.propose("mesh", "2x2x2", "unregistered knob")


def _surface(values) -> float:
    """steps/s as a function of the live knobs: a peak at 16 MiB and 4
    buckets, a small dip for bf16."""
    lt = math.log2(values["fusion_threshold"])
    nb = values["num_buckets"]
    return (12.0 - 0.3 * (lt - 24) ** 2 - 0.4 * (math.log2(nb) - 2) ** 2
            - (0.2 if values["compression"] != "none" else 0.0))


@pytest.mark.parametrize("warm", [None, "offline"])
def test_hill_climb_makes_the_reference_decisions(warm):
    def scenario(control, training, Reg):
        rejits = []
        seed = None
        if warm:
            seed = {(1 << 20, 1): 8.0, (64 << 20, 1): 10.5, (16 << 20, 4): 11.5}
        tc = _controller(control, Reg, rejit=rejits.append, canary_steps=3,
                         warm_start=seed)
        verdicts = []
        for i in range(120):
            noise = 0.02 * ((i * 7919) % 5 - 2)
            verdicts.append(tc.on_step(_surface(tc.loop.values) + noise))
        return (verdicts, rejits, _history(tc.loop), dict(tc.loop.values),
                sorted(tc.tuner.measured.items()))

    verdicts, rejits, history, values, _ = _both(scenario)
    assert len(history) >= 5
    assert {"commit", "rollback"} <= {p["verdict"] for p in history}


def test_controller_enabled_reads_the_switch(monkeypatch):
    for value, want in (("", False), ("0", False), ("false", False), ("1", True)):
        monkeypatch.setenv("HOROVOD_CONTROLLER", value)
        assert port_control.controller_enabled() is want
        assert jax_training.controller_enabled() is want


# ------------------------------------------------- the recapture hook

SMALL = dict(vocab=64, dim=32, heads=4, layers=2, seq=32, steps_per_dispatch=2)


@pytest.fixture()
def world_of_one():
    from horovod_tpu_torch.common import basics

    yield
    basics.shutdown()


def _dispatch_losses(job, n, changes=None):
    out = []
    for i in range(n):
        if changes and i in changes:
            job.rejit(changes[i])
        job()
        out.append(job.loop.losses.tolist())
    return out


def test_rejit_keeps_the_run_bit_equal(world_of_one):
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.train import TrainConfig, TrainRecapture

    config = TrainConfig(**SMALL)
    job = TrainRecapture(config, "cpu")
    changed = _dispatch_losses(job, 6, {
        2: {"fusion_threshold": 1 << 10, "num_buckets": 3},
        4: {"hierarchical": True, "fusion_threshold": 1 << 20}})
    assert [c for c, _ in job.recaptures] == [
        {"fusion_threshold": 1 << 10, "num_buckets": 3},
        {"hierarchical": True, "fusion_threshold": 1 << 20}]
    assert job.s.opt.hierarchical and job.s.opt.plan.num_buckets >= 1
    state = {n: p.detach().clone() for n, p in job.s.model.named_parameters()}
    moments = [v.clone() for st in job.s.opt.optimizer.state.values()
               for v in st.values()]
    basics.shutdown()
    plain = TrainRecapture(config, "cpu")
    assert _dispatch_losses(plain, 6) == changed
    for n, p in plain.s.model.named_parameters():
        assert (p == state[n]).all(), n
    want = [v for st in plain.s.opt.optimizer.state.values() for v in st.values()]
    assert all((a == b).all() for a, b in zip(moments, want))
    with pytest.raises(ValueError, match="cannot change"):
        plain.rejit({"mesh": "1x1"})


def test_controller_drives_the_recapture_bit_equal(world_of_one):
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.train import TrainConfig, TrainRecapture

    config = TrainConfig(**SMALL)
    job = TrainRecapture(config, "cpu")
    tc = port_control.TrainingController(rejit=job.rejit, canary_steps=2,
                                         cooldown_s=0.0,
                                         reg=PortRegistry())
    losses = []
    for i in range(12):
        job()
        losses.append(job.loop.losses.tolist())
        tc.on_step(10.0 + 0.01 * (i % 3))      # scripted steps/s
    assert tc.loop.history and job.recaptures
    assert all(p["verdict"] in ("commit", "rollback") for p in tc.loop.history)
    basics.shutdown()
    assert _dispatch_losses(TrainRecapture(config, "cpu"), 12) == losses


class _NoFlight:
    def event(self, *a, **k):
        pass

    def dump(self, *a, **k):
        return ""


def test_anomaly_detector_feeds_the_controller():
    """The port's own ``AnomalyDetector`` (``metrics/anomaly.py``) drives
    ``TrainingController(anomaly=)`` as the JAX package's drives its own:
    a wire-byte spike after a steady baseline fires ``wire_drift``, the
    controller takes it at its next step, and both packages record the
    same firings, engine tables and decisions. The controller unsubscribes
    on ``close()``."""
    import horovod_tpu.metrics.anomaly as jax_anomaly
    import horovod_tpu_torch.metrics.anomaly as port_anomaly

    anomalies = {JaxRegistry: jax_anomaly, PortRegistry: port_anomaly}

    def scenario(control, training, Reg):
        reg = Reg()
        det = anomalies[Reg].AnomalyDetector(reg=reg, factor=4.0, cooldown_s=0.0,
                                             flight=_NoFlight())
        eng = _FakeEngine()
        tc = _controller(control, Reg, engine=eng, anomaly=det)
        fired, verdicts = [], []
        for t in range(16):
            reg.counter("horovod_wire_bytes_total", plane="eager").inc(
                40000 if t == 12 else 1000)
            fired.append(det.tick(now=float(t)))
            verdicts.append(tc.on_step(10.0))
        seen = list(tc._anomalies)
        tc.close()
        subscribed = len(det._subscribers)
        return fired, verdicts, eng.tables, _history(tc.loop), seen, subscribed

    fired, verdicts, tables, history, seen, subscribed = _both(scenario)
    assert ["wire_drift"] in fired and subscribed == 0
