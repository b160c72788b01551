"""The training-side runtime controller: the port of
``horovod_tpu/control/training.py`` (``TrainingController`` ``:87-294``,
``controller_enabled`` ``:296``).

One per job, driven from the step loop: ``on_step(steps_per_s)`` once per
step or measurement window; sensing, proposing, canarying, committing and
rolling back happen inside. Sensors: the observed steps/s, the
``horovod_critical_path_wire_seconds{tier}`` gauges of the metrics
registry where something sets them, and the anomaly firings
(``wire_drift``, ``demotion_storm``) of a detector passed as ``anomaly``.

Actuators:

- ``ENGINE_KNOBS`` (wire format, top-k ratio, plane) through the eager
  engine's ``set_knobs`` when one is attached (``engine=``,
  ``basics.engine()``): the coordinator commits the table world-wide
  through its knob epoch (``knob_change``), so every rank's engine adopts
  it at once. With ``engine=None`` they go through ``rejit``, as a
  compiled-plane job of the JAX package's does (``:159-175``);
- ``REJIT_KNOBS`` (fusion threshold, bucket count, ladder, mesh) through
  the ``rejit`` callback: the optimizer rebuilt with the new value and the
  CUDA graph captured again, keeping the model, the optimizer state and
  the data cache's position (``train.TrainRecapture``), where the JAX
  package re-jits.

In a multi-rank job every rank runs a controller and lands each change
through its own ``rejit``, so all of them must decide alike: each
observation is agreed first (``autotune.agreed_max``: the slowest rank's
steps/s, rank 0's clock, the largest wire-time gauges, an anomaly on any
rank), and every rank decides from the same numbers.

Policy, one change at a time, each canaried by the ``ControlLoop``:
(1) degradation: throughput below baseline / ``COLLAPSE_FACTOR`` for
``COLLAPSE_TICKS`` observations while the cross tier owns the wire time
(or ``wire_drift`` fired) steps the wire format down ``WIRE_LADDER``;
(2) recovery: after such a commit, every ``RECOVERY_PROBE_OBS`` idle
observations it canaries one step back up; (3) hill climb: otherwise the
warm-started GP/EI of ``autotune.OnlineTuner`` proposes the next
(fusion threshold, bucket count).
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Optional

from ..autotune import OnlineTuner, agreed_max
from .core import ControlLoop, Knob

#: the wire-format byte ladder, widest first; degradation steps right
#: (fewer bytes), recovery probes step left (full width).
WIRE_LADDER = ("none", "bf16", "fp16", "topk@0.01")

#: throughput must sit below baseline/COLLAPSE_FACTOR for this many
#: consecutive on_step calls before the degradation rule fires.
COLLAPSE_TICKS = 3
COLLAPSE_FACTOR = 1.5

#: idle observations between recovery probes back up the ladder.
RECOVERY_PROBE_OBS = 8

KNOBS = {
    "compression": Knob("compression", "choice", choices=WIRE_LADDER),
    "topk_ratio": Knob("topk_ratio", "float", lo=0.001, hi=0.1),
    "fusion_threshold": Knob("fusion_threshold", "int",
                             lo=1 << 20, hi=256 << 20),
    "num_buckets": Knob("num_buckets", "int", lo=1, hi=32),
    "hierarchical": Knob("hierarchical", "bool"),
    "plane": Knob("plane", "choice", choices=("auto", "ring", "star")),
}

#: which actuator lands each knob. "mesh" (the ('batch','shard','model')
#: layout) only registers when the controller is built with
#: mesh_choices=: reshaping the mesh re-partitions the parameters, so it
#: is strictly a rejit-class change.
ENGINE_KNOBS = frozenset({"compression", "topk_ratio", "plane"})
REJIT_KNOBS = frozenset({"fusion_threshold", "num_buckets", "hierarchical",
                         "mesh"})


def _tier(gauges: dict, name: str, t: str) -> float:
    return float(gauges.get(f'{name}{{tier="{t}"}}', 0) or 0)


class TrainingController:
    """The per-job training control loop. Drive it from the step loop:
    call :meth:`on_step` once per step (or measurement window) with the
    observed steps/s; everything else — sensing, proposing, canarying,
    committing, rolling back — happens inside.

    ``rejit(change)`` gets ``{knob: value}`` and must land it before it
    returns (raise to veto). ``mesh_choices`` registers the ``mesh`` knob
    over those HOROVOD_MESH specs, each checked against ``world_size``
    (None: the world of ``init()``)."""

    def __init__(self, engine=None,
                 rejit: Optional[Callable[[dict], None]] = None,
                 canary_steps: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 tolerance: Optional[float] = None,
                 warm_start=None,
                 anomaly=None,
                 reg=None,
                 mesh_choices=None,
                 world_size: Optional[int] = None) -> None:
        self.engine = engine
        self.rejit = rejit
        if reg is None:
            from ..metrics import registry as _registry

            reg = _registry()
        self.reg = reg
        knobs = dict(KNOBS)
        # The mesh layout as a knob: the legal shapes are job-specific, so
        # the caller enumerates them; each is a HOROVOD_MESH spec checked
        # by parse_mesh_spec against the world size.
        self.mesh_choices = tuple(mesh_choices) if mesh_choices else ()
        if self.mesh_choices:
            from ..common import basics
            from ..parallel.mesh import parse_mesh_spec

            world = world_size if world_size is not None else basics.size()
            for spec in self.mesh_choices:
                parse_mesh_spec(spec, world)
            knobs["mesh"] = Knob("mesh", "choice",
                                 choices=self.mesh_choices)
        self.loop = ControlLoop(knobs, self._apply, plane="training",
                                canary_steps=canary_steps,
                                cooldown_s=cooldown_s,
                                tolerance=tolerance, reg=reg)
        # Launch values: the engine's own table where one is attached.
        self.loop.set_current("compression", "none")
        self.loop.set_current("topk_ratio", 0.01)
        self.loop.set_current("fusion_threshold", 64 << 20)
        self.loop.set_current("num_buckets", 1)
        self.loop.set_current("hierarchical", False)
        self.loop.set_current("plane", "auto")
        if self.mesh_choices:
            cur = os.environ.get("HOROVOD_MESH", "").strip()
            if cur not in self.mesh_choices:
                cur = self.mesh_choices[0]
            self.loop.set_current("mesh", cur)
        if engine is not None:
            knobs = getattr(engine, "_knobs", None) or {}
            if knobs.get("compression") in WIRE_LADDER:
                self.loop.set_current("compression", knobs["compression"])
            if knobs.get("topk_ratio"):
                self.loop.set_current("topk_ratio", knobs["topk_ratio"])
        self.tuner = OnlineTuner(seed=warm_start)
        self._low_ticks = 0
        self._anomalies: list[str] = []     # pending firings, drained per step
        self._degraded = False              # a degradation rule committed
        self._idle_obs = 0
        self._anomaly = anomaly
        if anomaly is not None:
            anomaly.subscribe(self._on_anomaly)

    # -- actuation -----------------------------------------------------------

    def _apply(self, name: str, value: Any) -> None:
        if name in ENGINE_KNOBS:
            if self.engine is not None:
                self.engine.set_knobs({name: value})
            elif self.rejit is not None:
                # No engine: the wire format is fixed when the optimizer
                # is built, so the rebuild is its switch too.
                self.rejit({name: value})
            else:
                raise RuntimeError(f"no actuator attached for {name}")
        if name in REJIT_KNOBS:
            if self.rejit is None:
                raise RuntimeError(
                    f"{name} is fixed when the optimizer is built: attach "
                    "a rejit callback to retune it")
            self.rejit({name: value})

    def _on_anomaly(self, kind: str, detail: dict) -> None:
        if kind in ("wire_drift", "demotion_storm"):
            self._anomalies.append(kind)

    # -- the loop ------------------------------------------------------------

    def on_step(self, steps_per_s: float) -> Optional[str]:
        """One observation; returns "commit"/"rollback" on a canary verdict
        (None otherwise). Call from the training loop after each step or
        measurement window."""
        steps_per_s, now, wire, fired = self._agreed(steps_per_s)
        verdict = self.loop.observe(steps_per_s, now=now)
        if verdict == "commit":
            p = self.loop.history[-1]
            if p["knob"] in ("fusion_threshold", "num_buckets"):
                self.tuner.observe(self.loop.values["fusion_threshold"],
                                   self.loop.values["num_buckets"],
                                   self.loop.baseline or steps_per_s)
            if p["knob"] == "compression" and "degradation" in p["reason"]:
                self._degraded = True
            if p["knob"] == "compression" and "recovery" in p["reason"]:
                # Full recovery = back at the ladder's widest live format.
                if p["value"] == WIRE_LADDER[0]:
                    self._degraded = False
        if verdict == "rollback":
            p = self.loop.history[-1]
            if p["knob"] in ("fusion_threshold", "num_buckets"):
                # Teach the model the rejected point so EI moves on.
                mean = p.get("canary_mean", 0.0)
                th = p["value"] if p["knob"] == "fusion_threshold" \
                    else self.loop.values["fusion_threshold"]
                nb = p["value"] if p["knob"] == "num_buckets" \
                    else self.loop.values["num_buckets"]
                self.tuner.observe(int(th), int(nb), float(mean))
        if self.loop.in_canary:
            return verdict
        self._sense(steps_per_s, now, wire, fired)
        return verdict

    def _agreed(self, steps_per_s: float):
        """(steps/s, clock, (cross, local) wire seconds, anomaly fired) as
        every rank of the world sees them; see the module docstring."""
        from ..common import basics

        first = not basics.is_initialized() or basics.rank() == 0
        gauges = self.reg.snapshot().get("gauges", {})
        v = agreed_max([
            -float(steps_per_s), time.monotonic() if first else -math.inf,
            _tier(gauges, "horovod_critical_path_wire_seconds", "cross"),
            _tier(gauges, "horovod_critical_path_wire_seconds", "local"),
            1.0 if self._anomalies else 0.0])
        return -v[0], v[1], (v[2], v[3]), v[4] > 0

    def _sense(self, steps_per_s: float, now: float, wire: tuple,
               fired: bool) -> None:
        """Deterministic rule pass: at most one proposal."""
        baseline = self.loop.baseline or 0.0
        collapsed = baseline > 0 and \
            steps_per_s < baseline / COLLAPSE_FACTOR
        self._low_ticks = self._low_ticks + 1 if collapsed else 0
        self._anomalies = []

        # Rule 1: degradation — wire time on the cross tier (or the
        # anomaly stream says the wire drifted) while throughput collapsed.
        cross_s, local_s = wire
        cross_dominant = cross_s > local_s
        if (self._low_ticks >= COLLAPSE_TICKS and
                (cross_dominant or fired or not (cross_s or local_s))):
            cur = self.loop.values["compression"]
            nxt = KNOBS["compression"].step(cur, +1)
            if nxt is not None and self.loop.propose(
                    "compression", nxt,
                    f"degradation: {steps_per_s:.3g}/s vs baseline "
                    f"{baseline:.3g}/s, cross wire {cross_s:.3g}s",
                    now=now):
                self._low_ticks = 0
                self._idle_obs = 0
                return
        # Rule 2: recovery probe — degraded mode, throughput steady:
        # periodically canary one step back toward full width; the canary
        # keeps it only if the fault really cleared.
        self._idle_obs += 1
        if self._degraded and self._idle_obs >= RECOVERY_PROBE_OBS:
            cur = self.loop.values["compression"]
            prv = KNOBS["compression"].step(cur, -1)
            if prv is not None and self.loop.propose(
                    "compression", prv, "recovery probe toward full width",
                    now=now):
                self._idle_obs = 0
                return
            self._idle_obs = 0
        # Rule 3: hill climb — warm-started GP/EI over the continuous
        # knobs (only when an actuator for them is attached).
        if self.rejit is not None and not self._degraded \
                and self._idle_obs >= self.loop.canary_steps:
            self.tuner.observe(self.loop.values["fusion_threshold"],
                               self.loop.values["num_buckets"],
                               baseline or steps_per_s)
            nxt = self.tuner.suggest()
            if nxt is not None:
                th, nb = nxt
                # One knob per canary: land the bucket coordinate first —
                # a suggested threshold differs from the current value
                # almost always, so splitting threshold-first would starve
                # the bucket dimension of any spread and the joint EI
                # would never activate.
                if nb != self.loop.values["num_buckets"]:
                    name, val = "num_buckets", nb
                else:
                    name, val = "fusion_threshold", th
                if self.loop.propose(name, val,
                                     "GP/EI hill climb (warm-started)",
                                     now=now):
                    self._idle_obs = 0

    # -- reporting -----------------------------------------------------------

    def report(self) -> dict:
        return {
            "values": dict(self.loop.values),
            "baseline": self.loop.baseline,
            "degraded": self._degraded,
            "decisions": list(self.loop.history),
        }

    def close(self) -> None:
        if self._anomaly is not None:
            try:
                self._anomaly.unsubscribe(self._on_anomaly)
            except Exception:  # noqa: BLE001
                pass


def controller_enabled() -> bool:
    """The HOROVOD_CONTROLLER master switch (off by default: the
    controller changes value-affecting knobs mid-job)."""
    return (os.environ.get("HOROVOD_CONTROLLER", "") or "0") not in (
        "0", "false", "")


__all__ = ["TrainingController", "KNOBS", "WIRE_LADDER",
           "controller_enabled"]
