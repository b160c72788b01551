"""The propose -> canary -> commit/rollback state machine: the port of
``horovod_tpu/control/core.py`` (``Knob`` ``:44``, ``Proposal`` ``:97``,
``ControlLoop`` ``:110``).

``ControlLoop`` is the skeleton of the training and serving controllers:
a bounded knob table, ONE change in flight at a time, every change
canaried for K observations against the pre-change baseline and rolled
back on regression. It holds no sensor logic: the training controller
feeds it steps/s and supplies the ``apply`` callback that lands a value (a
rebuilt optimizer and a recaptured graph, ``control/training.py``); the
serving controller feeds it goodput and sets the routers' live
``ServeConfig`` (``control/serving.py``).
``HOROVOD_CONTROLLER_CANARY_STEPS`` and ``HOROVOD_CONTROLLER_COOLDOWN_S``
set the canary length and the cooldown after a decision.

Each decision counts in ``horovod_controller_decisions_total{action,
plane}`` of the port's metrics registry, lands in ``history``, and is
recorded as a flight-ring event and, under HOROVOD_TRACE_DIR, a point
span (``_event``, as ``:277-299`` of the JAX package's).
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..utils.logging import log

#: default canary length (observations) and tolerance: a change survives
#: when its canary mean stays within (1 - tolerance) of the baseline.
DEFAULT_CANARY_STEPS = 5
DEFAULT_TOLERANCE = 0.05
DEFAULT_COOLDOWN_S = 5.0

_EWMA_ALPHA = 0.3


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class Knob:
    """One retunable knob: its value domain and bounds.

    ``kind``:
      - ``"int"`` / ``"float"`` — numeric, clamped to [lo, hi];
      - ``"choice"`` — categorical over ``choices`` (ordered: the rule
        tables step along this ladder);
      - ``"bool"`` — True/False.
    """

    name: str
    kind: str
    lo: float = 0.0
    hi: float = 0.0
    choices: tuple = ()

    def clamp(self, value: Any) -> Any:
        if self.kind == "bool":
            return bool(value)
        if self.kind == "choice":
            return value if value in self.choices else self.choices[0]
        v = max(self.lo, min(self.hi, float(value)))
        return int(round(v)) if self.kind == "int" else v

    def in_bounds(self, value: Any) -> bool:
        if self.kind == "bool":
            return isinstance(value, bool)
        if self.kind == "choice":
            return value in self.choices
        try:
            return self.lo <= float(value) <= self.hi
        except (TypeError, ValueError):
            return False

    def step(self, value: Any, direction: int) -> Optional[Any]:
        """The next value along the knob's ladder (rule-table moves):
        choices step by index, numerics double/halve within bounds.
        Returns None when already at the edge."""
        if self.kind == "bool":
            nxt = bool(direction > 0)
            return None if nxt == value else nxt
        if self.kind == "choice":
            i = self.choices.index(value) if value in self.choices else 0
            j = i + (1 if direction > 0 else -1)
            if not 0 <= j < len(self.choices):
                return None
            return self.choices[j]
        cur = float(value)
        nxt = self.clamp(cur * 2.0 if direction > 0 else cur / 2.0)
        return None if nxt == self.clamp(cur) else nxt


@dataclass
class Proposal:
    """One in-flight (or decided) knob change."""

    knob: str
    value: Any
    prev: Any
    reason: str
    baseline: float = 0.0
    scores: list = field(default_factory=list)
    verdict: str = ""          # "" while canarying, then commit | rollback
    mitigation: bool = False   # judged vs the collapsed level, not the EWMA


class ControlLoop:
    """Bounded, canaried, one-at-a-time knob changes.

    ``apply_cb(knob_name, value)`` must land the value (and raise to veto
    the proposal — a failed apply never enters canary). ``observe(score)``
    is the single sensor feed: higher is better (steps/s, goodput/s); the
    loop keeps the pre-change EWMA baseline itself.
    """

    def __init__(self, knobs: dict[str, Knob],
                 apply_cb: Callable[[str, Any], None],
                 plane: str = "training",
                 canary_steps: Optional[int] = None,
                 tolerance: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 reg=None) -> None:
        self.knobs = dict(knobs)
        self._apply = apply_cb
        self.plane = plane
        self.canary_steps = int(canary_steps if canary_steps is not None
                                else _env_float(
                                    "HOROVOD_CONTROLLER_CANARY_STEPS",
                                    DEFAULT_CANARY_STEPS))
        self.tolerance = float(tolerance if tolerance is not None
                               else DEFAULT_TOLERANCE)
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else _env_float(
                                    "HOROVOD_CONTROLLER_COOLDOWN_S",
                                    DEFAULT_COOLDOWN_S))
        self.values: dict[str, Any] = {}
        self.baseline: Optional[float] = None
        # Short trailing window of raw observations: mitigation proposals
        # are judged against its MINIMUM (see propose) — per-tick goodput
        # is bursty, so any single tick is too noisy a reference.
        self._recent: deque = deque(maxlen=max(self.canary_steps, 3))
        self.pending: Optional[Proposal] = None
        self.history: list[dict] = []      # decided proposals, oldest first
        self._last_decision_t = -1e18
        if reg is None:
            from ..metrics import registry as _registry

            reg = _registry()
        self._c = {a: reg.counter(
            "horovod_controller_decisions_total",
            help="runtime-controller decisions by action "
                 "(control/core.py propose -> canary -> commit/rollback)",
            action=a, plane=plane)
            for a in ("propose", "commit", "rollback")}

    # -- current state -------------------------------------------------------

    def set_current(self, name: str, value: Any) -> None:
        """Record a knob's launch value (no canary — this is where the job
        already is)."""
        if name not in self.knobs:
            raise KeyError(f"unknown knob {name!r}")
        self.values[name] = self.knobs[name].clamp(value)

    @property
    def in_canary(self) -> bool:
        return self.pending is not None

    def cooldown_remaining(self, now: Optional[float] = None) -> float:
        now = now if now is not None else time.monotonic()
        return max(0.0, self.cooldown_s - (now - self._last_decision_t))

    # -- the state machine ---------------------------------------------------

    def propose(self, name: str, value: Any, reason: str,
                now: Optional[float] = None,
                mitigation: bool = False) -> bool:
        """Try to start a canary for ``name`` -> ``value``. Refused (False)
        while another change is canarying, during the post-decision
        cooldown, out of bounds, or when the value is already current.

        ``mitigation`` changes what the canary is judged against: a TUNING
        proposal (default) must hold the healthy EWMA baseline, but a
        mitigation — proposed BECAUSE throughput already collapsed — is
        judged against the collapsed level itself (the WORST of the recent
        observation window: single ticks are too bursty to reference),
        i.e. "keep it unless it makes things worse than the collapse
        already did". Judging a mitigation against the pre-fault baseline
        would roll back every useful move until the EWMA eroded all the
        way down to the outage floor — by which time the anomaly stream
        has adapted and stopped firing."""
        now = now if now is not None else time.monotonic()
        knob = self.knobs.get(name)
        if knob is None or self.pending is not None:
            return False
        if self.cooldown_remaining(now) > 0:
            return False
        value = knob.clamp(value)
        if not knob.in_bounds(value) or value == self.values.get(name):
            return False
        prev = self.values.get(name)
        try:
            self._apply(name, value)
        except Exception as e:  # noqa: BLE001 - a vetoed apply is a no-op
            log("warning",
                f"controller[{self.plane}]: apply {name}={value!r} "
                f"vetoed: {e}")
            return False
        self.values[name] = value
        ref = (min(self._recent) if mitigation and self._recent
               else self.baseline)
        self.pending = Proposal(knob=name, value=value, prev=prev,
                                reason=reason, baseline=ref or 0.0,
                                mitigation=mitigation)
        self._c["propose"].inc()
        self._event("propose", knob=name, value=value, prev=prev,
                    reason=reason, baseline=self.baseline)
        log("info",
            f"controller[{self.plane}]: propose {name}: {prev!r} -> "
            f"{value!r} ({reason}); canary {self.canary_steps} obs vs "
            f"baseline {self.baseline}")
        return True

    def observe(self, score: float,
                now: Optional[float] = None) -> Optional[str]:
        """Feed one throughput/goodput observation (higher is better).
        Returns "commit"/"rollback" at a canary verdict, else None."""
        now = now if now is not None else time.monotonic()
        score = float(score)
        self._recent.append(score)
        if self.pending is None:
            self.baseline = score if self.baseline is None else \
                (1 - _EWMA_ALPHA) * self.baseline + _EWMA_ALPHA * score
            return None
        p = self.pending
        p.scores.append(score)
        if len(p.scores) < self.canary_steps:
            return None
        mean = sum(p.scores) / len(p.scores)
        ok = p.baseline <= 0 or mean >= p.baseline * (1 - self.tolerance)
        if ok:
            p.verdict = "commit"
            # The canary window IS the new baseline evidence.
            self.baseline = mean
        else:
            p.verdict = "rollback"
            try:
                self._apply(p.knob, p.prev)
                self.values[p.knob] = p.prev
            except Exception as e:  # noqa: BLE001
                log("warning",
                    f"controller[{self.plane}]: rollback of {p.knob} "
                    f"failed: {e} — keeping {p.value!r}")
                p.verdict = "rollback-failed"
        self.pending = None
        self._last_decision_t = now
        decided = {"knob": p.knob, "value": p.value, "prev": p.prev,
                   "reason": p.reason, "verdict": p.verdict,
                   "baseline": round(p.baseline, 4),
                   "canary_mean": round(mean, 4),
                   "mitigation": p.mitigation,
                   "time_unix_s": round(time.time(), 3)}
        self.history.append(decided)
        action = "commit" if p.verdict == "commit" else "rollback"
        self._c[action].inc()
        self._event(action, **decided)
        log("info",
            f"controller[{self.plane}]: {p.verdict} {p.knob}={p.value!r} "
            f"(canary mean {mean:.4g} vs baseline {p.baseline:.4g})")
        return action

    # -- telemetry -----------------------------------------------------------

    def _event(self, action: str, **attrs) -> None:
        """Flight-ring event + point span: the debug bundle's view of this
        decision. Best-effort — telemetry never blocks the loop."""
        try:
            from ..tracing import flight as _flight

            _flight.get_flight().event(
                "controller", action=action, plane=self.plane,
                **{k: (v if isinstance(v, (int, float, str, bool,
                                           type(None))) else str(v))
                   for k, v in attrs.items()})
        except Exception:  # noqa: BLE001
            pass
        try:
            from ..tracing import get_recorder

            rec = get_recorder()
            if rec is not None:
                rec.point(f"controller.{self.plane}", str(attrs.get(
                    "knob", "-")), "controller", action,
                    plane=self.plane)
        except Exception:  # noqa: BLE001
            pass
