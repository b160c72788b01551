"""Serving-plane runtime controller: the port's own copy of
``horovod_tpu.control.serving``.

Same :class:`~horovod_tpu_torch.control.core.ControlLoop` skeleton as the
training side, different sensors and actuators:

- **sensors**: anomaly firings (``ttft_slo``, ``drain_collapse``,
  ``shed_spike``, ``preempt_storm``) via ``AnomalyDetector.subscribe``,
  and goodput — served requests + decoded tokens per tick, read as
  counter deltas from the registry;
- **actuators**: the live-read :class:`~horovod_tpu_torch.serving.config
  .ServeConfig` fields (``max_batch``, ``max_wait_ms``, ``queue_cap``,
  ``target_queue`` — the batcher and autoscaler re-read them every
  cycle, so a mutation IS the switch) and, when an admission controller
  is attached, its SLO budget through ``set_slo_ms``.

Every anomaly kind maps to an ordered list of (knob, direction) moves —
the rule table below. On a firing the controller proposes the FIRST move
that is still inside bounds; the canary machinery then watches goodput
for K ticks and rolls the change back if goodput regressed. One change
in flight at a time, cooldown between decisions — a storm of firings
produces a sequence of canaried single-knob steps, not a lurch.

``maybe_start_serving_controller`` is the router hook: it returns a
started controller when ``HOROVOD_CONTROLLER`` is set (and an anomaly
detector exists to subscribe to), else None. Off by default.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .core import ControlLoop, Knob
from .training import controller_enabled
from ..utils.logging import log

#: anomaly kind -> ordered (knob, direction) moves; the first in-bounds
#: move is proposed. Directions follow each rule's physics:
#:   ttft_slo       — latency over budget: stop waiting to fill batches,
#:                    then shrink them (smaller batches finish sooner);
#:   drain_collapse — throughput collapsed under queued demand: scale out
#:                    sooner (lower target_queue) and push batch size up
#:                    (more work drained per cycle);
#:   shed_spike     — 429s spiking: scale out sooner, then absorb the
#:                    burst with a deeper queue;
#:   preempt_storm  — KV watermark thrash: admit less work per cycle.
RULES: dict[str, list[tuple[str, int]]] = {
    "ttft_slo": [("max_wait_ms", -1), ("max_batch", -1)],
    "drain_collapse": [("target_queue", -1), ("max_batch", +1)],
    "shed_spike": [("target_queue", -1), ("queue_cap", +1)],
    "preempt_storm": [("max_batch", -1)],
}

#: goodput tick period (seconds) for the observation thread
#: (HOROVOD_CONTROLLER_TICK_S; the chaos smoke shrinks it so the
#: propose->canary->commit cycle fits a CI wall-clock budget).
TICK_S = 1.0


def _tick_s() -> float:
    return float(os.environ.get("HOROVOD_CONTROLLER_TICK_S", "") or TICK_S)


def _serving_knobs(cfg) -> dict[str, Knob]:
    """Bounds derived from the launch config: the controller may move each
    knob a few binary steps around where the operator put it, never to
    a degenerate value."""
    return {
        "max_batch": Knob("max_batch", "int",
                          lo=1, hi=max(4 * cfg.max_batch, 8)),
        "max_wait_ms": Knob("max_wait_ms", "float",
                            lo=0.25, hi=max(4 * cfg.max_wait_ms, 20.0)),
        "queue_cap": Knob("queue_cap", "int",
                          lo=max(cfg.queue_cap // 4, 8),
                          hi=8 * cfg.queue_cap),
        "target_queue": Knob("target_queue", "float",
                             lo=1.0, hi=max(4 * cfg.target_queue, 8.0)),
        "slo_ms": Knob("slo_ms", "float",
                       lo=cfg.slo_ms / 4.0, hi=4.0 * cfg.slo_ms),
    }


class ServingController:
    """Drives a live :class:`ServeConfig` from the anomaly stream.

    The config object is SHARED with the batcher/manager/admission — the
    apply callback mutates it in place, which is exactly how operators
    already hot-reload it; the controller adds bounds, canary and
    rollback on top.
    """

    def __init__(self, cfg, admission=None, anomaly=None,
                 reg=None,
                 canary_steps: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 tolerance: Optional[float] = None,
                 tick_s: Optional[float] = None) -> None:
        self.cfg = cfg
        self.admission = admission
        if reg is None:
            from ..metrics import registry as _registry

            reg = _registry()
        self.reg = reg
        self.tick_s = float(tick_s) if tick_s is not None else _tick_s()
        self.loop = ControlLoop(_serving_knobs(cfg), self._apply,
                                plane="serving",
                                canary_steps=canary_steps,
                                cooldown_s=cooldown_s,
                                tolerance=tolerance, reg=reg)
        for name in ("max_batch", "max_wait_ms", "queue_cap",
                     "target_queue", "slo_ms"):
            self.loop.set_current(name, getattr(cfg, name))
        self._pending_kinds: list[str] = []
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._anomaly = anomaly
        if anomaly is not None:
            anomaly.subscribe(self.on_anomaly)

    # -- actuation -----------------------------------------------------------

    def _apply(self, name: str, value) -> None:
        setattr(self.cfg, name, value)
        if name == "slo_ms" and self.admission is not None:
            set_slo = getattr(self.admission, "set_slo_ms", None)
            if set_slo is not None:
                set_slo(value)

    # -- sensors -------------------------------------------------------------

    def on_anomaly(self, kind: str, detail: dict) -> None:
        """Anomaly subscription callback (runs on the detector thread):
        queue the kind; the controller's own tick turns it into at most
        one proposal."""
        if kind in RULES:
            with self._lock:
                self._pending_kinds.append(kind)

    def _goodput(self, counters: dict) -> float:
        """Requests + tokens drained since the previous tick."""
        total = 0.0
        for name in ("horovod_serve_requests_total",
                     "horovod_serve_llm_tokens_total"):
            cur = 0.0
            for key, v in counters.items():
                if key == name or key.startswith(name + "{"):
                    cur += float(v)
            prev = self._last.get(name, cur)
            self._last[name] = cur
            total += max(cur - prev, 0.0)
        return total

    # -- the loop ------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One observation + rule pass (the thread calls this every
        ``tick_s``; tests call it by hand)."""
        counters = self.reg.snapshot().get("counters", {})
        verdict = self.loop.observe(self._goodput(counters), now=now)
        if self.loop.in_canary:
            return verdict
        with self._lock:
            kinds, self._pending_kinds = self._pending_kinds, []
        for kind in kinds:
            if self._propose_for(kind, now=now):
                break
        return verdict

    def _propose_for(self, kind: str,
                     now: Optional[float] = None) -> bool:
        """Propose the first in-bounds move of ``kind``'s rule row."""
        for name, direction in RULES.get(kind, ()):
            knob = self.loop.knobs[name]
            nxt = knob.step(self.loop.values[name], direction)
            if nxt is None:
                continue
            # Every serving proposal is firing-driven — goodput already
            # collapsed/breached when the rule ran — so the canary is
            # judged against the collapsed level (mitigation semantics),
            # not the pre-fault EWMA it cannot possibly reach yet.
            if self.loop.propose(name, nxt, f"anomaly {kind}", now=now,
                                 mitigation=True):
                return True
        return False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingController":
        self._thread = threading.Thread(target=self._run,
                                        name="hvd_controller",
                                        daemon=True)
        self._thread.start()
        log("info", "serving controller started "
                    f"(tick {self.tick_s}s, canary "
                    f"{self.loop.canary_steps} ticks)")
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:   # control must never take the router down
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._anomaly is not None:
            try:
                self._anomaly.unsubscribe(self.on_anomaly)
            except Exception:  # noqa: BLE001
                pass

    def report(self) -> dict:
        return {
            "values": dict(self.loop.values),
            "baseline": self.loop.baseline,
            "decisions": list(self.loop.history),
        }


def maybe_start_serving_controller(cfg, admission=None, anomaly=None,
                                   reg=None) -> Optional[
        ServingController]:
    """Router hook: a started controller when ``HOROVOD_CONTROLLER`` is
    set and there is an anomaly stream to subscribe to, else None."""
    if not controller_enabled() or anomaly is None:
        return None
    return ServingController(cfg, admission=admission, anomaly=anomaly,
                             reg=reg).start()


__all__ = ["ServingController", "RULES", "maybe_start_serving_controller"]
