"""SLO-aware admission control — shed load *before* it queues (the port's
own copy of ``horovod_tpu.serving.admission``).

Clipper-style (Crankshaw et al., NSDI 2017) queue-depth/latency admission:
every request carries a deadline (client-supplied ``deadline_ms`` or the
``HOROVOD_SERVE_SLO_MS`` default), and the controller keeps a live
estimate of the fleet's drain rate (EWMA of requests retired per second
per replica, fed by every completed batch). A request is admitted only
when the *projected* queue wait — current depth over the fleet's drain
rate — still fits inside the SLO; otherwise it is shed with 429
(``horovod_serve_shed_total``), which keeps the p99 of admitted requests
bounded instead of letting the whole queue miss its deadlines together.

Cold start admits everything: until the first batch completes there is no
rate estimate, projected wait reads 0, and nothing sheds — the queue-cap
backstop (batcher) still bounds memory.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

from ..metrics import registry as _registry

_EWMA_ALPHA = 0.2


class AdmissionController:
    def __init__(self, cfg, reg=None):
        self.cfg = cfg
        self.slo_s = cfg.slo_ms / 1000.0
        reg = reg or _registry()
        self._lock = threading.Lock()
        self._drain_rate: Optional[float] = None   # req/s per replica
        self._shed_c = reg.counter(
            "horovod_serve_shed_total",
            help="requests shed (429) because the projected queue wait "
                 "exceeded the SLO")
        self._shed_429 = reg.counter(
            "horovod_serve_requests_total",
            help="terminal request outcomes by HTTP-style code", code="429")
        self._wait_gauge = reg.gauge(
            "horovod_serve_projected_wait_seconds",
            help="projected queue wait at the last admission decision")

    # -- feedback from completed batches -------------------------------------

    def observe_batch(self, n_requests: int, service_s: float) -> None:
        """A replica retired ``n_requests`` in ``service_s`` seconds —
        fold into the per-replica drain-rate EWMA."""
        if n_requests <= 0 or service_s <= 0:
            return
        rate = n_requests / service_s
        with self._lock:
            self._drain_rate = rate if self._drain_rate is None else \
                (1 - _EWMA_ALPHA) * self._drain_rate + _EWMA_ALPHA * rate

    def drain_rate(self) -> Optional[float]:
        with self._lock:
            return self._drain_rate

    def set_slo_ms(self, slo_ms: float) -> None:
        """Live SLO-budget retune (control/serving.py): the cached budget
        is updated together with the config the report reads."""
        self.cfg.slo_ms = float(slo_ms)
        self.slo_s = float(slo_ms) / 1000.0

    # -- the admission decision ----------------------------------------------

    def projected_wait_s(self, queue_depth: int, replicas: int) -> float:
        """Expected time a request arriving NOW spends queued: everything
        ahead of it drained by ``replicas`` workers at the observed
        per-replica rate. 0 until the first observation."""
        with self._lock:
            rate = self._drain_rate
        if rate is None or rate <= 0:
            return 0.0
        return queue_depth / (rate * max(replicas, 1))

    def admit(self, queue_depth: int, replicas: int,
              budget_s: Optional[float] = None) -> Tuple[bool, float]:
        """(admitted, projected_wait_s). ``budget_s`` is the request's own
        deadline budget (default: the SLO) — a request that provably
        cannot make its deadline is shed NOW, not failed after consuming a
        queue slot. Shedding fires only on a live estimate — a cold
        server never 429s its first requests."""
        wait = self.projected_wait_s(queue_depth, replicas)
        self._wait_gauge.set(wait)
        if wait > (budget_s if budget_s is not None else self.slo_s):
            self._shed_c.inc()
            self._shed_429.inc()
            return False, wait
        return True, wait

    def report(self) -> dict:
        with self._lock:
            rate = self._drain_rate
        return {"slo_ms": self.cfg.slo_ms,
                "drain_rate_per_replica": rate,
                "shed_total": self._shed_c.value}


class KVAdmission:
    """Projected-block-availability admission for the token-level plane:
    the currency switches from queue depth to KV blocks.

    A generate request needs ``blocks_for(prompt + max_tokens)`` blocks
    of decode-pool memory over its lifetime. The controller keeps an EWMA
    of the pool's block *release* rate (blocks freed by retiring
    sequences per second, fed from decode-replica stats deltas) and
    projects how long a request arriving NOW would wait for its blocks:
    everything already queued ahead of it plus its own demand, minus what
    is free above the watermark, drained at the observed release rate. A
    projected wait beyond the TTFT SLO budget sheds 429 — same
    Clipper-style math as :class:`AdmissionController`, denominated in
    memory instead of requests.

    Cold start admits everything (no release observed -> no estimate ->
    never shed), exactly like the request-rate controller.
    """

    def __init__(self, llm_cfg, reg=None):
        self.llm = llm_cfg
        self.ttft_budget_s = llm_cfg.ttft_slo_ms / 1000.0
        reg = reg or _registry()
        self._lock = threading.Lock()
        self._release_rate: Optional[float] = None   # blocks/s, pool-wide
        self._shed_c = reg.counter(
            "horovod_serve_shed_total",
            help="requests shed (429) because the projected queue wait "
                 "exceeded the SLO")
        self._shed_429 = reg.counter(
            "horovod_serve_requests_total",
            help="terminal request outcomes by HTTP-style code", code="429")
        self._wait_gauge = reg.gauge(
            "horovod_serve_projected_wait_seconds",
            help="projected queue wait at the last admission decision")

    def observe_release(self, n_blocks: int, dt_s: float) -> None:
        """Decode stats tick: ``n_blocks`` were freed by retirements over
        ``dt_s`` seconds. Zero-release ticks still decay the EWMA —
        a stalled pool must stop looking fast."""
        if dt_s <= 0 or n_blocks < 0:
            return
        rate = n_blocks / dt_s
        with self._lock:
            self._release_rate = rate if self._release_rate is None else \
                (1 - _EWMA_ALPHA) * self._release_rate + _EWMA_ALPHA * rate

    def release_rate(self) -> Optional[float]:
        with self._lock:
            return self._release_rate

    def set_slo_ms(self, ttft_slo_ms: float) -> None:
        """Live TTFT-budget retune (control/serving.py)."""
        self.llm.ttft_slo_ms = float(ttft_slo_ms)
        self.ttft_budget_s = float(ttft_slo_ms) / 1000.0

    def projected_wait_s(self, blocks_needed: int, free_blocks: int,
                         queued_blocks: int) -> float:
        """Seconds until ``blocks_needed`` become available above the
        watermark, with ``queued_blocks`` of earlier demand ahead. 0 when
        it fits now; +inf when blocked with a zero release estimate."""
        deficit = blocks_needed + queued_blocks \
            - max(free_blocks - (self.llm.num_blocks
                                 - self.llm.usable_blocks()), 0)
        if deficit <= 0:
            return 0.0
        with self._lock:
            rate = self._release_rate
        if rate is None:
            return 0.0          # cold start: no estimate, never shed
        if rate <= 0:
            return float("inf")
        return deficit / rate

    def refresh_projection(self, free_blocks: int,
                           queued_blocks: int) -> float:
        """Recompute the projected wait of the CURRENT backlog (a
        zero-block probe) and publish it — called on every decode stats
        tick so ``horovod_serve_projected_wait_seconds`` stays live even
        when no admission decision is running (parked clients). The
        anomaly detector's ``ttft_slo`` rule reads this gauge: a backlog
        that projects past the TTFT SLO is a breach whether or not a new
        request happens to arrive to observe it (metrics/anomaly.py)."""
        wait = self.projected_wait_s(0, free_blocks, queued_blocks)
        self._wait_gauge.set(wait)
        return wait

    def admit(self, blocks_needed: int, free_blocks: int,
              queued_blocks: int,
              budget_s: Optional[float] = None) -> Tuple[bool, float]:
        """(admitted, projected_wait_s); sheds 429 when the projected
        block wait exceeds the TTFT budget."""
        wait = self.projected_wait_s(blocks_needed, free_blocks,
                                     queued_blocks)
        self._wait_gauge.set(wait)
        if wait > (budget_s if budget_s is not None
                   else self.ttft_budget_s):
            self._shed_c.inc()
            self._shed_429.inc()
            return False, wait
        return True, wait

    def report(self) -> dict:
        with self._lock:
            rate = self._release_rate
        return {"ttft_slo_ms": self.llm.ttft_slo_ms,
                "block_release_rate": rate,
                "shed_total": self._shed_c.value}
