"""Pod-scale telemetry tree: the port's own copy of
``horovod_tpu.telemetry``.

Pod metrics snapshots, trace-span collection, flight-ring sweeps, clock
probes and stall reports would otherwise fan in O(world) through the
driver's single socket loop. This package restructures them as a
two-level tree (local collection daemons + aggregation before the slow
tier):

- :mod:`tree`  — the plan: which rank leads each host (the lowest rank on
  the host) and the collection interval knob.
- :mod:`agent` — :class:`~.agent.TelemetryAgent`, the per-host leader
  service (hosted by the runner HostAgent process): ranks push
  metrics-snapshot DELTAS to it, it answers their clock probes locally
  with composed offsets, batches their watchdog/anomaly events, and
  serves pull-based ``sweep`` endpoints for flight rings and trace spans.
  :class:`~.agent.RankTelemetryClient` is the rank side.
- :mod:`root`  — :class:`~.root.RootAggregator`, the driver side: ingests
  per-host partials (associative merge, metrics/aggregate.py), tracks
  per-host staleness (feeding the ``telemetry_lag`` anomaly), and exposes
  the pod view.

Root connections and control bytes per collection tick are O(hosts), not
O(world); the host-then-root merge is bitwise-identical to the flat merge
by construction (exact rational sums, rounded once at finalize).
"""

from __future__ import annotations

from .agent import RankTelemetryClient, TelemetryAgent  # noqa: F401
from .root import RootAggregator  # noqa: F401
from .tree import TreePlan, interval_s_from_env, plan_tree  # noqa: F401
