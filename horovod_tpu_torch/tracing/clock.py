"""NTP-style clock alignment for cross-rank trace merging: the port's own
copy of ``horovod_tpu.tracing.clock``, which the launcher's
``TaskAgent.estimate_clock_offset_ns`` uses.

Each rank's spans carry raw local CLOCK_MONOTONIC readings. Monotonic
clocks share an epoch on one host but are arbitrary across hosts, so the
collector needs each rank's offset to a common reference — the coordinator
(rank 0). The estimate is the classic NTP exchange over the existing
control channels (the eager coordinator's ``clock_probe`` request, or the
runner DriverService's — no new transport):

    t0 = local clock            # request sent
    ts = server clock           # server's reading, from the response
    t1 = local clock            # response received
    offset_sample = ts - (t0 + t1) / 2
    error bound   = (t1 - t0) / 2    (half the round-trip)

The sample taken on the round with the SMALLEST round-trip is kept — on a
quiet localhost control channel that bounds the error at tens of
microseconds, far below the millisecond-scale phases the critical-path
analyzer attributes.

At pod scale ranks do not probe the coordinator directly — O(world)
probes through one socket loop is exactly the fan-in the telemetry tree
removes. A rank probes its host's telemetry leader (one LAN/loopback hop,
tight RTT bound) and composes that estimate with the leader's own cached
estimate against the coordinator (``compose_offsets``): offsets add, error
bounds add. The composed bound stays small because each hop's bound is
half of that hop's best RTT, and both hops are short.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

DEFAULT_ROUNDS = 8


def estimate_offset_ns(probe: Callable[[], int],
                       rounds: int = DEFAULT_ROUNDS) -> Tuple[int, int]:
    """Estimate (offset_ns, error_bound_ns) of the server clock relative to
    the local monotonic clock: ``server_time ~= local_time + offset``.

    ``probe()`` performs one round trip and returns the server's
    ``monotonic_ns`` reading. Raises only if every round fails.
    """
    best_rtt = None
    best_offset = 0
    last_err = None
    for _ in range(max(1, int(rounds))):
        try:
            t0 = time.monotonic_ns()
            ts = int(probe())
            t1 = time.monotonic_ns()
        except Exception as e:  # noqa: BLE001 - a lost probe is not fatal
            last_err = e
            continue
        rtt = t1 - t0
        if best_rtt is None or rtt < best_rtt:
            best_rtt = rtt
            best_offset = ts - (t0 + t1) // 2
    if best_rtt is None:
        raise ConnectionError(f"clock probe failed every round: {last_err}")
    return int(best_offset), int(best_rtt // 2)


def compose_offsets(hop_a: Tuple[int, int],
                    hop_b: Tuple[int, int]) -> Tuple[int, int]:
    """Compose two NTP estimates along a path: if ``hop_a`` maps local time
    to an intermediary's clock and ``hop_b`` maps the intermediary's clock
    to the reference, the composition maps local time to the reference.

    Offsets add (``ref ~= mid + off_b ~= (local + off_a) + off_b``); error
    bounds add (worst case, both hops err the same way). Returns
    ``(offset_ns, error_bound_ns)`` like ``estimate_offset_ns``.
    """
    return (int(hop_a[0]) + int(hop_b[0]),
            int(hop_a[1]) + int(hop_b[1]))
