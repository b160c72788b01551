"""The telemetry tree's shape: leaders, members, and the collection tick
(the port's own copy of ``horovod_tpu.telemetry.tree``).

Leader election mirrors the hier data plane (parallel/hier and the
runner's barrel-shift rank assignment): ranks on one host are contiguous,
and the LOWEST rank on each host — local_rank 0 — leads it. Electing the
same rank both planes already treat as the host representative means the
telemetry agent rides the process that is already the host's cross-plane
endpoint, and a membership change moves both roles together.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Sequence, Union

#: seconds between collection ticks at every hop (rank→leader push,
#: leader→root push, root staleness accounting). One knob on purpose:
#: the ``telemetry_lag`` anomaly judges "host snapshot older than
#: TELEMETRY_LAG_TICKS collection intervals", which only means something
#: when every hop agrees what an interval is.
DEFAULT_INTERVAL_S = 1.0


def interval_s_from_env() -> float:
    """The collection interval: ``HOROVOD_TELEMETRY_INTERVAL_S`` (seconds,
    default 1.0, floored at 50 ms so a typo can't busy-spin the agents)."""
    raw = os.environ.get("HOROVOD_TELEMETRY_INTERVAL_S", "")
    try:
        val = float(raw) if raw else DEFAULT_INTERVAL_S
    except ValueError:
        val = DEFAULT_INTERVAL_S
    return max(val, 0.05)


@dataclass(frozen=True)
class TreePlan:
    """Which rank leads each host. ``hosts`` is sorted (the same order the
    driver's rank assignment sorts by host hash)."""

    hosts: tuple
    ranks_of: dict      # host -> tuple of member ranks, ascending
    leader_of: dict     # host -> leader rank (min member rank)

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    def host_of(self, rank: int) -> str:
        for host, ranks in self.ranks_of.items():
            if rank in ranks:
                return host
        raise KeyError(f"rank {rank} is not in the tree plan")

    def leader_for(self, rank: int) -> int:
        return self.leader_of[self.host_of(rank)]

    def is_leader(self, rank: int) -> bool:
        return rank in self.leader_of.values()


def plan_tree(host_of_rank: Union[Mapping[int, str], Sequence[str]]
              ) -> TreePlan:
    """Build the plan from rank→host (a dict, or a list indexed by rank —
    the shape ``DriverService._topology`` and the smokes already carry)."""
    if not isinstance(host_of_rank, Mapping):
        host_of_rank = dict(enumerate(host_of_rank))
    by_host: dict = {}
    for rank in sorted(host_of_rank):
        by_host.setdefault(str(host_of_rank[rank]), []).append(int(rank))
    hosts = tuple(sorted(by_host))
    ranks_of = {h: tuple(by_host[h]) for h in hosts}
    leader_of = {h: min(by_host[h]) for h in hosts}
    return TreePlan(hosts=hosts, ranks_of=ranks_of, leader_of=leader_of)
