"""Control-tree shape and knobs: the port's own copy of
``horovod_tpu.ctrl.tree``.

The grouping itself is the telemetry tree's plan verbatim
(telemetry/tree.py plan_tree): ranks on one host are contiguous, the
lowest rank on each host leads it, and re-using the SAME plan means a
membership change moves the telemetry leader, the control leader, and
the hier data plane's host representative together.

What is new here is the *decision*: the control tree only pays for
itself when there are multiple hosts, and silently routing a
single-host or 2-rank job through an extra hop would be pure overhead
— so :func:`use_tree` falls back to the flat star LOUDLY (one warning
naming the reason) whenever no host grouping exists.
"""

from __future__ import annotations

import os

from ..utils.logging import log
from ..telemetry.tree import TreePlan, plan_tree  # noqa: F401  (re-export)

#: smallest world the tree is worth a hop for: at world <= 2 every
#: grouping is degenerate (one rank per host or one host total).
MIN_TREE_WORLD = 3


def tree_enabled() -> bool:
    """``HOROVOD_CTRL_TREE`` (default 1): route control traffic through
    per-host leaders when a host grouping exists. 0 forces the flat
    rank-to-root star everywhere."""
    return os.environ.get("HOROVOD_CTRL_TREE", "1") not in ("0", "false")


def ctrl_poll_s() -> float:
    """``HOROVOD_CTRL_POLL_S`` (seconds, default 1.0): how long a host
    leader's cached elastic-poll verdict stays fresh — every local rank
    polling within the window is answered from cache, so the root sees
    one poll per host per interval. Floored at 50 ms."""
    raw = os.environ.get("HOROVOD_CTRL_POLL_S", "")
    try:
        val = float(raw) if raw else 1.0
    except ValueError:
        val = 1.0
    return max(val, 0.05)


def ctrl_batch_s() -> float:
    """``HOROVOD_CTRL_BATCH_S`` (seconds, default 0.05): the leader's
    aggregation window — registrations and wait-assignment arrivals
    from local ranks within one window ride a single upstream request.
    Floored at 1 ms so a typo can't busy-spin the agent."""
    raw = os.environ.get("HOROVOD_CTRL_BATCH_S", "")
    try:
        val = float(raw) if raw else 0.05
    except ValueError:
        val = 0.05
    return max(val, 0.001)


def use_tree(num_hosts: int, world: int) -> bool:
    """The one gate every tree entry point shares: True when the control
    tree should carry this job's traffic. Falls back to flat LOUDLY —
    the operator reading logs must be able to tell which plane shape a
    job ran with, because the O(hosts) scaling claim only holds on the
    tree path."""
    if not tree_enabled():
        log("warning", "[ctrl] HOROVOD_CTRL_TREE=0: control tree disabled, "
            f"using flat rank-to-root control plane ({world} root "
            "connections)")
        return False
    if num_hosts <= 1:
        log("warning", "[ctrl] single-host job: no host grouping to fan "
            "control traffic through — using flat control plane")
        return False
    if world < MIN_TREE_WORLD:
        log("warning", f"[ctrl] world {world} <= 2: host grouping is "
            "degenerate — using flat control plane")
        return False
    return True
