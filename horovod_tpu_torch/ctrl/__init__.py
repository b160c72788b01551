"""Pod-scale control tree: the port's own copy of ``horovod_tpu.ctrl``.

Rank 0's control plane — rendezvous registration, elastic polls, clock
probes — is a star: every rank holds a socket to the root, so root
connections and control bytes are O(world). This package fans that
traffic through per-host leaders, the same shape the telemetry tree gives
the metrics plane:

- :mod:`~.tree` — the host-grouping plan and the knobs
  (``HOROVOD_CTRL_TREE``, batching/poll intervals), with a LOUD flat
  fallback when no host grouping exists.
- :mod:`~.agent` — :class:`ControlAgent`, the per-host runner-plane
  leader: batches its ranks' register/wait/poll traffic into one upstream
  connection to the driver, passes everything else through verbatim, and
  serves checkpoint streaming to cold-starting joiners
  (ckpt_async/stream.py).

- :mod:`~.relay` — :class:`CoordRelay`, the per-host relay of the eager
  engine's coordinator wire (``common/engine.py``): the host's ranks dial
  it (``HOROVOD_CTRL_RELAY``) and it coalesces their ticks into one
  upstream connection. ``ControlAgent.relay_port`` starts it.
"""

from .tree import (  # noqa: F401
    TreePlan,
    ctrl_batch_s,
    ctrl_poll_s,
    plan_tree,
    tree_enabled,
    use_tree,
)
