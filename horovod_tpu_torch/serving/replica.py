"""Replica worker process — one model server behind the router.

Spawned by :class:`~horovod_tpu_torch.serving.manager.ReplicaManager` as
``python -m horovod_tpu_torch.serving.replica`` with its contract in env
vars (HVD_SERVE_REPLICA_ID / _SECRET / _READY_FILE / _CHECKPOINT /
_BUILDER / _DECODE_STEPS / _DEVICE): the port's counterpart of
``horovod_tpu.serving.replica``. Startup: take the device the router gave
it (``cuda:<i>``, or ``cpu`` where the caller asked for the CPU; a replica
told to use a card it does not have raises), restore the serving
checkpoint (:func:`~.model.load_for_serving` — raw training checkpoints
are refused here, at replica boot, with the error forwarded to the
router's log), build the model on the device and its K-step decode
function (:class:`~.model.DecodeFn`: one CUDA graph per bucket shape on
the card), bind an authenticated
:class:`~horovod_tpu_torch.runner.network.BasicService` on a free
localhost port, and publish ``{"port", "pid"}`` through the ready file
(atomic rename — the manager never reads a torn write).

The service answers ``infer`` requests with the forward pass over the
padded bucket batch: the batch goes to the card here and the outputs come
back as host numpy. ``recompiles`` in every response counts the decode
function's captures (one per bucket shape; on the CPU, one per new
shape): the router mirrors the delta into
``horovod_serve_recompiles_total`` — bounded by buckets × example shapes
by construction.

Chaos hooks ride the elastic fault machinery for free: the manager sets
``HOROVOD_TASK_INDEX`` to the replica id, so
``HOROVOD_FAULT_INJECT_STEP=N`` + ``HOROVOD_FAULT_INJECT_INDEX=i`` kills
replica ``i`` at its N-th infer request (``elastic/fault.py`` semantics,
request count standing in for the training step) — the smoke's
kill-mid-load leg and the retry/respawn tests drive exactly this.

A parent-death watchdog exits the replica when the router process dies:
an orphaned replica must never hold a port (same posture as task_main's
worker watchdog).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback

import numpy as np
import torch

from ..elastic import fault
from ..runner.network import BasicService
from ..tracing.serve import get_serve_tracer, init_serve_tracer
from ..utils.logging import log
from .model import bind_device


class ReplicaService(BasicService):
    """Authenticated request server for ONE router connection. The router
    opens a single channel per replica (its worker thread), so requests
    are naturally serialized — no device-side locking needed."""

    def __init__(self, key: bytes, forward, replica_id: int,
                 host: str = "127.0.0.1", device=None) -> None:
        self._forward = forward
        self.replica_id = replica_id
        self.device = torch.device(device if device is not None else "cpu")
        self.numerics: dict = {}  # set by main() (model.exact_float32)
        self._requests = 0
        super().__init__(key, host=host, port=0)

    def handle(self, request, client_addr):
        kind = request.get("kind")
        bind_device(self.device)
        if kind == "ping":
            return {"ok": True, "replica": self.replica_id}
        if kind == "stats":
            return {"ok": True, "replica": self.replica_id,
                    "requests": self._requests,
                    "recompiles": self._forward.compiles,
                    "device": str(self.device), "numerics": self.numerics}
        if kind == "clock_align":
            tracer = get_serve_tracer()
            if tracer is not None:
                tracer.set_clock_offset(int(request["offset_ns"]))
            return {"ok": True}
        if kind != "infer":
            return {"ok": False, "error": f"unknown kind {kind!r}"}
        self._requests += 1
        # Chaos hook: replica `HOROVOD_FAULT_INJECT_INDEX` dies at its
        # N-th request — models a replica crashing mid-batch; the router
        # must retry the in-flight requests on survivors.
        fault.maybe_die(self._requests)
        try:
            x = np.asarray(request["inputs"])
            tracer = get_serve_tracer()
            t0 = tracer.now_ns() if tracer else 0
            y = self._forward(x).detach().cpu().numpy()
            if tracer and request.get("trace"):
                tracer.span(request["trace"], "infer", t0, tracer.now_ns(),
                            side="replica", n_valid=request.get("n_valid"))
            return {"ok": True, "outputs": y,
                    "recompiles": self._forward.compiles,
                    "requests": self._requests}
        except Exception:  # noqa: BLE001 - forwarded to the router verbatim
            return {"ok": False, "error": traceback.format_exc(limit=20)}


def _watch_parent(ppid: int) -> None:
    while True:
        time.sleep(0.5)
        if os.getppid() != ppid:
            log("warning", "serving replica: router process died; exiting")
            os._exit(0)


def main() -> int:
    replica_id = int(os.environ["HVD_SERVE_REPLICA_ID"])
    secret = bytes.fromhex(os.environ["HVD_SERVE_SECRET"])
    ready_file = os.environ["HVD_SERVE_READY_FILE"]
    ckpt = os.environ.get("HVD_SERVE_CHECKPOINT", "")
    builder_spec = os.environ.get(
        "HVD_SERVE_BUILDER", "horovod_tpu_torch.serving.model:mlp_builder")
    decode_steps = int(os.environ.get("HVD_SERVE_DECODE_STEPS", "") or 1)

    from ..common.basics import resolve_device
    from .model import (
        exact_float32,
        load_for_serving,
        make_decode_fn,
        resolve_builder,
    )

    # No card where one was asked for raises here, before any model code.
    device = resolve_device(os.environ.get("HVD_SERVE_DEVICE") or None)
    numerics = exact_float32(device)
    bind_device(device)
    builder = resolve_builder(builder_spec)
    state = load_for_serving(ckpt) if ckpt else None
    forward = make_decode_fn(builder(state, device=device), decode_steps,
                             device)

    init_serve_tracer(f"serve-replica-{replica_id}")
    svc = ReplicaService(secret, forward, replica_id, device=device)
    svc.numerics = numerics
    ppid = os.getppid()
    threading.Thread(target=_watch_parent, args=(ppid,), daemon=True).start()

    tmp = ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"port": svc.port, "pid": os.getpid()}, f)
    os.rename(tmp, ready_file)
    log("info", f"serving replica {replica_id} ready on port {svc.port} "
        f"(decode_steps={decode_steps}, device={device})")

    # Serve until the router kills us or the parent dies; the service's
    # accept loop runs on daemon threads, so just park here.
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    sys.exit(main())
