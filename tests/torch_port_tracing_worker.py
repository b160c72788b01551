"""One rank of the tracing worlds that tests/test_torch_port_tracing.py
(gloo, on the CPU) and tests/test_torch_port_cuda.py (``-k tracing_world``,
NCCL, one process per GPU) launch. It imports no JAX. Identity and
rendezvous come from the launcher's ``HOROVOD_*`` variables;
``TRACING_MODE`` picks the world and ``TRACING_OUT`` is where rank r
writes ``<TRACING_OUT>.<r>.json``.

``world``: the TransformerLM of ``TRACING_CFG`` (a JSON ``TrainConfig``)
through a flat ``DistributedOptimizer`` (``HOROVOD_NUM_BUCKETS`` buckets),
``TRACING_STEPS`` eager steps, run twice from the same weights and
batches: untraced, then, in a new world, with ``HOROVOD_TRACE_DIR`` set to
``TRACING_TRACE_DIR`` (rendezvous at ``TRACING_COORD_ADDR2``), where rank
``TRACING_SLEEP_RANK`` sleeps
``TRACING_SLEEP_S`` seconds on the host before step 3's backward. No
other collective runs in the traced world (the ranks draw the same
weights from the seed and keep their losses to themselves), so its trace
holds the exchange alone. Each rank writes both runs' losses, whether
every parameter is bit-equal between them, and, per traced step, the
host window of the step (``monotonic_ns`` before its forward and after a
``synchronize`` at its end) and the device time at which its backward's
kernels ended (an event after ``backward()``, mapped onto the host clock
as the port's telemetry maps its events). ``HOROVOD_LATENCY_HIDING=1``
starts the buckets from the gradient hooks.

``stall`` (2 ranks, CPU): rank 1 skips the second of two allreduces and
waits on a key of the rendezvous store; rank 0's second allreduce should
raise ``HorovodInternalError`` once the stall watchdog aborts it past
``HOROVOD_STALL_SHUTDOWN_TIME``. Rank 0 writes the seconds its call took,
the error, the stall report and the watchdog's counters, then sets the
key and waits for rank 1's answer on another. Both ranks leave with ``os._exit`` (a gloo world with a collective
that never completes cannot be torn down cleanly).
"""

import dataclasses
import json
import os
import sys
import time
from datetime import timedelta

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import train as train_mod  # noqa: E402
from horovod_tpu_torch.common import basics  # noqa: E402
from horovod_tpu_torch.convert import jax_ordered  # noqa: E402
from horovod_tpu_torch.metrics import registry  # noqa: E402


def _anchor(device):
    """(event, host ns) as ``parallel/telemetry.py`` takes its anchors."""
    side = torch.cuda.Stream(device)
    ev = torch.cuda.Event(enable_timing=True)
    t0 = time.monotonic_ns()
    ev.record(side)
    ev.synchronize()
    return ev, (t0 + time.monotonic_ns()) // 2


def _run(device: str, cfg, steps: int, sleep_rank: int, sleep_s: float,
         trace_dir: str) -> dict:
    if trace_dir:
        os.environ["HOROVOD_TRACE_DIR"] = trace_dir
    else:
        os.environ.pop("HOROVOD_TRACE_DIR", None)
    hvd.init(device)
    dev = hvd.device()
    model = train_mod.build_model(cfg, dev)
    opt = hvd.DistributedOptimizer(train_mod.adam(model.parameters(), cfg),
                                   jax_ordered(model.named_parameters()))
    cuda = dev.type == "cuda"
    losses, windows = [], []
    for i in range(steps):
        tokens = train_mod.make_batch(dataclasses.replace(cfg, seed=cfg.seed + i),
                                      hvd.rank(), dev)
        anchor = _anchor(dev) if cuda and trace_dir else None
        t0 = time.monotonic_ns()
        opt.zero_grad()
        loss = train_mod.token_loss(model(tokens), train_mod.next_tokens(tokens))
        if trace_dir and i == 2 and hvd.rank() == sleep_rank:
            time.sleep(sleep_s)
        loss.backward()
        bwd = None
        if anchor is not None:
            bwd = torch.cuda.Event(enable_timing=True)
            bwd.record()
        opt.step()
        losses.append(float(loss.item()))
        if cuda:
            torch.cuda.synchronize(dev)
        t1 = time.monotonic_ns()
        window = {"t0": t0, "t1": t1}
        if bwd is not None:
            window["backward_end"] = anchor[1] + int(round(
                anchor[0].elapsed_time(bwd) * 1e6))
        windows.append(window)
    params = [p.detach().cpu().clone() for p in model.parameters()]
    buckets = opt.plan.num_buckets
    _leave()
    return {"losses": losses, "windows": windows, "params": params,
            "buckets": buckets}


def _leave() -> None:
    """Every rank leaves the world once all have finished its collectives
    (a key per rank on the rendezvous store, no collective of its own): a
    rank that tore its sockets down while a peer still read from them
    would cut the peer's last collective short."""
    store = basics.store()
    store.set(f"leave.{hvd.rank()}", "1")
    store.wait([f"leave.{r}" for r in range(hvd.size())], timedelta(seconds=120))
    hvd.shutdown()


def world() -> dict:
    device = os.environ.get("TRACING_DEVICE", "cpu")
    cfg = train_mod.TrainConfig(**json.loads(os.environ["TRACING_CFG"]))
    steps = int(os.environ["TRACING_STEPS"])
    sleep_rank = int(os.environ["TRACING_SLEEP_RANK"])
    sleep_s = float(os.environ["TRACING_SLEEP_S"])
    plain = _run(device, cfg, steps, sleep_rank, sleep_s, "")
    # The traced world rendezvous at another address: the first world's
    # store may still be closing at the first.
    os.environ["HOROVOD_COORD_ADDR"] = os.environ["TRACING_COORD_ADDR2"]
    traced = _run(device, cfg, steps, sleep_rank, sleep_s,
                  os.environ["TRACING_TRACE_DIR"])
    return {"rank": int(os.environ["HOROVOD_RANK"]),
            "buckets": traced["buckets"],
            "plain_losses": plain["losses"], "traced_losses": traced["losses"],
            "bit_equal": all(torch.equal(a, b) for a, b in
                             zip(plain["params"], traced["params"])),
            "windows": traced["windows"]}


def stall() -> dict:
    hvd.init("cpu")
    store = basics.store()
    one = torch.ones(4)
    hvd.allreduce(one)
    out = {"rank": hvd.rank()}
    if hvd.rank() == 1:
        store.wait(["stall.done"], timedelta(seconds=120))
        store.set("stall.ack", "1")
        return out
    t0 = time.monotonic()
    try:
        hvd.allreduce(one)
        out["error"] = None
    except hvd.HorovodInternalError as e:
        out["error"] = str(e)
    out["seconds"] = time.monotonic() - t0
    out["report"] = registry().get_info("stall_report")
    snap = registry().snapshot()["counters"]
    out["warnings"] = snap.get("horovod_stall_warnings_total", 0)
    out["aborts"] = snap.get("horovod_stall_aborts_total", 0)
    out["errors"] = snap.get('horovod_collective_errors_total{op="allreduce"}', 0)
    store.set("stall.done", "1")
    # Rank 0 holds the store: it leaves once rank 1 has read the key.
    store.wait(["stall.ack"], timedelta(seconds=120))
    return out


def main() -> None:
    mode = os.environ["TRACING_MODE"]
    out = world() if mode == "world" else stall()
    rank = os.environ["HOROVOD_RANK"]
    with open(f"{os.environ['TRACING_OUT']}.{rank}.json", "w") as f:
        json.dump(out, f)
    sys.stdout.flush()
    sys.stderr.flush()
    if mode == "stall":
        os._exit(0)


if __name__ == "__main__":
    main()
