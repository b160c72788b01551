"""The graphed-against-eager run that the four-card worlds of
``tests/torch_port_sharded_worker.py`` and ``tests/torch_port_pp_worker.py``
share, on phase 13's rule of ``chip_smoke.py`` (its dispatches, its limit,
its readings and its collective counter, imported from there).

``graphed_run(build, graphed)`` runs ``dispatches`` dispatches of ``k``
steps of ``build()``'s step on its cache draws: replays of one captured
step, or as many eager calls. On the CPU the loop runs a dispatch eagerly
and captures nothing. ``hold_pair`` holds a graphed run to its eager one on
every rank and gathers the readings.
"""

import gc
import os
import statistics
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (GRAPH_DISPATCHES, GRAPH_K, GRAPH_LIMIT,  # noqa: E402
                        SHARD_COLLECTIVES, CountCollectives, graph_errors)
from horovod_tpu_torch.common import basics  # noqa: E402


def graphed_run(build, graphed: bool, names=SHARD_COLLECTIVES, k: int = GRAPH_K,
                dispatches: int = GRAPH_DISPATCHES) -> dict:
    """``build()`` returns ``(step, cache, optimizer, state, want)``:
    ``state()`` reads this rank's state onto the host after the run;
    ``want``, the collectives of ``names`` that one step issues. Returns
    the losses, the step ms (a dispatch's over ``k``), the peak GB, the
    state, ``want`` and the collectives counted at the capture and during
    the replays."""
    from horovod_tpu_torch.loop import make_scan_train_loop

    dev = basics.device()
    cuda = dev.type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    step, cache, opt, state, want = build()
    at_capture, at_replay = CountCollectives(dist, names), CountCollectives(dist, names)
    losses, ms = [], []

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if graphed:
        loop = make_scan_train_loop(step, cache, k, optimizer=opt)
        if cuda:
            loop.warm_up()
            with at_capture:
                loop.capture()
        with at_replay:
            for _ in range(dispatches):
                sync()
                t0 = time.perf_counter()
                loop()
                losses += loop.losses.tolist()
                ms.append(1e3 * (time.perf_counter() - t0) / k)
        del loop
    else:
        ctr = cache.counter()
        for _ in range(k * dispatches):
            sync()
            t0 = time.perf_counter()
            x, y, ctr = cache.sample(ctr)
            losses.append(step(x, y).item())
            ms.append(1e3 * (time.perf_counter() - t0))
    return {"losses": losses, "ms": ms, "state": state(), "want": want,
            "peak": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0,
            "capture": at_capture.counts, "replay": at_replay.counts}


def hold_pair(label: str, graph: dict, eager: dict, lines: list, bad: list) -> None:
    """Phase 13's rule on every rank: each loss and state tensor within
    GRAPH_LIMIT relative (bit-equal expected; read printed); on the card,
    the collectives at the capture ``want`` and none during the replays.
    Every rank's readings go to ``lines``, its failures to ``bad``."""
    loss_err, (_, state_err), equal = graph_errors(
        graph["losses"], graph["state"], eager["losses"], eager["state"])
    mine = {"loss": loss_err, "state": state_err, "equal": equal,
            "graph_ms": graph["ms"], "eager_ms": statistics.median(eager["ms"][1:]),
            "peak": (graph["peak"], eager["peak"]), "capture": graph["capture"],
            "replay": graph["replay"], "want": graph["want"],
            "losses": graph["losses"]}
    every = [None] * basics.size()
    dist.all_gather_object(every, mine)
    lines.append(f"{label} graphed (K = {GRAPH_K}, {GRAPH_DISPATCHES} dispatches) "
                 f"vs eager, rank 0 losses {every[0]['losses']}:")
    for r, m in enumerate(every):
        lines.append(
            f"  rank {r}: loss {m['loss']:.3e}, state {m['state']:.3e} relative "
            f"(limit {GRAPH_LIMIT:g}), bit-equal {m['equal']}; step ms graphed "
            f"{[round(t, 2) for t in m['graph_ms']]} (a dispatch / {GRAPH_K}), "
            f"eager median {m['eager_ms']:.2f}; peak GB graphed {m['peak'][0]:.3f}, "
            f"eager {m['peak'][1]:.3f}; collectives at the capture {m['capture']} "
            f"(want {m['want']}), during the replays {m['replay']}")
        if not (m["loss"] <= GRAPH_LIMIT and m["state"] <= GRAPH_LIMIT):
            bad.append(lines[-1])
        elif basics.device().type == "cuda" and (m["capture"] != m["want"]
                                                 or m["replay"]):
            bad.append(lines[-1])
