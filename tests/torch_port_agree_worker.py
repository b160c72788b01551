"""One rank of the agreement world that tests/test_torch_port_autotune.py
launches on four gloo ranks: every rank's tuner and controller must
decide alike, though each rank reads other rates and another clock.

- ``autotune.tune`` over the default thresholds x ``num_buckets=(1, 4)``
  with ``gp_rounds=2``, its ``measure_steps_per_s`` replaced by a rate
  scripted from the candidate's knobs and the rank (each rank's curve
  peaks at another threshold, so the GP/EI rounds alone would pick other
  candidates on each rank): every rank builds the same candidates in the
  same order, and each measured rate is the slowest rank's.
- ``control.TrainingController`` fed 60 scripted windows whose steps/s
  differ by rank (rank r's score drops by 0.6 r with a bucketed exchange,
  so the canary verdicts alone would differ), on a clock that runs r + 1
  seconds a window on rank r against a 2.5 s cooldown: every rank lands
  the same ``rejit`` calls and keeps the same history.

Each rank prints nothing but rank 0's ``ok agree world 4``; every rank
exits non-zero on any difference. Identity and rendezvous come from the
launcher's ``HOROVOD_*`` variables.
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from horovod_tpu_torch import autotune  # noqa: E402
from horovod_tpu_torch.common import basics  # noqa: E402
from horovod_tpu_torch.control import training  # noqa: E402
from horovod_tpu_torch.metrics.registry import MetricsRegistry  # noqa: E402
from horovod_tpu_torch.parallel import collectives  # noqa: E402

WINDOWS = 60


def scripted_rate(rank: int, threshold: int, num_buckets: int) -> float:
    """A curve over log2(threshold) peaking at 2^(21 + 2 rank), with a
    bucket term that favours 4 buckets on even ranks and 1 on odd ones."""
    lt = math.log2(threshold)
    nb = math.log2(num_buckets)
    return (20.0 - 0.5 * (lt - 21 - 2 * rank) ** 2
            - 0.8 * (nb - (2 if rank % 2 == 0 else 0)) ** 2)


def tune_world(rank: int) -> None:
    calls = []
    current = {}

    def factory(fusion_threshold, num_buckets):
        calls.append((fusion_threshold, num_buckets))
        current.update(th=fusion_threshold, nb=num_buckets)
        return lambda: None

    def measure(run, *args, **kwargs):
        run()
        return scripted_rate(rank, current["th"], current["nb"])

    autotune.measure_steps_per_s = measure
    report = autotune.tune(factory, num_buckets=(1, 4), gp_rounds=2)
    table = [(m.fusion_threshold, m.num_buckets, m.steps_per_s)
             for m in report.table]
    every = collectives.allgather_object((calls, table))
    if any(e != every[0] for e in every):
        raise AssertionError(f"rank {rank}: tune differs across ranks: {every}")
    n_seed = len(autotune.DEFAULT_THRESHOLDS) * 2
    if len(calls) <= n_seed:
        raise AssertionError(f"no GP/EI round ran: {calls}")
    for th, nb, rate in table:
        want = min(scripted_rate(r, th, nb) for r in range(basics.size()))
        if rate != want:
            raise AssertionError(f"{th}, {nb}: rate {rate}, the slowest "
                                 f"rank's is {want}")


def controller_world(rank: int) -> None:
    clock = [0.0]
    training.time.monotonic = lambda: clock[0]
    rejits = []
    tc = training.TrainingController(rejit=rejits.append, canary_steps=2,
                                     cooldown_s=2.5, reg=MetricsRegistry())
    for i in range(WINDOWS):
        clock[0] += rank + 1.0
        v = tc.loop.values
        score = scripted_rate(0, v["fusion_threshold"], v["num_buckets"]) \
            - (0.6 * rank if v["num_buckets"] != 1 else 0.0) \
            + 0.01 * ((i * 7919 + rank) % 5 - 2)
        tc.on_step(score)
    history = [{k: v for k, v in d.items() if k != "time_unix_s"}
               for d in tc.loop.history]
    every = collectives.allgather_object((rejits, history))
    if any(e != every[0] for e in every):
        raise AssertionError(f"rank {rank}: the controllers differ: {every}")
    if len(history) < 3 or len({d["verdict"] for d in history}) < 2:
        raise AssertionError(f"too few decisions to compare: {history}")


def main() -> None:
    basics.init("cpu")
    if basics.size() != 4:
        raise SystemExit(f"the agreement world takes 4 ranks, not {basics.size()}")
    rank = basics.rank()
    tune_world(rank)
    controller_world(rank)
    if rank == 0:
        print(f"ok agree world {basics.size()}", flush=True)
    basics.shutdown()


if __name__ == "__main__":
    main()
