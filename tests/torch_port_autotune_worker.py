"""One rank of the autotune world that tests/test_torch_port_autotune.py
(gloo, on the CPU, ``AUTOTUNE_MODE=cpu``: a small TransformerLM) and
tests/test_torch_port_cuda.py (NCCL, one process per GPU,
``AUTOTUNE_MODE=cuda``: the full-width flash TransformerLM of
``TrainConfig()``) launch on four ranks laid out 2 x 2
(``hierarchical_groups(ici_size=2)`` for the ladder).

``autotune.tune`` through ``train.TuneStepFactory`` over
``mesh_shapes=("4x1", "2x2", "1x4")`` (ZeRO on each layout) and
``hierarchicals=(False, True)``, then over ``hierarchicals`` alone (the
flat optimizer with and without the ladder), at the 64 MiB threshold
(one threshold: no GP/EI round). Each rank's steps/s of every candidate
are gathered and printed by rank 0; ``tune``'s rate of each is held to
be the slowest rank's. Then, for every candidate, 3 eager steps from the same weights
on the same cache draws, held to flat DP's:

- ZeRO at 4x1 (shard 1: the DP call) bit-equal;
- the parameter updates after each step, all parameters together, by
  relative norm: after the third within ``LIMIT`` (CPU 1e-5, against a
  reading of 1.0e-7; the card 1e-2, against 7.405e-3 and 7.067e-3);
- on the flat candidates, step 1's exchanged gradients (the averaged
  ``.grad``) within 1e-5 relative norm: Adam's update is blind to a
  bucket's scale, the gradient is not;
- ZeRO 2x2 bit-equal to the flat ladder (both sum within pairs, then the
  pairs).

Last, flat DP and ZeRO 2x2 on one repeated ``make_batch``, the data of
the sharded world (tests/torch_port_sharded_worker.py), printed beside
the draws. Rank 0 prints ``ok autotune world 4``; every rank exits
non-zero on any failure. Identity and rendezvous come from the
launcher's ``HOROVOD_*`` variables.
"""

import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from horovod_tpu_torch import autotune  # noqa: E402
from horovod_tpu_torch.common import basics  # noqa: E402
from horovod_tpu_torch.parallel import collectives  # noqa: E402
from horovod_tpu_torch.parallel import sharded as sh  # noqa: E402
from horovod_tpu_torch.train import (TrainConfig, TuneStepFactory,  # noqa: E402
                                     make_batch, make_cache)

MODE = os.environ.get("AUTOTUNE_MODE", "cpu")
MESHES = ("4x1", "2x2", "1x4")
THRESHOLD = 64 << 20
STEPS = 3
# Updates after STEPS steps, relative norm of flat DP's, and step 1's
# exchanged gradients; see the module docstring.
LIMIT = {"cuda": 1e-2, "cpu": 1e-5}[MODE]
GRAD_LIMIT = 1e-5


def log(msg):
    if basics.rank() == 0:
        print(msg, flush=True)


def updates(factory, config, data="cache", **knobs):
    """(the update of every parameter after each of STEPS eager steps, on
    the host; step seconds; the exchanged gradients of step 1 on the host,
    None on ZeRO, where they land in the rows). ``data`` "cache": the steps draw from the
    ``DeviceCache``, as a tuner's candidate does; "batch": every step takes
    this rank's one ``make_batch``, as the sharded world's comparison
    (tests/torch_port_sharded_worker.py) does."""
    s = factory.build(THRESHOLD, **knobs)
    dev = basics.device()
    before = [p.detach().clone() for p in s.opt.params]
    cache = make_cache(config, None, dev)
    batch = make_batch(config, basics.rank(), dev)
    ctr, times, out, grads = cache.counter(), [], [], None
    for i in range(STEPS):
        t0 = time.perf_counter()
        if data == "cache":
            x, y, ctr = cache.sample(ctr)
            loss = s.step(x, y)
        else:
            loss = s.step(batch)
        loss.item()
        times.append(time.perf_counter() - t0)
        if i == 0 and not s.opt.sharded:
            grads = [p.grad.detach().cpu() for p in s.opt.params]
        if s.opt.sharded:   # the model's parameters from the updated rows
            sh.gather_params(s.opt.rows, s.opt.shard_plan, s.opt.layout,
                             s.opt.params)
        out.append([(p.detach() - b).cpu() for p, b in zip(s.opt.params, before)])
    del before, cache, batch, s
    factory.close()
    return out, times, grads


def relnorm(got, want):
    num = sum(float((g - w).double().pow(2).sum()) for g, w in zip(got, want))
    den = sum(float(w.double().pow(2).sum()) for w in want)
    return (num / den) ** 0.5


def differing(got, want) -> int:
    return sum(int((g != w).sum()) for g, w in zip(got, want))


def main():
    device = "cuda" if MODE == "cuda" else "cpu"
    if MODE == "cuda":
        config = TrainConfig()
    else:
        config = TrainConfig(vocab=64, dim=32, heads=4, layers=2, seq=32)
    basics.init(device)
    if basics.size() != 4:
        raise SystemExit(f"the autotune world takes 4 ranks, not {basics.size()}")
    factory = TuneStepFactory(config, ici_size=2)
    window = dict(warmup=1, iters=3, reps=2)
    measure, own = autotune.measure_steps_per_s, []

    def measure_own(*args, **kwargs):   # this rank's rate, before tune agrees it
        own.append(measure(*args, **kwargs))
        return own[-1]

    autotune.measure_steps_per_s = measure_own
    zero = autotune.tune(factory, thresholds=(THRESHOLD,), mesh_shapes=MESHES,
                         hierarchicals=(False, True), **window)
    flat = autotune.tune(factory, thresholds=(THRESHOLD,),
                         hierarchicals=(False, True), **window)
    factory.close()
    autotune.measure_steps_per_s = measure
    rows = [(r["mesh_shape"] or "flat", bool(r["hierarchical"]),
             r["planned_buckets"], r["peak_bytes"]) for r in factory.records]
    agreed = {}
    for report in (zero, flat):
        for m in report.table:
            agreed[(m.mesh_shape or "flat", m.hierarchical)] = m.steps_per_s
    every = collectives.allgather_object(own)     # in the records' order
    log(f"autotune world: {basics.size()} ranks on {device}, {config}")
    for i, (mesh, hier, buckets, peak) in enumerate(rows):
        per_rank = [round(1e3 / r[i], 2) for r in every]
        if 1e3 / agreed[(mesh, hier)] != max(1e3 / r[i] for r in every):
            raise AssertionError(f"{mesh} {hier}: tune's rate is not the slowest "
                                 f"rank's: {agreed[(mesh, hier)]}, {every}")
        peak_txt = f", rank 0 peak {peak / 1e9:.3f} GB" if peak else ""
        log(f"  {mesh:>4} {'ladder' if hier else 'flat  '}: {buckets} buckets, "
            f"step ms per rank {per_rank}{peak_txt}")
    log(f"  best (the slowest rank's rates): ZeRO {zero.best.config}, "
        f"flat {flat.best.config}")
    want, base_ms, want_grads = updates(factory, config)
    log(f"  flat DP: {STEPS} steps, step ms {[round(t * 1e3, 2) for t in base_ms]}")
    got_by, failures = {}, []
    for mesh, hier in [(m, h) for m in MESHES for h in (False, True)] + [(None, True)]:
        label = f"{mesh or 'flat'} {'ladder' if hier else 'flat'}"
        got, ms, grads = updates(factory, config, hierarchical=hier,
                                 mesh_shape=mesh)
        got_by[(mesh, hier)] = got[-1]
        errs = collectives.allgather_object([relnorm(g, w) for g, w in zip(got, want)])
        err = max(e[-1] for e in errs)
        exact = all(collectives.allgather_object(
            all(torch.equal(g, w) for g, w in zip(got[-1], want[-1]))))
        log(f"  {label}: updates after steps 1..{STEPS} "
            f"{[f'{max(e[i] for e in errs):.3e}' for i in range(STEPS)]} relative "
            f"norm of flat DP's (limit {LIMIT:g} after {STEPS}), bit-equal {exact}, "
            f"median step ms {statistics.median(ms[1:]) * 1e3:.2f}")
        if grads is not None:
            grad_err = max(collectives.allgather_object(relnorm(grads, want_grads)))
            flips = collectives.allgather_object(
                [differing(g, w) for g, w in zip(got, want)])
            log(f"    step 1's exchanged gradients {grad_err:.3e} relative norm "
                f"of flat DP's (limit {GRAD_LIMIT:g}); elements whose update "
                f"differs after steps 1..{STEPS}: "
                f"{[max(f[i] for f in flips) for i in range(STEPS)]} of "
                f"{sum(w.numel() for w in want[0])}")
            if not grad_err <= GRAD_LIMIT:
                failures.append(f"{label}: step 1's gradients {grad_err} from flat DP's")
        if not err <= LIMIT:
            failures.append(f"{label}: updates {err} from flat DP's")
        if mesh == "4x1" and not exact:
            failures.append("ZeRO at shard 1 is not the DP step bit for bit")
    # Where the spread comes from: the two-level sums against each other,
    # and the sharded world's data (one repeated batch) against the draws.
    a, b = got_by[("2x2", False)], got_by[(None, True)]
    two_level = max(collectives.allgather_object(relnorm(a, b)))
    log(f"  ZeRO 2x2 against the flat ladder (both sum pairs, then pairs of "
        f"pairs): {two_level:.3e} relative norm")
    if two_level != 0:
        failures.append(f"ZeRO 2x2 is {two_level} from the flat ladder")
    batch_want, _, _ = updates(factory, config, data="batch")
    batch_got, _, _ = updates(factory, config, data="batch", mesh_shape="2x2")
    errs = collectives.allgather_object(
        [relnorm(g, w) for g, w in zip(batch_got, batch_want)])
    log(f"  one repeated make_batch (the sharded world's data): ZeRO 2x2 updates "
        f"after steps 1..{STEPS} "
        f"{[f'{max(e[i] for e in errs):.3e}' for i in range(STEPS)]} relative "
        f"norm of flat DP's")
    if failures:
        raise AssertionError("; ".join(failures))
    log(f"ok autotune world {basics.size()}")
    basics.shutdown()


if __name__ == "__main__":
    main()
