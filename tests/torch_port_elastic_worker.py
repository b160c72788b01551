"""The training function that the elastic tests hand to ``run_elastic``:
tests/test_torch_port_elastic.py on the CPU (gloo, a 2-layer narrow
TransformerLM) and tests/test_torch_port_cuda.py's ``elastic_world`` on four
cards (NCCL, the full-width model). It imports no JAX. The workers import
it by name (``run_elastic`` ships the function by reference), so the
launching test puts this directory on their ``PYTHONPATH``.

``lm_train`` joins the launched world, builds the model from the config's
seed and a flat ``DistributedOptimizer`` over Adam without a collective
(a worker that joins a running job must meet the survivors first in
``ElasticState.sync``), then trains under ``hvd.elastic.run`` with a commit
after every step. Step ``i`` on rank ``r`` trains on the batch drawn from
(seed + i, r), so a run whose ranks keep their numbers sees the same data
as one that never stopped. Each rank writes its parameters to
``<out>/params.<rank>.pt`` (and rank 0 of the first generation the initial
ones to ``<out>/init.pt``) and returns its rank, size, step, losses (one
per step, rank-averaged), generation, device index (None on the CPU), the
step it resumed from after ``load_checkpoint`` (0 without one), the B1-B3
launches it made, the seconds of each step it ran (the step and the loss's
average, without the commit), and for each reset the wall-clock times
(``time.time()``) at which its collective raised and at which training
resumed. Launched by ``run`` instead of ``run_elastic`` it trains the same
steps without the elastic launcher's settings. Two faults that kill no
process are test code here: ``joiner_sleep_s`` makes a worker that joined
after the first generation sleep between ``init`` and its ``sync``, and
``raise_at=(rank, step)`` makes that rank raise ``HorovodInternalError``
once, before that step.
"""

from __future__ import annotations

import dataclasses
import os
import time


def lm_train(device: str, config: dict, steps: int, out: str,
             checkpoint_dir=None, checkpoint_every: int = 1,
             joiner_sleep_s: float = 0.0, raise_at=None) -> dict:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import train as train_mod
    from horovod_tpu_torch.convert import jax_ordered
    from horovod_tpu_torch.ops import flash_attention as fa

    hvd.init(device)
    if joiner_sleep_s and os.environ.get("HOROVOD_ELASTIC_GENERATION") != "1":
        # A slow joiner: registered, in the new world, not yet in sync.
        time.sleep(joiner_sleep_s)
    dev = hvd.device()
    cfg = train_mod.TrainConfig(**config)
    model = train_mod.build_model(cfg, dev)
    opt = hvd.DistributedOptimizer(train_mod.adam(model.parameters(), cfg),
                                   jax_ordered(model.named_parameters()))
    step = train_mod.make_train_step(model, opt)
    state = hvd.elastic.ElasticState(checkpoint_dir=checkpoint_dir,
                                     checkpoint_every=checkpoint_every,
                                     model=model, opt=opt, step=0, losses=[])
    resumed_from = int(state.step) if state.load_checkpoint() else 0
    if os.environ.get("HOROVOD_ELASTIC_GENERATION") == "1" and hvd.rank() == 0:
        torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
                   os.path.join(out, "init.pt"))
    fa.reset_launches()
    resets = []
    step_s = []
    injected = []

    @hvd.elastic.run
    def train(state):
        if resets and resets[-1][1] is None:
            resets[-1][1] = time.time()
        while state.step < steps:
            batch_cfg = dataclasses.replace(cfg, seed=cfg.seed + int(state.step))
            tokens = train_mod.make_batch(batch_cfg, hvd.rank(), dev)
            t = time.perf_counter()
            try:
                if raise_at is not None and not injected \
                        and (hvd.rank(), int(state.step)) == tuple(raise_at):
                    injected.append(True)
                    raise hvd.HorovodInternalError("injected fault")
                loss = step(tokens)
                mean = hvd.metric_average(loss.item())
            except hvd.HorovodInternalError:
                resets.append([time.time(), None])
                raise
            step_s.append(time.perf_counter() - t)
            state.losses = state.losses + [mean]
            state.step += 1
            state.commit()
        return state.step

    train(state)
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               os.path.join(out, f"params.{hvd.rank()}.pt"))
    return {"rank": hvd.rank(), "size": hvd.size(), "step": int(state.step),
            "losses": list(state.losses), "resumed_from": resumed_from,
            "generation": int(os.environ.get("HOROVOD_ELASTIC_GENERATION", 0)),
            "device": dev.index, "launches": dict(fa.launches),
            "step_s": step_s, "resets": resets}
