"""One rank of the overlap worlds that tests/test_torch_port_overlap.py
(gloo, on the CPU) and tests/test_torch_port_cuda.py (NCCL, one process per
GPU) launch. It imports no JAX: the CPU test computes the JAX package's
side itself. Each rank writes its results to ``OVERLAP_OUT.<rank>.json``
(the CPU worlds) or prints them (rank 0 of the card world).
``OVERLAP_MODE`` picks the world:

``two`` (2 ranks): the optimizer tests' MLP (``OVERLAP_IN``: the problem
as an .npz, ``OVERLAP_CFG``: its knobs as JSON), 3 Adam steps of every
configuration with the exchange from the gradient hooks
(``latency_hiding`` on) and with the serial exchange: wires none and bf16
x K 1 and 3; two backward passes per step; ``b2`` unused on rank 1 only;
the forward (K = 1) plan, whose buckets complete against plan order. At
every landing a hook registered after the optimizer's records how many
collectives the optimizer has issued, so the test can hold each launch to
the moment its bucket and every bucket before it in the launch order had
landed. Then the two
failures: a gradient that lands twice before ``step()``, and
``zero_grad()`` after the backward pass.

``four`` (4 ranks): the MLP on a quarter of the batch per rank, hooked
against serial: flat, ``group=`` (the batch groups of a 2 x 2 layout), the
hierarchical ladder on 2 x 2 (plain and with a bf16 DCN wire), ZeRO 2 x 2
and 1 x 4; and a small TransformerLM through ``train.setup``, flat and
``TrainConfig(sharded=True)`` at ``HOROVOD_MESH=2x2``.

``cuda`` (4 GPUs): the full-width flash TransformerLM over NCCL, 13
steps a run, hooked against serial bit for bit in every loss and
parameter: flat DP at ``HOROVOD_NUM_BUCKETS`` 1 (serial, twice), 4
(serial, hooked, hooked, serial) and 8; the graphed loop at 4 buckets,
``steps_per_dispatch=4``, 6 dispatches (serial, hooked, hooked, serial);
ZeRO 2 x 2 (serial, hooked, hooked, serial); dp 2 x sp 2 (ring flash, B4-B6) and dp 2 x pp 2
(``train.setup_pipeline``), the DP exchange beside the ring's and the
pipeline's P2P. Each run prints every rank's median step ms over steps
3-12 and the spread over all ranks, the buckets that launched before
``backward()`` returned, and ``measure_overlap``'s report of 2 more
steps. Rank 0 prints ``ok overlap world <n>``.

Every rank exits non-zero on any failure. Identity and rendezvous come
from the launcher's ``HOROVOD_*`` variables.
"""

import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.common import basics  # noqa: E402
from horovod_tpu_torch.parallel import sharded as sh  # noqa: E402
from horovod_tpu_torch.parallel.mesh import (hierarchical_groups,  # noqa: E402
                                             sharded_groups)

NAMES = ("b1", "b2", "w1", "w2")


def hooks(on: bool) -> None:
    """HOROVOD_LATENCY_HIDING as ``init`` read it, for the optimizers built
    from here on."""
    basics.config().latency_hiding = on


class Landings:
    """A post-accumulate-grad hook on each parameter, registered after the
    optimizer's (hooks run in the order registered): at each landing, the
    parameter's name and the ``all_reduce`` calls issued so far."""

    def __init__(self, named):
        self.log, self.calls = [], 0
        for name, p in named:
            p.register_post_accumulate_grad_hook(
                lambda _, name=name: self.log[-1].append((name, self.calls)))
        self.saved = dist.all_reduce

        def counted(*args, **kwargs):
            self.calls += 1
            return self.saved(*args, **kwargs)

        dist.all_reduce = counted

    def new_step(self):
        self.log.append([])
        self.calls = 0

    def close(self):
        dist.all_reduce = self.saved


def mlp_loss(p, x, y, use_b2=True):
    h = torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]
    return ((h + p["b2"] - y) ** 2).mean() if use_b2 else ((h - y) ** 2).mean()


def mlp_run(data, cfg, x, y, on, wire="none", k=1, passes=1, use_b2=True,
            watch=False, **opt_kw) -> dict:
    """``cfg["steps"]`` Adam steps of the MLP through DistributedOptimizer
    with the hooks ``on`` or off: the losses (rank-averaged), the
    parameters after the last step, each step's ``last_launches``."""
    hooks(on)
    named = [(n, torch.nn.Parameter(torch.tensor(data[n]))) for n in NAMES]
    p = dict(named)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam([t for _, t in named], lr=cfg["lr"]), named,
        compression=hvd.Compression.by_name(wire), num_buckets=k,
        fusion_threshold=cfg["threshold"], backward_passes_per_step=passes,
        **opt_kw)
    hvd.broadcast_parameters(named, root_rank=0)
    landings = Landings(named) if watch else None
    losses, launches = [], []
    for _ in range(cfg["steps"]):
        opt.zero_grad()
        if landings is not None:
            landings.new_step()
        for xs, ys in zip(x.chunk(passes), y.chunk(passes)):
            loss = mlp_loss(p, xs, ys, use_b2)
            loss.backward()
            opt.step()
        losses.append(hvd.metric_average(loss.item()))
        launches.append(opt.last_launches)
    out = {"losses": losses, "launches": launches, "order": opt.launch_order,
           "buckets": [[d.index for d in b] for b in opt.plan.buckets],
           **{n: t.detach().tolist() for n, t in named}}
    if landings is not None:
        landings.close()
        out["landings"] = landings.log
    return out


def failures(data, cfg, x, y) -> dict:
    """The two misuses with the hooks on, on every rank alike: a second
    backward pass before ``step()``, then ``zero_grad()`` after one."""
    hooks(True)
    named = [(n, torch.nn.Parameter(torch.tensor(data[n]))) for n in NAMES]
    p = dict(named)
    opt = hvd.DistributedOptimizer(torch.optim.SGD([t for _, t in named], lr=0.1),
                                   named, num_buckets=3,
                                   fusion_threshold=cfg["threshold"])
    out = {}
    mlp_loss(p, x, y).backward()
    try:
        mlp_loss(p, x, y).backward()
        out["twice"] = None
    except RuntimeError as e:
        out["twice"] = str(e)
    opt.synchronize()           # waits for what the first pass started
    opt.optimizer.zero_grad()
    mlp_loss(p, x, y).backward()
    try:
        opt.zero_grad()
        out["zero_grad"] = None
    except RuntimeError as e:
        out["zero_grad"] = str(e)
    out["stepped"] = opt.step()
    return out


def run_two(rank: int) -> dict:
    data = np.load(os.environ["OVERLAP_IN"])
    cfg = json.loads(os.environ["OVERLAP_CFG"])
    sl = slice(rank * cfg["batch"], (rank + 1) * cfg["batch"])
    x, y = torch.tensor(data["x"][sl]), torch.tensor(data["y"][sl])
    res = {"env_latency_hiding": basics.config().latency_hiding}
    for on in (False, True):
        tag = "hooked" if on else "serial"
        for wire, k in cfg["configs"]:
            res[f"{wire}-{k}/{tag}"] = mlp_run(data, cfg, x, y, on, wire, k,
                                               watch=on)
        res[f"passes2/{tag}"] = mlp_run(data, cfg, x, y, on, k=3, passes=2)
        res[f"missing/{tag}"] = mlp_run(data, cfg, x, y, on, k=3,
                                        use_b2=rank != 1, watch=on)
    res["failures"] = failures(data, cfg, x, y)
    return res


def zero_run(leaves, x, y, layout, on, steps, lr) -> dict:
    """``steps`` steps of the MLP through DistributedOptimizer(sharded=True)
    on ``layout``: losses, the gathered parameters, the launches."""
    hooks(on)
    params = [torch.nn.Parameter(t.clone()) for t in leaves]
    plan = sh.build_shard_plan(params, layout.shard_size, 1 << 20, 3)
    rows = sh.shard_params(params, plan, layout.shard_rank)
    opt = hvd.DistributedOptimizer(torch.optim.Adam(list(rows), lr=lr, foreach=True),
                                   list(zip(NAMES, params)), sharded=True,
                                   shard_plan=plan, layout=layout)
    losses, launches = [], []
    for _ in range(steps):
        opt.zero_grad()
        sh.gather_params(rows, plan, layout, params)
        loss = mlp_loss(dict(zip(NAMES, params)), x, y)
        loss.backward()
        opt.step()
        losses.append(hvd.metric_average(loss.item()))
        launches.append(opt.last_launches)
    sh.gather_params(rows, plan, layout, params)
    return {"losses": losses, "launches": launches, "order": opt.launch_order,
            **{n: t.detach().tolist() for n, t in zip(NAMES, params)}}


def transformer_run(on: bool, sharded: bool) -> dict:
    from horovod_tpu_torch import train

    hooks(on)
    config = train.TrainConfig(vocab=64, dim=32, heads=2, layers=2, seq=16,
                               attention="dense", sharded=sharded)
    os.environ["HOROVOD_MESH"] = "2x2" if sharded else ""
    try:
        s = train.setup(config, "cpu")
    finally:
        os.environ.pop("HOROVOD_MESH", None)
    tokens = train.make_batch(config, hvd.rank(), hvd.device())
    losses, launches = [], []
    for _ in range(3):
        losses.append(hvd.metric_average(s.step(tokens).item()))
        launches.append(s.opt.last_launches)
    if sharded:
        sh.gather_params(s.opt.rows, s.opt.shard_plan, s.opt.layout, s.opt.params)
    return {"losses": losses, "launches": launches, "order": s.opt.launch_order,
            "params": {n: p.detach().flatten().tolist()
                       for n, p in s.model.named_parameters()}}


def run_four(rank: int) -> dict:
    data = np.load(os.environ["OVERLAP_IN"])
    cfg = json.loads(os.environ["OVERLAP_CFG"])
    n = cfg["batch"] // 2
    x = torch.tensor(data["x"][rank * n:(rank + 1) * n])
    y = torch.tensor(data["y"][rank * n:(rank + 1) * n])
    leaves = [torch.tensor(data[k]) for k in NAMES]
    layout22, layout14 = sharded_groups(2, 2), sharded_groups(1, 4)
    hier = hierarchical_groups(ici_size=2)
    res = {}
    for on in (False, True):
        tag = "hooked" if on else "serial"
        res[f"flat/{tag}"] = mlp_run(data, cfg, x, y, on, k=3)
        res[f"group/{tag}"] = mlp_run(data, cfg, x, y, on, k=3,
                                      group=layout22.batch_group)
        res[f"hier/{tag}"] = mlp_run(data, cfg, x, y, on, k=3, hierarchical=True,
                                     groups=hier)
        res[f"hier-dcn-bf16/{tag}"] = mlp_run(
            data, cfg, x, y, on, k=3, hierarchical=True, groups=hier,
            dcn_compression=hvd.Compression.bf16)
        res[f"zero-2x2/{tag}"] = zero_run(leaves, x, y, layout22, on,
                                          cfg["steps"], cfg["lr"])
        res[f"zero-1x4/{tag}"] = zero_run(leaves, x, y, layout14, on,
                                          cfg["steps"], cfg["lr"])
        res[f"lm/{tag}"] = transformer_run(on, sharded=False)
        res[f"lm-zero-2x2/{tag}"] = transformer_run(on, sharded=True)
    return res


# ---------------------------------------------------------------- the cards

CUDA_STEPS, CUDA_WARM = 13, 3           # steps per run; the first 3 untimed


def card_run(config, on: bool, buckets: int, setup=None, measure=False) -> dict:
    """CUDA_STEPS steps of ``config`` (through ``setup``, default
    ``train.setup``) with the hooks ``on`` at ``HOROVOD_NUM_BUCKETS =
    buckets``: losses, the step ms of the steps after CUDA_WARM, the
    parameters on the host, the last step's launches and the agreed order;
    with ``measure`` also ``measure_overlap``'s report of 2 more steps."""
    from horovod_tpu_torch import train
    from horovod_tpu_torch.metrics.overlap import measure_overlap, record_plan

    hooks(on)
    basics.config().num_buckets = buckets
    dev = basics.device()
    s = (setup or train.setup)(config)
    if isinstance(s, train.PipelineSetup):      # the replica's batch
        tokens, model = train.make_batch(config, s.layout.dp_rank, dev), s.stage
    elif s.sp is not None:
        tokens, model = train.make_shard(config, s.sp, dev)[0], s.model
    else:
        tokens, model = train.make_batch(config, hvd.rank(), dev), s.model
    losses, times = [], []
    for _ in range(CUDA_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = s.step(tokens)
        torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(hvd.metric_average(loss.item()))
    if s.opt.sharded:
        sh.gather_params(s.opt.rows, s.opt.shard_plan, s.opt.layout, s.opt.params)
    run = {"losses": losses, "ms": times[CUDA_WARM:],
           "buckets": s.opt.plan.num_buckets, "launches": s.opt.last_launches,
           "order": s.opt.launch_order,
           "plan": record_plan(s.opt.plan, s.opt.threshold),
           "params": {n: p.detach().to("cpu", copy=True)
                      for n, p in model.named_parameters()}}
    if measure:                 # 2 more steps, after the parameters are read
        run["overlap"] = measure_overlap(lambda: s.step(tokens), steps=2,
                                         sync=torch.cuda.synchronize)
    del s, model
    torch.cuda.empty_cache()
    return run


GRAPH_DISPATCHES = 6                    # the first one warms up and captures


def graph_run(config, on: bool, buckets: int, setup=None, measure=False) -> dict:
    """GRAPH_DISPATCHES dispatches of the graphed loop of ``config``
    (``steps_per_dispatch`` steps each, drawn from the device cache) with
    the hooks ``on``: the per-step losses, each dispatch's ms per step but
    the first's, the parameters, the captured step's launches; with
    ``measure`` ``measure_overlap``'s report of 2 more dispatches."""
    from horovod_tpu_torch import train
    from horovod_tpu_torch.loop import make_scan_train_loop
    from horovod_tpu_torch.metrics.overlap import measure_overlap, record_plan

    hooks(on)
    basics.config().num_buckets = buckets
    dev = basics.device()
    s = train.setup(config)
    k = config.steps_per_dispatch
    loop = make_scan_train_loop(s.step, train.make_cache(config, s.sp, dev), k,
                                optimizer=s.opt)
    losses, times = [], []
    for _ in range(GRAPH_DISPATCHES):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0) / k)
        losses += loop.losses.tolist()
    run = {"losses": losses, "ms": times[1:], "buckets": s.opt.plan.num_buckets,
           "launches": s.opt.last_launches, "order": s.opt.launch_order,
           "plan": record_plan(s.opt.plan, s.opt.threshold),
           "params": {n: p.detach().to("cpu", copy=True)
                      for n, p in s.model.named_parameters()}}
    if measure:
        run["overlap"] = measure_overlap(loop, steps=2, sync=torch.cuda.synchronize)
    del s, loop
    torch.cuda.empty_cache()
    return run


def run_cuda() -> None:
    import dataclasses

    from horovod_tpu_torch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    n, rank = hvd.size(), hvd.rank()
    if n != 4:
        raise RuntimeError(f"the overlap world needs 4 GPUs, got {n}")
    config = train.TrainConfig()
    bad, lines = [], []

    def same(label, a, b):
        differ = [k for k in b["params"] if not torch.equal(a["params"][k],
                                                            b["params"][k])]
        ok = a["losses"] == b["losses"] and not differ
        lines.append(f"{label}: {len(a['losses'])} losses equal: "
                     f"{a['losses'] == b['losses']} (last {a['losses'][-1]!r}); "
                     f"{len(differ)} of {len(b['params'])} parameters differ "
                     f"({'bit-equal' if ok else 'NOT bit-equal'})")
        if not ok:
            bad.append(lines[-1])

    def timing(label, run):
        every = [None] * n
        dist.all_gather_object(every, [round(t, 3) for t in run["ms"]])
        med = [round(statistics.median(t), 3) for t in every]
        flat = [t for ts in every for t in ts]
        lines.append(f"{label}: {run['buckets']} buckets, step ms (timed "
                     f"steps) median per rank {med}, "
                     f"min {min(flat)}, max {max(flat)} over all ranks; rank 0 "
                     f"{every[0]}")
        lines.append(f"  rank 0's launches (bucket, leaves landed when a hook "
                     f"started it; None: synchronize): {run['launches']}")
        rep = run.get("overlap")
        if rep is not None:
            rep = {k: v for k, v in rep.items() if k != "spans"}
            lines.append(f"  measure_overlap, rank 0, 2 steps: {rep}")

    def pairs(label, cfg, k, setup=None, repeats=1, runner=card_run):
        """serial, hooked (, hooked, serial): each hooked run bit for bit
        against the serial one before it."""
        order = [False, True] + [True, False] * (repeats - 1)
        runs = [runner(cfg, on, k, setup, measure=True) for on in order]
        for i, (on, run) in enumerate(zip(order, runs)):
            timing(f"{label}, K = {k}, {'hooked' if on else 'serial'} "
                   f"(run {i + 1} of {len(runs)})", run)
        same(f"{label}, K = {k}, hooked vs serial", runs[1], runs[0])
        if repeats > 1:
            same(f"{label}, K = {k}, hooked vs serial (runs 3, 4)", runs[2], runs[3])
        plan = runs[1]["plan"]
        lines.append(f"  plan: bytes {[b for _, b in plan['buckets']]}, occupancy "
                     f"{plan['occupancy']:.4f}, planned bound "
                     f"{plan['planned_efficiency']:.4f}; agreed launch order "
                     f"{runs[1]['order']}")

    runs = [card_run(config, False, 1) for _ in range(2)]
    for i, run in enumerate(runs):
        timing(f"flat DP, K = 1, serial (run {i + 1} of 2)", run)
    del runs
    pairs("flat DP", config, 4, repeats=2)
    pairs("flat DP", config, 8)
    pairs("flat DP, graphed (steps_per_dispatch=4, ms per step of a dispatch)",
          dataclasses.replace(config, steps_per_dispatch=4), 4, repeats=2,
          runner=graph_run)
    os.environ["HOROVOD_MESH"] = "2x2"
    try:
        pairs("ZeRO 2x2", dataclasses.replace(config, sharded=True), 4, repeats=2)
    finally:
        os.environ.pop("HOROVOD_MESH", None)
    pairs("dp 2 x sp 2 (ring flash)", dataclasses.replace(config, sp=2,
                                                        seq=2 * config.seq), 4)
    pairs("dp 2 x pp 2", config, 4,
          setup=lambda c: train.setup_pipeline(c, 2, 1))
    peak = [None] * n
    dist.all_gather_object(peak, round(torch.cuda.max_memory_allocated() / 1e9, 3))
    lines.append(f"peak GB per rank over the runs: {peak}")
    if rank == 0:
        print("\n".join(lines), flush=True)
        if not bad:
            print(f"ok overlap world {n}", flush=True)
    dist.barrier()
    if bad:
        raise AssertionError("\n".join(bad))


def main() -> None:
    torch.set_num_threads(1)
    mode = os.environ["OVERLAP_MODE"]
    hvd.init(device="cuda" if mode == "cuda" else "cpu")
    try:
        if mode == "cuda":
            run_cuda()
            return
        res = run_two(hvd.rank()) if mode == "two" else run_four(hvd.rank())
        with open(f"{os.environ['OVERLAP_OUT']}.{hvd.rank()}.json", "w") as f:
            json.dump(res, f)
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
