"""One rank of the sharded worlds that tests/test_torch_port_sharded.py,
tests/test_torch_port_fsdp.py (gloo, on the CPU) and
tests/test_torch_port_cuda.py (NCCL, one process per GPU) launch. It
imports no JAX: the CPU tests compute the JAX package's side and hand
inputs over in an .npz file (``SHARDED_IN``); each rank writes its results
to ``SHARDED_OUT.<rank>.npz``. ``SHARDED_MODE`` picks the world:

``zero`` (4 ranks): the ``('batch', 'shard')`` layouts of
``sharded_groups`` at 2x2, 1x4, 4x1, 2x2x1 and ``HOROVOD_MESH=2x2`` (each
group's global ranks, and every ``new_group`` call in order); the
reduce-scatter then gather of integer-valued payloads ``ints + rank`` at
2x2 and 1x4; 5 Adam steps (lr 1e-2) of the reference tests' MLP through
``DistributedOptimizer(sharded=True)`` at 2x2 in float64, and at 4x1 in
float32 beside the flat data-parallel world; 4 steps of an inner optimizer
that adds seeded noise to every element at 1x4, with and without
``mask_pad_``; the bf16 wire at 2x2; ``broadcast_sharded_state`` at 2x2,
of fresh rows and of an optimizer one step in.

``fsdp`` (4 ranks): ``__graft_entry__._fsdp_step``'s body over 3 steps on
``training_groups(1, 4)`` and ``_dp_fsdp_step``'s on ``training_groups(2,
2)``, in float64; the pad tail under the noisy optimizer with and without
``fsdp_mask_``; the layout's groups.

``train`` (2 ranks): 3 steps of a small ``TrainConfig()``,
``TrainConfig(sharded=True)`` at ``HOROVOD_MESH=1x2`` and ``setup_fsdp``
on ``training_groups(1, 2)``: losses and the parameters after the last
step.

``cuda`` (4 GPUs): the full-width flash TransformerLM, 3 steps each of
flat DP, ZeRO 2x2 and 1x4 (``TrainConfig(sharded=True)`` with
``HOROVOD_MESH``) and FSDP 4 (``setup_fsdp``), from the same weights on the
same tokens. Each sharded run's updates of all parameters together are
held to flat DP's by relative norm, 3e-2 (the chip tests' bf16 limit for
sums in another order; four ranks reduce-scatter and all-reduce in
another order than the ring allreduce). Rank 0 prints each run's median
step ms (steps 1-2), every rank's peak memory, the collectives of a
sharded step (one reduce-scatter and one all-gather per bucket, and at
2x2 one batch all-reduce per bucket), and ``ok sharded world <n>``.

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
from horovod_tpu_torch.parallel import fsdp  # noqa: E402
from horovod_tpu_torch.parallel import sharded as sh  # noqa: E402
from horovod_tpu_torch.parallel.collectives import ReduceOp  # noqa: E402
from horovod_tpu_torch.parallel.mesh import (sharded_groups,  # noqa: E402
                                             training_groups)

# The reference tests' MLP leaves in JAX's flatten order (sorted keys).
NAMES = ["b1", "w1", "w2"]
THRESHOLD, NUM_BUCKETS, LR = 1 << 20, 2, 1e-2
# (batch, shard, model) as sharded_groups takes them; None: not named.
LAYOUTS = {"2x2": (2, 2, None), "1x4": (1, 4, None), "4x1": (4, 1, None),
           "2x2x1": (2, 2, 1)}
CUDA_STEPS, CUDA_LIMIT = 3, 3e-2


class Noisy(torch.optim.Optimizer):
    """SGD plus seeded noise on every element: an inner optimizer that
    moves entries whose gradient is 0 (the pad tail's)."""

    def __init__(self, params, lr: float, seed: int):
        super().__init__(params, {"lr": lr})
        self.gen = torch.Generator().manual_seed(seed)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                noise = torch.randn(p.shape, generator=self.gen, dtype=p.dtype)
                p.add_(p.grad, alpha=-group["lr"]).add_(0.01 * noise)


def _group_ranks(group) -> np.ndarray:
    return np.array(dist.get_process_group_ranks(group))


def mlp_loss(params, x, y):
    b1, w1, w2 = params
    return ((torch.tanh(x @ w1 + b1) @ w2 - y) ** 2).mean()


def _leaves(data, dtype):
    return [torch.from_numpy(data[f"params/{n}"]).to(dtype) for n in NAMES]


def _my_rows(data, key, rank, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(data[key][rank]))
    return t if dtype is None else t.to(dtype)


def train_zero(layout, leaves, x, y, steps, inner, mask=True):
    """``steps`` steps of the MLP through DistributedOptimizer(sharded=True)
    (``mask=False``: the same exchange and inner step by hand, no mask).
    Returns (full parameters after a last gather, rows, plan)."""
    params = [torch.nn.Parameter(t.clone()) for t in leaves]
    plan = sh.build_shard_plan(params, layout.shard_size, THRESHOLD, NUM_BUCKETS)
    rows = sh.shard_params(params, plan, layout.shard_rank)
    opt = hvd.DistributedOptimizer(inner(rows), list(zip(NAMES, params)),
                                   sharded=True, shard_plan=plan, layout=layout)
    for _ in range(steps):
        opt.zero_grad()
        sh.gather_params(rows, plan, layout, params)
        mlp_loss(params, x, y).backward()
        if mask:
            opt.step()
        else:
            reduced = sh.reduce_scatter_gradients(
                [p.grad for p in params], plan, layout, wires=opt.wires)
            for row, g in zip(rows, reduced):
                row.grad = g
            opt.optimizer.step()
    sh.gather_params(rows, plan, layout, params)
    return [p.detach() for p in params], rows, plan


def train_dp(leaves, x, y, steps):
    params = [torch.nn.Parameter(t.clone()) for t in leaves]
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(params, lr=LR, foreach=True), list(zip(NAMES, params)),
        fusion_threshold=THRESHOLD, num_buckets=NUM_BUCKETS, sharded=False)
    for _ in range(steps):
        opt.zero_grad()
        mlp_loss(params, x, y).backward()
        opt.step()
    return [p.detach() for p in params]


def adam(rows):
    return torch.optim.Adam(list(rows), lr=LR, foreach=True)


def run_zero(data, rank: int) -> dict:
    res = {}
    calls = []
    new_group = dist.new_group

    def recording(ranks=None, *args, **kwargs):
        calls.append(list(ranks))
        return new_group(ranks, *args, **kwargs)

    dist.new_group = recording
    try:
        layouts = {k: sharded_groups(*v) for k, v in LAYOUTS.items()}
        os.environ["HOROVOD_MESH"] = "2x2"
        layouts["env 2x2"] = sharded_groups()
    finally:
        dist.new_group = new_group
        os.environ.pop("HOROVOD_MESH", None)
    res["new_group_calls"] = np.array(json.dumps(calls))
    for name, lay in layouts.items():
        res[f"layout/{name}/batch"] = _group_ranks(lay.batch_group)
        res[f"layout/{name}/shard"] = _group_ranks(lay.shard_group)
        res[f"layout/{name}/model"] = np.array([]) if lay.model_group is None \
            else _group_ranks(lay.model_group)
        res[f"layout/{name}/coords"] = np.array(
            [lay.batch_rank, lay.batch_size, lay.shard_rank, lay.shard_size,
             lay.model_rank, lay.model_size])

    ints = [torch.from_numpy(data[f"ints/{k}"]) + rank for k in ("a", "b")]
    for name in ("2x2", "1x4"):
        lay = layouts[name]
        plan = sh.build_shard_plan(ints, lay.shard_size, THRESHOLD, NUM_BUCKETS)
        reduced = sh.reduce_scatter_gradients(ints, plan, lay)
        full = [torch.zeros_like(t) for t in ints]
        sh.gather_params(reduced, plan, lay, full)
        for k, t in zip(("a", "b"), full):
            res[f"oracle/{name}/{k}"] = t.numpy()

    x, y = _my_rows(data, "x", rank), _my_rows(data, "y", rank)
    full, _, _ = train_zero(layouts["2x2"], _leaves(data, torch.float64),
                            x.double(), y.double(), 5, adam)
    for n, t in zip(NAMES, full):
        res[f"traj64/{n}"] = t.numpy()
    leaves = _leaves(data, torch.float32)
    full, _, _ = train_zero(layouts["4x1"], leaves, x, y, 5, adam)
    flat = train_dp(leaves, x, y, 5)
    for n, a, b in zip(NAMES, full, flat):
        res[f"shard1/{n}"], res[f"dp/{n}"] = a.numpy(), b.numpy()

    lay = layouts["1x4"]
    for mask in (True, False):
        full, rows, plan = train_zero(lay, leaves, x, y, 4,
                                      lambda r: Noisy(list(r), LR, 7 + rank),
                                      mask=mask)
        tag = "masked" if mask else "unmasked"
        for b, row in enumerate(rows):
            res[f"noise/{tag}/row{b}"] = row.detach().numpy()
        for n, t in zip(NAMES, full):
            res[f"noise/{tag}/{n}"] = t.numpy()
    res["noise/raw"] = np.array(plan.raw_sizes)
    res["noise/chunk"] = np.array(plan.chunk_sizes)

    lay = layouts["2x2"]
    big = [_my_rows(data, "big", rank)]
    for tag, min_bytes in (("bf16", 0), ("optout", 1 << 20)):
        plan = sh.build_shard_plan(big, lay.shard_size, THRESHOLD, 1)
        wires = sh.shard_wires(plan, ReduceOp.AVERAGE, "bf16", min_bytes)
        reduced = sh.reduce_scatter_gradients(big, plan, lay, wires=wires)
        out = [torch.zeros_like(big[0])]
        sh.gather_params(reduced, plan, lay, out)
        res[f"wire/{tag}"] = out[0].numpy()
        res[f"wire/{tag}/wires"] = np.array(json.dumps(
            [None if w is None else str(w).removeprefix("torch.") for w in wires]))

    res.update(broadcasts(data, rank, lay, leaves, x, y))
    return res


def broadcasts(data, rank: int, lay, leaves, x, y) -> dict:
    """Fresh rows, and an optimizer one step in, perturbed on batch rank 1
    (rows + 100, Adam's moments + 100, lr 0.5), then broadcast over the
    batch group."""
    res = {}
    plan = sh.build_shard_plan(leaves, lay.shard_size, THRESHOLD, NUM_BUCKETS)
    rows = sh.shard_params(leaves, plan, lay.shard_rank)
    with torch.no_grad():
        for row in rows:
            row.add_(100.0 * lay.batch_rank)
    hvd.broadcast_sharded_state(rows, layout=lay)
    for b, row in enumerate(rows):
        res[f"bcast/fresh/row{b}"] = row.detach().numpy()

    params = [torch.nn.Parameter(t.clone()) for t in leaves]
    rows = sh.shard_params(params, plan, lay.shard_rank)
    opt = hvd.DistributedOptimizer(adam(rows), list(zip(NAMES, params)),
                                   sharded=True, shard_plan=plan, layout=lay)
    opt.zero_grad()
    sh.gather_params(rows, plan, lay, params)
    mlp_loss(params, x, y).backward()
    opt.step()

    def snapshot():
        out = {f"row{b}": row.detach().clone() for b, row in enumerate(rows)}
        for b, row in enumerate(rows):
            for k, v in opt.optimizer.state[row].items():
                out[f"row{b}/{k}"] = v.clone()
        out["lr"] = torch.tensor(opt.optimizer.param_groups[0]["lr"])
        return out

    before = snapshot()
    if lay.batch_rank == 1:
        with torch.no_grad():
            for row in rows:
                row.add_(100.0)
                for k in ("exp_avg", "exp_avg_sq"):
                    opt.optimizer.state[row][k].add_(100.0)
        opt.optimizer.param_groups[0]["lr"] = 0.5
    hvd.broadcast_sharded_state(opt)
    after = snapshot()
    for k in before:
        res[f"bcast/state/before/{k}"] = before[k].numpy()
        res[f"bcast/state/after/{k}"] = after[k].numpy()
    return res


def _fsdp_body(rows, shapes, layout, x, steps, inner):
    for _ in range(steps):
        inner.zero_grad()
        full = fsdp.fsdp_gather_params(rows, shapes, layout.fsdp_group)
        torch.mean(torch.tanh(x @ full["w"] + full["b"]) ** 2).backward()
        fsdp.fsdp_average_gradients_(rows, layout)
        inner.step()


def run_fsdp(data, rank: int) -> dict:
    res = {}
    params = {k: torch.from_numpy(data[f"graft/{k}"]) for k in ("w", "b")}
    for name, (dp, fs) in (("fsdp", (1, 4)), ("dp_fsdp", (2, 2))):
        layout = training_groups(dp, fs)
        res[f"{name}/layout"] = np.array(
            [*_group_ranks(layout.dp_group), -1, *_group_ranks(layout.fsdp_group)])
        rows, shapes = fsdp.fsdp_shard_params(params, fs, layout.fsdp_rank)
        x = _my_rows(data, "graft/x", rank)
        _fsdp_body(rows, shapes, layout, x, 3,
                   torch.optim.Adam(list(rows.values()), lr=1e-3, foreach=True))
        for k, row in rows.items():
            res[f"{name}/row/{k}"] = row.detach().numpy()

    layout = training_groups(1, 4)
    mlp = {k: torch.from_numpy(data[f"tail/{k}"]) for k in ("b1", "w1", "w2")}
    x, y = _my_rows(data, "tail/x", rank), _my_rows(data, "tail/y", rank)
    for mask in (True, False):
        rows, shapes = fsdp.fsdp_shard_params(mlp, 4, layout.fsdp_rank)
        inner = Noisy(list(rows.values()), 1e-2, 11 + rank)
        for _ in range(3):
            inner.zero_grad()
            full = fsdp.fsdp_gather_params(rows, shapes, layout.fsdp_group)
            mlp_loss([full[k] for k in ("b1", "w1", "w2")], x, y).backward()
            fsdp.fsdp_average_gradients_(rows, layout)
            inner.step()
            if mask:
                fsdp.fsdp_mask_(rows, shapes, layout.fsdp_rank)
        tag = "masked" if mask else "unmasked"
        for k, row in rows.items():
            res[f"tail/{tag}/{k}"] = row.detach().numpy()
    return res


def run_train(data, rank: int) -> dict:
    from horovod_tpu_torch import train as T

    config = T.TrainConfig(**json.loads(str(data["config"])))
    res = {}
    runs = {"dp": config,
            "zero": T.TrainConfig(**{**config.__dict__, "sharded": True})}
    os.environ["HOROVOD_MESH"] = "1x2"
    try:
        for name, c in runs.items():
            s = T.setup(c, "cpu")
            tokens = T.make_batch(c, rank, "cpu")
            res[f"{name}/losses"] = np.array(
                [hvd.metric_average(s.step(tokens).item()) for _ in range(3)])
            if s.opt.sharded:
                res["zero/layout"] = np.array([s.opt.layout.batch_size,
                                               s.opt.layout.shard_size])
                sh.gather_params(s.opt.rows, s.opt.shard_plan, s.opt.layout,
                                 s.opt.params)
            for n, p in s.model.named_parameters():
                res[f"{name}/param/{n}"] = p.detach().numpy().copy()
    finally:
        os.environ.pop("HOROVOD_MESH", None)
    s = T.setup_fsdp(config, training_groups(1, 2), "cpu")
    tokens = T.make_batch(config, rank, "cpu")
    res["fsdp/losses"] = np.array(
        [hvd.metric_average(s.step(tokens).item()) for _ in range(3)])
    everyone = [None] * basics.size()
    dist.all_gather_object(everyone, {k: v.detach() for k, v in s.rows.items()})
    for n, t in fsdp.fsdp_unshard_params(everyone, s.shapes).items():
        res[f"fsdp/param/{n}"] = t.numpy()
    return res


def run_cpu() -> None:
    rank = hvd.rank()
    data = np.load(os.environ["SHARDED_IN"])
    mode = os.environ["SHARDED_MODE"]
    res = {"zero": run_zero, "fsdp": run_fsdp, "train": run_train}[mode](data, rank)
    np.savez(f"{os.environ['SHARDED_OUT']}.{rank}.npz", **res)


# ---------------------------------------------------------------- the cards

class CountCollectives:
    """Count ``torch.distributed``'s collectives inside the ``with``."""

    NAMES = ("reduce_scatter_tensor", "all_reduce", "all_gather_into_tensor")

    def __init__(self):
        self.counts, self.saved = {}, {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.saved[name] = getattr(dist, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                return _fn(*args, **kwargs)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def cuda_run(T, label, config, mesh=None):
    """CUDA_STEPS steps; (losses, median step ms of steps 1-2, this rank's
    peak GB, the collectives of step 1, the parameters after the last
    step on the host)."""
    dev = basics.device()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    if mesh is not None:
        os.environ["HOROVOD_MESH"] = mesh
    try:
        s = T.setup_fsdp(config, device="cuda") if label.startswith("FSDP") \
            else T.setup(config, "cuda")
    finally:
        os.environ.pop("HOROVOD_MESH", None)
    tokens = T.make_batch(config, hvd.rank(), dev)
    losses, times, counter = [], [], CountCollectives()
    for i in range(CUDA_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if i == 1:
            with counter:
                loss = s.step(tokens)
        else:
            loss = s.step(tokens)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(hvd.metric_average(loss.item()))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    if label.startswith("FSDP"):
        everyone = [None] * hvd.size()
        dist.all_gather_object(everyone, {k: v.detach().cpu() for k, v in s.rows.items()})
        params = fsdp.fsdp_unshard_params(everyone, s.shapes)
        buckets = len(s.rows)
    else:
        if s.opt.sharded:
            sh.gather_params(s.opt.rows, s.opt.shard_plan, s.opt.layout, s.opt.params)
        params = {n: p.detach().cpu() for n, p in s.model.named_parameters()}
        buckets = s.opt.plan.num_buckets
    del s
    return {"losses": losses, "ms": 1e3 * statistics.median(times[1:]),
            "peak": peak, "counts": counter.counts, "params": params,
            "buckets": buckets}


def run_cuda() -> None:
    from horovod_tpu_torch import train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    n, rank = hvd.size(), hvd.rank()
    if n != 4:
        raise RuntimeError(f"the sharded world needs 4 GPUs, got {n}")
    config = T.TrainConfig()
    init = {name: p.detach().cpu() for name, p in T.build_model(
        config, basics.device()).named_parameters()}
    torch.cuda.empty_cache()
    runs = {"flat DP": cuda_run(T, "flat DP", config)}
    zero = T.TrainConfig(sharded=True)
    for mesh in ("2x2", "1x4"):
        runs[f"ZeRO {mesh}"] = cuda_run(T, f"ZeRO {mesh}", zero, mesh)
    runs["FSDP 4"] = cuda_run(T, "FSDP 4", config)
    peaks = torch.tensor([runs[k]["peak"] for k in runs], device=basics.device())
    every = [torch.empty_like(peaks) for _ in range(n)]
    dist.all_gather(every, peaks)
    flat = runs["flat DP"]
    ref = torch.cat([(flat["params"][k] - init[k]).reshape(-1) for k in init])
    errs = {}
    for label, run in runs.items():
        upd = torch.cat([(run["params"][k] - init[k]).reshape(-1) for k in init])
        errs[label] = ((upd - ref).norm() / ref.norm()).item()
    if rank == 0:
        for i, (label, run) in enumerate(runs.items()):
            print(f"{label}: losses {run['losses']}, median step "
                  f"{run['ms']:.2f} ms (steps 1-2), peak memory per rank "
                  f"{[round(float(e[i]), 3) for e in every]} GB, "
                  f"{'leaves' if label.startswith('FSDP') else 'buckets'} "
                  f"{run['buckets']}, collectives of step 1 {run['counts']}, "
                  f"all updates vs flat DP {errs[label]:.3e} relative norm "
                  f"(limit {CUDA_LIMIT:g})")
    bad = {k: e for k, e in errs.items() if not (e <= CUDA_LIMIT)}
    for label in ("ZeRO 2x2", "ZeRO 1x4"):
        b = runs[label]["buckets"]
        want = {"reduce_scatter_tensor": b, "all_gather_into_tensor": b,
                "all_reduce": b if label == "ZeRO 2x2" else 0}
        got = {k: runs[label]["counts"].get(k, 0) for k in want}
        if got != want:
            bad[f"{label} collectives"] = (got, want)
    if bad:
        raise AssertionError(f"sharded world: {bad}")
    if rank == 0:
        print(f"ok sharded world {n}")


def main() -> None:
    torch.set_num_threads(1)
    mode = os.environ["SHARDED_MODE"]
    hvd.init(device="cuda" if mode == "cuda" else "cpu")
    try:
        run_cuda() if mode == "cuda" else run_cpu()
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
