"""One rank of the tensor- and expert-parallel worlds that
tests/test_torch_port_tensor.py, tests/test_torch_port_moe.py (gloo, on
the CPU) and tests/test_torch_port_cuda.py (NCCL, one process per GPU)
launch. It imports no JAX: the CPU tests compute the JAX package's side
and hand the inputs over in an .npz file (``TP_IN``); each rank writes its
results to ``TP_OUT.<rank>.npz``. ``TP_MODE`` picks the world:

``tp`` (4 ranks): at model sizes 1, 2 and 4 (``sharded_groups(4 / m, 1,
m)``), one column/row pair forward on integer-valued payloads, the
gradients of one pair and of a chain of two, generic floats through tanh,
the naive control (``torch.distributed.nn.functional.all_reduce``, whose
backward is another allreduce) and the collectives a pair stack issues;
5 Adam steps of the reference tests' two pairs through
``DistributedOptimizer(sharded=True)`` at 2x2x1 and at 2x2; then the
small TransformerLM at tp = 4 (``tp_state_dict`` of the full weights),
its loss, logits and local gradients, per case; and 5 SGD steps of it at
tp = 2 with data parallelism over the batch groups (2x1x2):
``broadcast_parameters`` and ``DistributedOptimizer`` with ``group=``.

``cube`` (8 ranks): 5 steps of the two pairs on the 2x2x2
``('batch','shard','model')`` cube, ``tp_apply`` over the model group and
the ZeRO exchange over each model group's ``('batch','shard')`` groups.

``ep`` (4 ranks): ``moe_apply`` over the world per case (this rank's
tokens and experts): the output and the gradients of ``mean(out ** 2)``;
the expert-sharded ``MoEMLP`` and the expert-sharded TransformerLM on
replicated tokens (``ep_state_dict`` of the full weights): outputs, the
load-balancing loss and the local gradients.

``cuda`` (4 GPUs): the full-width flash TransformerLM at tp = 4 (bf16)
against the one-rank flat model, the full-width MoE TransformerLM at ep =
4 against the unsharded one (float32: see run_cuda), and ``moe_apply`` at
ep = 4 against ep = 1 on each rank's tokens (bf16); every loss within 1e-2
relative and every gradient or output within 3e-2 relative norm (the chip
tests' bf16 limits); rank 0 prints the step times, peaks and ``ok tp
world <n>``.

Every rank exits non-zero on any failure. Identity and rendezvous come
from the launcher's ``HOROVOD_*`` variables.
"""

import dataclasses
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
from horovod_tpu_torch.convert import jax_ordered  # noqa: E402
from horovod_tpu_torch.models.moe import MoEMLP, ep_state_dict  # noqa: E402
from horovod_tpu_torch.models.transformer import (  # noqa: E402
    TransformerLM, lm_loss, tp_state_dict)
from horovod_tpu_torch.ops.moe import MoEParams, moe_apply  # noqa: E402
from horovod_tpu_torch.parallel import sharded as sh  # noqa: E402
from horovod_tpu_torch.parallel import tensor as tp  # noqa: E402
from horovod_tpu_torch.parallel.mesh import sharded_groups  # noqa: E402

PAIR_KEYS = ("b_col", "b_row", "w_col", "w_row")     # JAX's flatten order
MODEL_SIZES = (1, 2, 4)
THRESHOLD, NUM_BUCKETS, LR, STEPS = 1 << 20, 2, 1e-2, 5
AUX = 0.01
CUDA_LOSS, CUDA_GRAD = 1e-2, 3e-2


def _t(data, key, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(data[key]))
    return t if dtype is None else t.to(dtype)


def _pairs(data, prefix: str) -> list:
    n = int(data[f"{prefix}/n"])
    return [{k: _t(data, f"{prefix}/{i}/{k}") for k in PAIR_KEYS
             if f"{prefix}/{i}/{k}" in data} for i in range(n)]


def _local(pairs, m: int, r: int) -> list:
    return [{k: v.clone().requires_grad_(True) for k, v in p.items()}
            for p in tp.tp_rank_pairs(pairs, m, r)]


def _grads(res, key, local) -> None:
    for i, p in enumerate(local):
        for k, v in p.items():
            res[f"{key}/{i}/{k}"] = v.grad.numpy()


class CountAllReduce:
    """Count ``torch.distributed.all_reduce`` calls inside the ``with``."""

    def __enter__(self):
        self.n, self.saved = 0, dist.all_reduce

        def counted(*args, **kwargs):
            self.n += 1
            return self.saved(*args, **kwargs)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self.saved


def naive_pair(lp, x, group):
    """The pair with autograd's own allreduce, whose backward is another
    allreduce: JAX's default psum transpose."""
    from torch.distributed.nn.functional import all_reduce

    h = x @ lp["w_col"] + lp["b_col"]
    return all_reduce(h @ lp["w_row"], group=group) + lp["b_row"]


def pair_cases(data, res, layout) -> None:
    m, r, g = layout.model_size, layout.model_rank, layout.model_group
    fwd = _pairs(data, "int_fwd")
    res[f"fwd/{m}"] = tp.tp_pair_apply(tp.tp_rank_pairs(fwd, m, r)[0],
                                       _t(data, "int_fwd/x"), g,
                                       activation=None).numpy()
    for name in ("int_bwd", "chain") if m <= 2 else ("int_bwd",):
        # (the chain's first hidden dim, 6, does not cut in 4)
        local = _local(_pairs(data, name), m, r)
        tp.tp_apply(local, _t(data, f"{name}/x"), g, activation=None).sum().backward()
        _grads(res, f"{name}/{m}", local)
    res[f"generic/{m}"] = tp.tp_apply(
        tp.tp_rank_pairs(_pairs(data, "generic"), m, r),
        _t(data, "generic/x"), g).numpy()
    local = _local(_pairs(data, "int_bwd"), m, r)[0]
    naive_pair(local, _t(data, "int_bwd/x"), g).sum().backward()
    res[f"naive/{m}/w_col"] = local["w_col"].grad.numpy()
    local = _local(_pairs(data, "train"), m, r)
    with CountAllReduce() as count:
        x = _t(data, "train/x").requires_grad_(True)
        tp.tp_apply(local, x, g).sum().backward()
    res[f"allreduces/{m}"] = np.array(count.n)


def _leaves(pairs) -> list:
    return [p[k] for p in pairs for k in PAIR_KEYS if k in p]


def train_pairs(layout, local_pairs, x, y, model_named: bool) -> tuple:
    """STEPS Adam steps of ``local_pairs`` through
    ``DistributedOptimizer(sharded=True)`` on ``layout``; the loss is
    ``mean((apply - y)**2)``, ``tp_apply`` over the model group where the
    layout names the model axis, else ``dense_apply`` (the 2-D plan).
    Returns (the rows after the last step, the local leaves)."""
    params = [torch.nn.Parameter(t.clone()) for t in _leaves(local_pairs)]
    it = iter(params)
    pairs = [{k: next(it) for k in PAIR_KEYS if k in p} for p in local_pairs]
    plan = sh.build_shard_plan(params, layout.shard_size, THRESHOLD, NUM_BUCKETS,
                               model_size=layout.model_size if model_named else 1)
    rows = sh.shard_params(params, plan, layout.shard_rank)
    names = [f"{i}.{k}" for i, p in enumerate(pairs) for k in PAIR_KEYS if k in p]
    opt = hvd.DistributedOptimizer(torch.optim.Adam(list(rows), lr=LR, foreach=True),
                                   list(zip(names, params)), sharded=True,
                                   shard_plan=plan, layout=layout)
    for _ in range(STEPS):
        opt.zero_grad()
        sh.gather_params(rows, plan, layout, params)
        out = tp.tp_apply(pairs, x, layout.model_group) if model_named \
            else tp.dense_apply(pairs, x)
        ((out - y) ** 2).mean().backward()
        opt.step()
    sh.gather_params(rows, plan, layout, params)
    return [r.detach().clone() for r in rows], [p.detach() for p in params]


def _data_rows(data, layout):
    d = layout.batch_rank * layout.shard_size + layout.shard_rank
    n = layout.batch_size * layout.shard_size
    x, y = _t(data, "train/x"), _t(data, "train/y")
    per = x.shape[0] // n
    return x[d * per:(d + 1) * per], y[d * per:(d + 1) * per]


def lm_cases(data, res, group, rank, m) -> None:
    for case in json.loads(str(data["lm_cases"])):
        name = case.pop("name")
        full = {k.split("/", 2)[2]: _t(data, k) for k in data.files
                if k.startswith(f"lm/{name}/")}
        model = TransformerLM(**case, dtype=torch.float32, tp_group=group)
        model.load_state_dict(tp_state_dict(full, m, rank))
        tokens = _t(data, "lm_tokens")
        logits = model(tokens)
        loss = lm_loss(logits, tokens)
        loss.backward()
        res[f"lm/{name}/loss"] = loss.detach().numpy()
        res[f"lm/{name}/logits"] = logits.detach().numpy()
        for n, p in model.named_parameters():
            res[f"lm/{name}/grad/{n}"] = p.grad.numpy()


def run_tp(data, rank) -> dict:
    res = {}
    for m in MODEL_SIZES:
        pair_cases(data, res, sharded_groups(4 // m, 1, m))
    pairs = _pairs(data, "train")
    for label, (b, s, m) in (("3d", (2, 2, 1)), ("2d", (2, 2, None))):
        layout = sharded_groups(b, s, m)
        x, y = _data_rows(data, layout)
        local = tp.tp_rank_pairs(pairs, 1, 0)
        rows, _ = train_pairs(layout, local, x, y, m is not None)
        for i, row in enumerate(rows):
            res[f"model1/{label}/row{i}"] = row.numpy()
    layout = sharded_groups(1, 1, 4)
    lm_cases(data, res, layout.model_group, layout.model_rank, 4)
    built(res, tp_group=layout.model_group)
    dp_tp_steps(data, res, sharded_groups(2, 1, 2))
    return res


def built(res, **group) -> None:
    """This rank's state of ``train.build_model`` over a group: its slices
    of the whole model drawn from the config's seed."""
    from horovod_tpu_torch import train as T

    config = T.TrainConfig(vocab=64, dim=64, heads=4, layers=2, seq=16,
                           dtype="float32")
    model = T.build_model(config, "cpu", moe_experts=4, **group)
    for n, t in model.state_dict().items():
        res[f"built/{n}"] = t.numpy()


def dp_tp_steps(data, res, layout) -> None:
    """STEPS SGD steps of the small TransformerLM at tp = 2 with data
    parallelism over the batch group of 2: ``broadcast_parameters`` and
    the flat ``DistributedOptimizer`` over ``layout.batch_group``; batch
    rank b trains on rows 2b, 2b+1 of ``dp_tokens``. The parameters are
    perturbed on every rank but batch rank 0 first, so the broadcast over
    the batch group is what makes the replicas one."""
    case = json.loads(str(data["lm_cases"]))[0]
    name = case.pop("name")
    full = {k.split("/", 2)[2]: _t(data, k) for k in data.files
            if k.startswith(f"lm/{name}/")}
    model = TransformerLM(**case, dtype=torch.float32, tp_group=layout.model_group)
    model.load_state_dict(tp_state_dict(full, layout.model_size, layout.model_rank))
    named = jax_ordered(model.named_parameters())
    if layout.batch_rank:
        with torch.no_grad():
            for _, p in named:
                p.add_(1.0)
    hvd.broadcast_parameters(named, 0, group=layout.batch_group)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, foreach=True), named,
        sharded=False, group=layout.batch_group)
    tokens = _t(data, "dp_tokens")[2 * layout.batch_rank:2 * layout.batch_rank + 2]
    for _ in range(STEPS):
        opt.zero_grad()
        lm_loss(model(tokens), tokens).backward()
        opt.step()
    for n, p in model.named_parameters():
        res[f"dptp/{n}"] = p.detach().numpy()
    res["dptp/coords"] = np.array([layout.batch_rank, layout.model_rank])


def run_cube(data, rank) -> dict:
    layout = sharded_groups(2, 2, 2)
    x, y = _data_rows(data, layout)
    local = tp.tp_rank_pairs(_pairs(data, "train"), 2, layout.model_rank)
    _, leaves = train_pairs(layout, local, x, y, True)
    names = [f"{i}.{k}" for i, p in enumerate(local) for k in PAIR_KEYS if k in p]
    res = {f"cube/{n}": t.numpy() for n, t in zip(names, leaves)}
    res["coords"] = np.array([layout.batch_rank, layout.shard_rank,
                              layout.model_rank])
    return res


def run_ep(data, rank) -> dict:
    res = {}
    n = dist.get_world_size()
    for case in json.loads(str(data["ep_cases"])):
        name, cap = case["name"], case["capacity"]
        gate = _t(data, f"ep/{name}/gate").requires_grad_(True)
        w_in, w_out = (_t(data, f"ep/{name}/{k}").chunk(n)[rank].clone()
                       .requires_grad_(True) for k in ("w_in", "w_out"))
        x = _t(data, f"ep/{name}/x").chunk(n)[rank].clone().requires_grad_(True)
        out = moe_apply(MoEParams(gate, w_in, w_out), x, cap, dist.group.WORLD)
        (out ** 2).mean().backward()
        res[f"ep/{name}/out"] = out.detach().numpy()
        for k, t in (("gate", gate), ("w_in", w_in), ("w_out", w_out), ("x", x)):
            res[f"ep/{name}/grad/{k}"] = t.grad.numpy()

    try:
        MoEMLP(16, 32, 6, ep_group=dist.group.WORLD)
        res["moe/indivisible_raises"] = np.array(False)
    except ValueError as e:
        res["moe/indivisible_raises"] = np.array("not divisible by ep=4" in str(e))
    cfg = json.loads(str(data["moe_cfg"]))
    for ep_group, tag in ((dist.group.WORLD, "ep"), (None, "whole")):
        moe = MoEMLP(**cfg, dtype=torch.float32, ep_group=ep_group)
        full = {k: _t(data, f"moe/{k}") for k in ("gate", "w_in", "w_out")}
        moe.load_state_dict(full if ep_group is None else ep_state_dict(full, n, rank))
        x = _t(data, "moe/x").requires_grad_(True)
        out = moe(x)
        (out.square().mean() + AUX * moe.lb_loss).backward()
        res[f"moe/{tag}/out"] = out.detach().numpy()
        res[f"moe/{tag}/lb"] = moe.lb_loss.detach().numpy()
        res[f"moe/{tag}/grad/x"] = x.grad.numpy()
        for k, p in moe.named_parameters():
            res[f"moe/{tag}/grad/{k}"] = p.grad.numpy()

    built(res, ep_group=dist.group.WORLD)
    for case in json.loads(str(data["eplm_cases"])):
        name = case.pop("name")
        full = {k.split("/", 2)[2]: _t(data, k) for k in data.files
                if k.startswith(f"eplm/{name}/")}
        model = TransformerLM(**case, dtype=torch.float32, ep_group=dist.group.WORLD)
        model.load_state_dict(ep_state_dict(full, n, rank))
        tokens = _t(data, f"eplm_tokens/{name}")
        logits = model(tokens)
        lb = model.moe_lb_loss()
        loss = lm_loss(logits, tokens) + AUX * lb
        loss.backward()
        res[f"eplm/{name}/logits"] = logits.detach().numpy()
        res[f"eplm/{name}/loss"] = loss.detach().numpy()
        res[f"eplm/{name}/lb"] = lb.detach().numpy()
        for k, p in model.named_parameters():
            res[f"eplm/{name}/grad/{k}"] = p.grad.numpy()
    return res


def run_cpu() -> None:
    rank = hvd.rank()
    data = np.load(os.environ["TP_IN"])
    mode = os.environ["TP_MODE"]
    res = {"tp": run_tp, "cube": run_cube, "ep": run_ep}[mode](data, rank)
    np.savez(f"{os.environ['TP_OUT']}.{rank}.npz", **res)


# ---------------------------------------------------------------- the cards

def relnorm(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def gather_full(local: dict, merge, n: int) -> dict:
    """Every rank's local tensors (by name) gathered and merged."""
    every = [None] * n
    dist.all_gather_object(every, {k: v.cpu() for k, v in local.items()})
    return merge(every)


def timed_steps(fn, steps: int = 3) -> float:
    """Median ms of steps 1.. of ``steps`` calls of ``fn``."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def lm_step(model, tokens, moe: bool):
    model.zero_grad(set_to_none=True)
    loss = lm_loss(model(tokens), tokens)
    if moe:
        loss = loss + AUX * model.moe_lb_loss()
    loss.backward()
    return loss.detach()


def hold(label, loss, want_loss, grads, want_grads, bad, lines) -> None:
    lerr = abs(loss - want_loss) / abs(want_loss)
    gerr = max((relnorm(grads[k], want_grads[k]), k) for k in want_grads)
    lines.append(f"{label}: loss {loss:.6f} vs {want_loss:.6f} ({lerr:.3e}, limit "
                 f"{CUDA_LOSS:g}); worst gradient {gerr[0]:.3e} ({gerr[1]}, limit "
                 f"{CUDA_GRAD:g})")
    if not (lerr <= CUDA_LOSS and gerr[0] <= CUDA_GRAD):
        bad.append(lines[-1])


def run_cuda() -> None:
    from horovod_tpu_torch import train as T
    from horovod_tpu_torch.models.moe import ep_merge_state_dicts
    from horovod_tpu_torch.models.transformer import tp_merge_state_dicts

    torch.backends.cuda.matmul.allow_tf32 = False
    n, rank, dev = hvd.size(), hvd.rank(), basics.device()
    if n != 4:
        raise RuntimeError(f"the tp world needs 4 GPUs, got {n}")
    world = dist.group.WORLD
    config = T.TrainConfig()
    tokens = T.make_batch(config, 0, dev)
    bad, lines = [], []

    # The MoE model is compared in float32: in bf16 a token whose two best
    # gate logits lie within rounding may route otherwise in the two runs,
    # which moves which tokens each expert keeps (chip_smoke phase 18).
    for label, cfg, kw, group_kw, merge in (
            ("tp=4", config, {}, "tp_group", tp_merge_state_dicts),
            ("ep=4 MoE, float32", dataclasses.replace(config, dtype="float32"),
             {"moe_experts": 8, "moe_every": 2}, "ep_group",
             ep_merge_state_dicts)):
        moe = bool(kw)
        flat = T.build_model(cfg, dev, **kw)
        ms_flat = timed_steps(lambda: lm_step(flat, tokens, moe))
        want_loss = lm_step(flat, tokens, moe).item()
        want = {k: p.grad.cpu() for k, p in flat.named_parameters()}
        del flat
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = T.build_model(cfg, dev, **kw, **{group_kw: world})
        ms = timed_steps(lambda: lm_step(model, tokens, moe))
        loss = lm_step(model, tokens, moe).item()
        grads = gather_full({k: p.grad for k, p in model.named_parameters()},
                            merge, n)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        hold(label, loss, want_loss, grads, want, bad, lines)
        lines.append(f"{label}: step {ms:.2f} ms against {ms_flat:.2f} ms on one "
                     f"rank alone (median of steps 1-2 of 3), peak {peak:.3f} GB "
                     f"on rank {rank}")
        del model, grads, want
        torch.cuda.empty_cache()

    d, hidden, experts, t_rank = 1024, 4096, 8, 4096
    gen = torch.Generator(device=dev).manual_seed(3)
    gate = torch.randn(d, experts, generator=gen, device=dev) / d ** 0.5
    w_in = torch.randn(experts, d, hidden, generator=gen, device=dev) / d ** 0.5
    w_out = torch.randn(experts, hidden, d, generator=gen, device=dev) / hidden ** 0.5
    x = torch.randn(n * t_rank, d, generator=gen, device=dev).to(torch.bfloat16)
    x = x.chunk(n)[rank].contiguous()
    cap = int(1.25 * t_rank / experts)
    per = experts // n
    params = MoEParams(gate.to(torch.bfloat16), w_in[rank * per:(rank + 1) * per]
                       .to(torch.bfloat16), w_out[rank * per:(rank + 1) * per]
                       .to(torch.bfloat16))
    whole = MoEParams(gate.to(torch.bfloat16), w_in.to(torch.bfloat16),
                      w_out.to(torch.bfloat16))
    ms = timed_steps(lambda: moe_apply(params, x, cap, world))
    ms_whole = timed_steps(lambda: moe_apply(whole, x, cap))
    got, want = moe_apply(params, x, cap, world), moe_apply(whole, x, cap)
    err = relnorm(got, want)
    lines.append(f"moe_apply ep=4 (dim {d}, hidden {hidden}, {experts} experts, "
                 f"{t_rank} tokens a rank, capacity {cap}): {ms:.3f} ms against "
                 f"{ms_whole:.3f} ms at ep=1 with every expert; output vs ep=1 "
                 f"{err:.3e} relative norm (limit {CUDA_GRAD:g})")
    if not err <= CUDA_GRAD:
        bad.append(lines[-1])
    if rank == 0:
        cards = os.popen("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader").read()
        print(f"cards (name, power limit):\n{cards}" + "\n".join(lines))
    if bad:
        raise AssertionError(f"tp world: {bad}")
    if rank == 0:
        print(f"ok tp world {n}")


def main() -> None:
    torch.set_num_threads(1)
    mode = os.environ["TP_MODE"]
    hvd.init(device="cuda" if mode == "cuda" else "cpu")
    try:
        run_cuda() if mode == "cuda" else run_cpu()
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
