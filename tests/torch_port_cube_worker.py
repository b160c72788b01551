"""One rank of the ``('batch', 'shard', 'model')`` cube worlds that
tests/test_torch_port_cube.py (gloo, on the CPU) and
tests/test_torch_port_cuda.py (NCCL, one process per GPU) launch. It
imports no JAX: the CPU test computes the JAX package's side from the
parameters and losses each rank writes to ``CUBE_OUT.<rank>.npz``.
``CUBE_MODE`` picks the world:

``cpu`` (4 ranks): ``train.setup`` of a small float32 TransformerLM
(``SMALL``) at every layout of ``CASES``, from ``HOROVOD_MESH`` or
``layout=sharded_groups(b, s, m)``, flat or ZeRO, 3 steps on the batch of
the rank's data index: the losses, the parameters after the last step
(ZeRO's gathered first), the rank's mesh coordinates and data index and
``tokens_per_step``; ``train(layout=sharded_groups(2, 1, 2))``'s losses
(averaged over the world). Then ``TuneStepFactory(graphed=False)`` under
``tune`` over ``TUNE_MESHES`` (one record per candidate), and the
refusals: a shard size above 1 under a model axis without ZeRO, and a
checkpoint in a world that holds a tensor-parallel model
(``checkpoint.save`` of a state dict and of a host copy of it,
``host_copy``, ``save`` of a ZeRO optimizer, ``save_sharded``).

``cuda`` (4 GPUs): the full-width flash TransformerLM through ``setup``
at ``CUDA_RUNS`` (1x1x4, 2x1x2, ZeRO 1x2x2, 1x1x4 with the chunked loss
and 1x1x4 with ``kv_heads = 2``, each in float32 and in bf16), each
graphed (``steps_per_dispatch = GRAPH_K``, ``GRAPH_DISPATCHES``
dispatches) against four-rank flat data parallelism (with the same
``kv_heads`` and dtype), graphed too, on the same global batch: every rank
keeps a ``DeviceCache`` of the same global rows and each step takes its
data index's share of the global batch of ``GLOBAL_BATCH`` sequences. The
model group's slices are put together by ``tp_merge_state_dicts``. In
float32 each step's loss (averaged over the world) is held to flat's
within ``F32_LOSS`` relative and the updates of all parameters together
within ``F32_GRAD`` relative norm; in bf16 the loss within
``CUDA_LOSS`` and the updates' distance from the float32 flat run's to
``BF16_VS_F32`` times bf16 flat DP's; 1x1x4 with
``remat`` (the recompute and its model-group allreduces inside the graph)
is held to 1x1x4 within ``REMAT_LOSS`` and ``REMAT_GRAD``. Every rank's
parameter count must be the analytic one, and its B1-B3 launches those of
the warm-up and the capture (``WARMUP_STEPS + 1`` steps of ``layers``;
none on a replay). Rank 0 prints the step ms, tokens/s, every rank's peak
memory, parameter count and launches, and ``ok cube world <n>``.
"""

import dataclasses
import json
import os
import statistics
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import checkpoint  # noqa: E402
from horovod_tpu_torch import train as T  # noqa: E402
from horovod_tpu_torch.common import basics  # noqa: E402
from horovod_tpu_torch.loop import WARMUP_STEPS  # noqa: E402
from horovod_tpu_torch.parallel import sharded as sh  # noqa: E402
from horovod_tpu_torch.parallel.mesh import sharded_groups  # noqa: E402

SMALL = dict(vocab=64, dim=64, heads=4, layers=2, seq=16, dtype="float32")
STEPS = 3
# (name, HOROVOD_MESH spec or sharded_groups sizes (None: neither), ZeRO,
# config overrides)
CASES = (
    ("flat", None, False, {}),
    ("4x1x1", "4x1x1", False, {}),
    ("1x1x4", "1x1x4", False, {}),
    ("1x1x4 kv2", (1, 1, 4), False, {"kv_heads": 2}),
    ("1x1x4 kv1", (1, 1, 4), False, {"kv_heads": 1}),
    ("2x1x2", "2x1x2", False, {}),
    ("1x2x2 zero", (1, 2, 2), True, {}),
    ("2x1x2 chunk", (2, 1, 2), False, {"loss_chunk": 8}),
    ("2x1x2 remat", (2, 1, 2), False, {"remat": True}),
    ("2x2 zero", "2x2", True, {}),
    ("2x2x1 zero", "2x2x1", True, {}),
)
TUNE_MESHES = ("4x1", "4x1x1", "2x1x2", "1x1x4")

GRAPH_K, GRAPH_DISPATCHES = 4, 2
GLOBAL_BATCH = 4
CHUNK = 1024
# (label, sharded_groups sizes (None: flat DP), ZeRO, config overrides,
# the run it is held to). The float32 runs come first: every bf16 run's
# updates are also read against its float32 flat run's.
F32 = {"dtype": "float32"}
CUDA_RUNS = (
    ("flat DP 4, float32", None, False, F32, None),
    ("1x1x4, float32", (1, 1, 4), False, F32, "flat DP 4, float32"),
    ("2x1x2, float32", (2, 1, 2), False, F32, "flat DP 4, float32"),
    ("ZeRO 1x2x2, float32", (1, 2, 2), True, F32, "flat DP 4, float32"),
    (f"1x1x4, chunk {CHUNK}, float32", (1, 1, 4), False,
     {**F32, "loss_chunk": CHUNK}, "flat DP 4, float32"),
    ("flat DP 4, kv_heads 2, float32", None, False, {**F32, "kv_heads": 2}, None),
    ("1x1x4, kv_heads 2, float32", (1, 1, 4), False, {**F32, "kv_heads": 2},
     "flat DP 4, kv_heads 2, float32"),
    ("flat DP 4", None, False, {}, None),
    ("1x1x4", (1, 1, 4), False, {}, "flat DP 4"),
    ("1x1x4, remat", (1, 1, 4), False, {"remat": True}, "1x1x4"),
    ("2x1x2", (2, 1, 2), False, {}, "flat DP 4"),
    ("ZeRO 1x2x2", (1, 2, 2), True, {}, "flat DP 4"),
    (f"1x1x4, chunk {CHUNK}", (1, 1, 4), False, {"loss_chunk": CHUNK}, "flat DP 4"),
    ("flat DP 4, kv_heads 2", None, False, {"kv_heads": 2}, None),
    ("1x1x4, kv_heads 2", (1, 1, 4), False, {"kv_heads": 2}, "flat DP 4, kv_heads 2"),
)
# Held in float32, where the cube and flat DP differ only in the order of
# float32 sums: every step's loss to F32_LOSS relative and the updates of
# all parameters together to F32_GRAD relative norm. The parameters'
# elementwise differences are printed, not held: tests/test_torch_port_
# train.py's rule (at most 1e-3 of a tensor's elements past 2e-6) read
# 1.66e-3 to 1.81e-3 here after 8 full-width steps while the updates read
# 5.9e-5 to 6.4e-5 (four H100 cards), Adam turning gradients within
# float32 noise of 0 into whole steps. In bf16 a partial product rounds to
# bf16 before the model group's sum and every update rounds to a bf16
# parameter (one bf16 unit of a weight of 0.02 is 1.2e-4, an Adam step at
# lr 1e-3 is 1e-3), so two correct runs' updates differ by several
# percent (a four-card run read 5.4e-2 to 5.6e-2 between the cube and flat
# DP). There the loss is held to CUDA_LOSS relative, and the updates, by
# relative norm against the float32 flat run's, to BF16_VS_F32 times bf16
# flat DP's own distance from it: the cube may round no worse than flat DP
# (a CPU run at dim 64 read ratios 1.003 to 1.043). A scratch copy whose
# kv_proj output skipped copy_to_model read 0.56 on both update rules at
# dim 64 on the CPU, and its bf16 loss passed 1e-2. Remat against the
# same layout without it: REMAT_LOSS and REMAT_GRAD (the recompute runs
# the same kernels on the same values).
F32_LOSS, F32_GRAD = 1e-5, 1e-4
CUDA_LOSS, BF16_VS_F32 = 1e-2, 1.5
REMAT_LOSS, REMAT_GRAD = 1e-5, 1e-4


def build(config, where, sharded: bool):
    """``setup`` of ``config`` on ``where``: a HOROVOD_MESH spec, a
    ``sharded_groups`` shape or None."""
    config = dataclasses.replace(config, sharded=sharded)
    if isinstance(where, str):
        os.environ["HOROVOD_MESH"] = where
        try:
            return T.setup(config)
        finally:
            os.environ.pop("HOROVOD_MESH", None)
    layout = None if where is None else sharded_groups(*where)
    return T.setup(config, layout=layout)


def params_of(s) -> dict:
    """This rank's parameters on the host; ZeRO's refreshed from the rows."""
    if s.opt.sharded:
        sh.gather_params(s.opt.rows, s.opt.shard_plan, s.opt.layout, s.opt.params)
    return {n: p.detach().cpu().clone() for n, p in s.model.named_parameters()}


def coords(s) -> list:
    lay = s.layout
    return [0, 0, 0] if lay is None else [lay.batch_rank, lay.shard_rank,
                                          lay.model_rank]


def refusal(fn) -> str:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def run_cpu(res: dict) -> None:
    from horovod_tpu_torch import autotune

    base = T.TrainConfig(**SMALL)
    for name, where, sharded, kw in CASES:
        config = dataclasses.replace(base, **kw)
        s = build(config, where, sharded)
        tokens = T.make_batch(config, s.data_index, "cpu")
        res[f"{name}/loss"] = np.array([s.step(tokens).item() for _ in range(STEPS)])
        for n, t in params_of(s).items():
            res[f"{name}/p/{n}"] = t.numpy()
        res[f"{name}/coords"] = np.array(coords(s) + [s.data_index,
                                                      s.tokens_per_step])
        if name == "1x1x4":
            state = s.model.state_dict()
            copy = {k: v.cpu().clone() for k, v in state.items()}
            res["refuse/save"] = np.array(refusal(
                lambda: checkpoint.save(tempfile.mkdtemp(), {"model": state})))
            res["refuse/save_copy"] = np.array(refusal(
                lambda: checkpoint.save(tempfile.mkdtemp(), {"model": copy})))
            res["refuse/host_copy"] = np.array(refusal(
                lambda: checkpoint.host_copy({"model": copy})))
        if name == "1x2x2 zero":
            res["refuse/save_opt"] = np.array(refusal(
                lambda: checkpoint.save(tempfile.mkdtemp(), {"opt": s.opt})))
            res["refuse/save_sharded"] = np.array(refusal(
                lambda: checkpoint.save_sharded(tempfile.mkdtemp(), {"rows": s.opt.rows},
                                                s.opt.shard_plan, layout=s.layout)))
        del s
    res["refuse/flat_shard"] = np.array(refusal(lambda: build(base, (1, 2, 2), False)))
    res["train 2x1x2/loss"] = np.array(
        T.train(base, STEPS, "cpu", layout=sharded_groups(2, 1, 2)).losses)

    factory = T.TuneStepFactory(dataclasses.replace(base, steps_per_dispatch=2),
                                "cpu", graphed=False)
    autotune.tune(factory, thresholds=(1 << 20,), mesh_shapes=TUNE_MESHES,
                  warmup=1, iters=1, reps=1, gp_rounds=0)
    factory.close()
    res["tune"] = np.array(json.dumps([
        {k: r[k] for k in ("mesh_shape", "model_size", "losses", "graphed")}
        for r in factory.records]))


# ---------------------------------------------------------------- the cards

def relnorm(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def whole_state(s, kv_heads) -> dict:
    """The whole model's parameters on the host: the model group's slices
    gathered and put together."""
    from horovod_tpu_torch.models.transformer import tp_merge_state_dicts

    mine = params_of(s)
    if s.layout is None or s.layout.model_size == 1:
        return mine
    every = [None] * s.layout.model_size
    dist.all_gather_object(every, mine, group=s.layout.model_group)
    return tp_merge_state_dicts(every, kv_heads=kv_heads)


def cuda_run(base, where, sharded, overrides, dev, global_rows) -> dict:
    from torch_port_graphed import graphed_run

    n = hvd.size()
    layout = None if where is None else sharded_groups(*where)
    data_ranks = n if layout is None else n // layout.model_size
    per = GLOBAL_BATCH // data_ranks
    config = dataclasses.replace(base, batch=per, steps_per_dispatch=GRAPH_K,
                                 sharded=sharded, **overrides)
    box = {}

    def build_run():
        s = T.setup(config, layout=layout)
        lo = s.data_index * per
        cache = basics_cache(global_rows, dev)

        def step(x, y):
            return s.step(x[lo:lo + per], y[lo:lo + per])

        box["s"] = s
        return step, cache, s.opt, lambda: whole_state(s, config.kv_heads), {}

    from chip_smoke import read_counts
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import ring_flash as rf

    read_counts(fa, rf)
    run = graphed_run(build_run, True)
    launches = read_counts(fa, rf)
    s = box.pop("s")
    losses = torch.tensor(run["losses"], dtype=torch.float64, device=dev)
    dist.all_reduce(losses)
    count = sum(p.numel() for p in s.model.parameters())
    out = {"losses": (losses / n).tolist(), "state": run["state"],
           "ms": statistics.median(run["ms"]), "peak": run["peak"],
           "params": count, "tokens": s.tokens_per_step,
           "capture": run["capture"], "replay": run["replay"],
           "launches": launches, "config": config,
           "tp": 1 if layout is None else layout.model_size}
    s.opt.remove_hooks()
    del s
    return out


def basics_cache(global_rows, dev):
    from horovod_tpu_torch.data import DeviceCache
    from horovod_tpu_torch.models.transformer import next_tokens

    return DeviceCache(global_rows, next_tokens(global_rows), batch_size=GLOBAL_BATCH,
                       seed=0, device=dev)


def analytic_params(config, tp: int) -> int:
    """One model rank's parameter count: the embedding, the norms and a
    whole ``kv_proj`` (``kv_heads < tp``) replicated, the rest cut into
    tp."""
    d, v, layers = config.dim, config.vocab, config.layers
    kvh = config.kv_heads or config.heads
    kv = 2 * kvh * (d // config.heads) * d
    whole = kv if kvh % tp else 0
    cut = 2 * d * d + 2 * config.mlp_ratio * d * d + kv - whole
    return v * d + (2 * layers + 1) * d + layers * whole + \
        (layers * cut + v * d) // tp


def updates(r: dict, init: dict) -> torch.Tensor:
    """A run's updates of all parameters together, in name order."""
    return torch.cat([(r["state"][k].double() - init[k].double()).reshape(-1)
                      for k in sorted(r["state"])])


def held(label: str, r: dict, ref: str, other: dict, inits: dict,
         truth: dict) -> tuple:
    """``r`` against the run it is held to: the line and whether it holds."""
    cfg = r["config"]
    init = inits[(cfg.kv_heads, cfg.dtype)]
    lerr = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], other["losses"]))
    uerr = relnorm(updates(r, init), updates(other, init))
    line = f"{label} vs {ref}: loss {lerr:.3e} relative"
    if cfg.remat:
        ok = lerr <= REMAT_LOSS and uerr <= REMAT_GRAD
        return (f"{line} (limit {REMAT_LOSS:g}), updates {uerr:.3e} relative "
                f"norm (limit {REMAT_GRAD:g})", ok)
    if cfg.dtype == "float32":
        worst, share = (0.0, ""), (0.0, "")
        for k, t in r["state"].items():
            diff = (t.double() - other["state"][k].double()).abs()
            worst = max(worst, (diff.max().item(), k))
            share = max(share, ((diff > 2e-6).double().mean().item(), k))
        ok = lerr <= F32_LOSS and uerr <= F32_GRAD
        return (f"{line} (limit {F32_LOSS:g}), updates {uerr:.3e} relative norm "
                f"(limit {F32_GRAD:g}); parameters, not held: largest difference "
                f"{worst[0]:.3e} ({worst[1]}), largest share of a tensor's "
                f"elements past 2e-6 {share[0]:.3e} ({share[1]})", ok)
    f32 = truth[cfg.kv_heads]
    f32_init = inits[(cfg.kv_heads, "float32")]
    against = {lab: relnorm(updates(x, inits[(cfg.kv_heads, cfg.dtype)]),
                            updates(f32, f32_init)) for lab, x in
               (("this run", r), (ref, other))}
    limit = BF16_VS_F32 * against[ref]
    return (f"{line} (limit {CUDA_LOSS:g}); updates {uerr:.3e} relative norm "
            f"(not held: bf16 parameters); updates against the float32 flat run "
            f"{against['this run']:.3e} (limit {BF16_VS_F32:g} x {ref}'s "
            f"{against[ref]:.3e} = {limit:.3e})",
            lerr <= CUDA_LOSS and against["this run"] <= limit)


def run_cuda(base=None) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    n, rank, dev = hvd.size(), hvd.rank(), basics.device()
    if n != 4:
        raise RuntimeError(f"the cube world needs 4 ranks, got {n}")
    base = T.TrainConfig() if base is None else base
    rows = torch.cat([T.make_batch(base, i, "cpu", T.CACHE_ROWS) for i in range(n)])
    inits = {}
    for kv in (None, 2):
        for dtype in ("float32", "bfloat16"):
            whole = T.build_model(dataclasses.replace(base, kv_heads=kv,
                                                      dtype=dtype), dev)
            inits[(kv, dtype)] = {k: p.detach().cpu()
                                  for k, p in whole.named_parameters()}
            del whole
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    bad, lines, runs, truth = [], [], {}, {}
    held_to = {ref for *_, ref in CUDA_RUNS}
    for label, where, sharded, overrides, ref in CUDA_RUNS:
        r = runs[label] = cuda_run(base, where, sharded, overrides, dev, rows)
        config = r["config"]
        if where is None and config.dtype == "float32":
            truth[config.kv_heads] = r
        peaks = [None] * n
        dist.all_gather_object(peaks, (r["peak"], r["params"], r["launches"]))
        # The warm-up's steps and the captured one launch B1-B3 (remat runs
        # B1 again in the recompute), a replay nothing; the CPU runs their
        # plain versions, which count nothing.
        per = base.layers * (WARMUP_STEPS + 1) if dev.type == "cuda" else 0
        want = {k: per * (2 if config.remat and k == "flash_fwd" else 1)
                if k.startswith("flash") else 0 for k in r["launches"]}
        lines.append(
            f"{label}: {r['ms']:.2f} ms a step (median of {GRAPH_DISPATCHES} "
            f"dispatches / {GRAPH_K}), {1e3 * r['tokens'] / r['ms']:.1f} tokens/s "
            f"({r['tokens']} a step); peak GB by rank "
            f"{[round(p[0], 3) for p in peaks]}; parameters by rank "
            f"{[p[1] for p in peaks]} (analytic "
            f"{analytic_params(config, r['tp'])}); B1-B6 launches on rank 0, "
            f"warm-up and capture ({WARMUP_STEPS + 1} steps), none replayed: "
            f"{peaks[0][2]} (every rank {want}: "
            f"{all(p[2] == want for p in peaks)}); collectives at the capture "
            f"{r['capture']}, during the replays {r['replay']}; losses "
            f"{[round(x, 6) for x in r['losses']]}")
        if any(p[1] != analytic_params(config, r["tp"]) or p[2] != want
               for p in peaks) or r["replay"]:
            bad.append(lines[-1])
        if ref is not None:
            line, ok = held(label, r, ref, runs[ref], inits, truth)
            lines.append(line)
            if not ok:
                bad.append(line)
        if label not in held_to:
            r["state"] = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if rank == 0:
        cards = os.popen("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader").read()
        print(f"cards (name, power limit):\n{cards}" + "\n".join(lines))
    if bad:
        raise AssertionError(f"cube world: {bad}")
    if rank == 0:
        print(f"ok cube world {n}")


def main() -> None:
    torch.set_num_threads(1)
    mode = os.environ["CUBE_MODE"]
    hvd.init(device="cuda" if mode == "cuda" else "cpu")
    try:
        if mode == "cuda":
            run_cuda()
        else:
            res = {}
            run_cpu(res)
            np.savez(f"{os.environ['CUBE_OUT']}.{hvd.rank()}.npz", **res)
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
