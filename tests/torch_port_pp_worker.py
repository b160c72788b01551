"""One rank of the pipeline-parallel worlds that
tests/test_torch_port_pipeline.py (gloo, on the CPU) and
tests/test_torch_port_cuda.py (NCCL, one process per GPU) launch. It
imports no JAX: the CPU test computes the JAX package's side and hands the
inputs over in an .npz file (``PP_IN``); each rank writes its results to
``PP_OUT.<rank>.npz``. ``PP_MODE`` picks the world:

``cpu4`` (4 ranks): the layouts of ``training_groups`` at (dp, pp, sp) =
(1, 4, 1), (2, 2, 1) and (1, 2, 2), and at the defaults (dp, fsdp) = (4,
1), (2, 2) and (1, 4): each rank's indices and the ranks of each of its
groups. Then, at pp = 4: ``pipeline_apply`` of the reference tests'
residual MLP layers (2 per stage, 4 microbatches of 2), the output
(``last_stage_value``) and the gradients of the masked mean squared
error; the output again with microbatch 1 set to zero (bubble
isolation); the small TransformerLM (2 blocks per stage), dense and
flash, its loss and every gradient from ``pipeline_lm_loss_and_grads``.
At pp 2 x sp 2: the TransformerLM of 2 blocks on each rank's sequence
shard, dense and flash, loss and gradients. At pp 2 x dp 2: 3 Adam steps
of ``train.setup_pipeline``, the losses and the parameters after the last.

``cpu2`` (2 ranks): the reference's fast two-stage gradient case.

``cuda`` (4 GPUs): the full-width flash TransformerLM at pp = 4 (3 blocks
per stage, 4 microbatches of one sequence) against the flat model on the
same 4 sequences, and at pp 2 x sp 2 (6 blocks per stage, each rank a
2048-token shard, ring flash) against the whole-sequence flat model on
the same sequence, loss 1e-2 relative and every gradient 3e-2 relative
norm (phase 5's bf16 limits); rank 0 prints the step times, each rank's
peak and kernel launches per step, and ``ok pp world <n>``.

Every rank exits non-zero on any failure. Identity and rendezvous come
from the launcher's ``HOROVOD_*`` variables.
"""

import dataclasses
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
from horovod_tpu_torch.models.pipeline_lm import (  # noqa: E402
    PipelineStage, pipeline_lm_loss_and_grads)
from horovod_tpu_torch.parallel.mesh import training_groups  # noqa: E402
from horovod_tpu_torch.parallel.pipeline import (  # noqa: E402
    last_stage_value, masked_last_stage_loss, pipeline_apply, stage_of)

LAYOUTS = ((1, 4, 1), (2, 2, 1), (1, 2, 2))      # (dp, pp, sp)
DEFAULTS = ((4, 1), (2, 2), (1, 4))              # (dp, fsdp)
ATTENTIONS = ("dense", "flash")
LM = dict(vocab=64, dim=32, heads=4, dtype=torch.float32)
TRAIN_STEPS, TRAIN_PP, TRAIN_MICRO = 3, 2, 2
CUDA_LOSS, CUDA_GRAD, STEPS = 1e-2, 3e-2, 3


def _t(data, key) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(data[key]))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def mlp_layer(p, x):
    """The reference tests' residual layer: ``x + tanh(x @ w + b)``."""
    return x + torch.tanh(x @ p["w"] + p["b"])


def mlp_case(data, res, prefix, group) -> None:
    """``pipeline_apply`` of this stage's MLP layers: the output, the
    gradients of the masked loss, and (with a zeroed microbatch in the
    inputs) the output again."""
    stage, n = stage_of(group)
    w, b = _t(data, f"{prefix}/w"), _t(data, f"{prefix}/b")
    per = w.shape[0] // n
    mine = {"w": w[stage * per:(stage + 1) * per].clone().requires_grad_(True),
            "b": b[stage * per:(stage + 1) * per].clone().requires_grad_(True)}
    micro, target = _t(data, f"{prefix}/micro"), _t(data, f"{prefix}/target")
    out = pipeline_apply(mlp_layer, mine, micro, group)
    res[f"{prefix}/out"] = _np(last_stage_value(out, group))
    masked_last_stage_loss(((out - target) ** 2).mean(), group).backward()
    res[f"{prefix}/gw"], res[f"{prefix}/gb"] = _np(mine["w"].grad), _np(mine["b"].grad)
    if f"{prefix}/micro2" in data:
        with torch.no_grad():
            out2 = pipeline_apply(mlp_layer, mine, _t(data, f"{prefix}/micro2"), group)
        res[f"{prefix}/out2"] = _np(last_stage_value(out2, group))


def lm_case(data, res, prefix, group, sp_group=None) -> None:
    """The stage of ``{prefix}`` (its state dict in the inputs, per stage)
    on this rank's tokens: the loss and every gradient."""
    stage, _ = stage_of(group)
    attention = prefix.rsplit("/", 1)[1]
    names = [k for k in data.files if k.startswith(f"{prefix}/s{stage}/")]
    state = {k.split("/", 3)[3]: _t(data, k) for k in names}
    layers = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("blocks."))
    model = PipelineStage(**LM, layers=layers, attention=attention, sp_group=sp_group)
    model.load_state_dict(state)
    tokens = _t(data, f"{prefix}/tokens")
    if sp_group is not None:
        s, n = dist.get_rank(sp_group), dist.get_world_size(sp_group)
        t_local = tokens.shape[-1] // n
        tokens = tokens[..., s * t_local:(s + 1) * t_local].contiguous()
    loss, grads = pipeline_lm_loss_and_grads(model, tokens, group)
    res[f"{prefix}/loss"] = _np(loss)
    for name, g in grads.items():
        res[f"{prefix}/grad/{name}"] = _np(g)


def layouts(res) -> None:
    for dp, pp, sp in LAYOUTS:
        lay = training_groups(dp, 1, pp, sp)
        key = f"layout/{dp}x{pp}x{sp}"
        res[f"{key}/index"] = np.array([lay.dp_rank, lay.fsdp_rank, lay.pp_rank,
                                        lay.sp_rank])
        for axis in ("dp", "fsdp", "pp", "sp"):
            res[f"{key}/{axis}"] = np.array(
                dist.get_process_group_ranks(getattr(lay, f"{axis}_group")))
    for dp, fsdp in DEFAULTS:
        lay = training_groups(dp, fsdp)
        key = f"default/{dp}x{fsdp}"
        res[f"{key}/index"] = np.array([lay.dp_rank, lay.fsdp_rank])
        for axis in ("dp", "fsdp"):
            res[f"{key}/{axis}"] = np.array(
                dist.get_process_group_ranks(getattr(lay, f"{axis}_group")))


def train_case(data, res) -> None:
    from horovod_tpu_torch import train as T

    config = T.TrainConfig(**{k: int(data[f"train/{k}"]) for k in
                              ("vocab", "dim", "heads", "layers", "seq", "batch")},
                           dtype="float32", attention="flash")
    s = T.setup_pipeline(config, TRAIN_PP, TRAIN_MICRO, device="cpu")
    tokens = T.make_batch(config, s.layout.dp_rank, "cpu")
    res["train/losses"] = np.array([s.step(tokens).item() for _ in range(TRAIN_STEPS)])
    res["train/index"] = np.array([s.layout.dp_rank, s.layout.pp_rank])
    for name, p in s.stage.named_parameters():
        res[f"train/param/{name}"] = _np(p)


def run_cpu4(data, res) -> None:
    layouts(res)
    pp4 = training_groups(1, 1, 4).pp_group
    mlp_case(data, res, "mlp", pp4)
    for attention in ATTENTIONS:
        lm_case(data, res, f"lm/{attention}", pp4)
    ppsp = training_groups(1, 1, 2, 2)
    for attention in ATTENTIONS:
        lm_case(data, res, f"ppsp/{attention}", ppsp.pp_group, ppsp.sp_group)
    train_case(data, res)


def run_cpu() -> None:
    rank, mode = hvd.rank(), os.environ["PP_MODE"]
    data = np.load(os.environ["PP_IN"])
    res = {}
    if mode == "cpu4":
        run_cpu4(data, res)
    else:
        mlp_case(data, res, "fast", training_groups(1, 1, 2).pp_group)
    np.savez(f"{os.environ['PP_OUT']}.{rank}.npz", **res)


# ---------------------------------------------------------------- the cards

def relnorm(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def timed(fn, steps: int = 3) -> tuple:
    """(median ms of steps 1.. of ``steps`` calls of ``fn``, the last
    call's result)."""
    times, out = [], None
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:]), out


def flat_grads(T, config, tokens, dev, sp: int = 1) -> tuple:
    """(ms, loss, {name: grad} on the host) of the flat model's forward and
    backward on ``tokens``, one rank alone; the targets rolled within each
    of ``sp`` equal sequence shards, as the sharded loss takes them."""
    from horovod_tpu_torch.models.transformer import next_tokens, token_loss

    model = T.build_model(config, dev)
    b, t = tokens.shape
    targets = next_tokens(tokens.reshape(b * sp, t // sp)).reshape(b, t)

    def step():
        model.zero_grad(set_to_none=True)
        loss = token_loss(model(tokens), targets)
        loss.backward()
        return loss.item()

    ms, loss = timed(step)
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    return ms, loss, grads


def pipeline_grads(T, config, tokens_micro, group, sp_group, dev) -> tuple:
    """(ms, loss, every stage's gradients merged on the host, this rank's
    peak GB and kernel launches per step) of
    ``pipeline_lm_loss_and_grads``."""
    from horovod_tpu_torch.models.pipeline_lm import merge_stage_state_dicts
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import ring_flash as rf

    torch.cuda.reset_peak_memory_stats(dev)
    stage = T.build_pipeline_stage(config, group, dev, sp_group)

    def step():
        stage.zero_grad(set_to_none=True)
        return pipeline_lm_loss_and_grads(stage, tokens_micro, group)[0].item()

    fa.reset_launches()
    rf.reset_launches()
    ms, loss = timed(step, STEPS)
    launches = {k: v // STEPS for k, v in {**fa.launches, **rf.launches}.items() if v}
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9, launches)
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, {n: p.grad.cpu() for n, p in stage.named_parameters()},
                           group=group)
    del stage
    torch.cuda.empty_cache()
    return ms, loss, merge_stage_state_dicts(every), peak


def hold(label, loss, want_loss, grads, want, bad, lines) -> None:
    lerr = abs(loss - want_loss) / abs(want_loss)
    gerr = max((relnorm(grads[k], want[k]), k) for k in want)
    lines.append(f"{label}: loss {loss:.6f} vs {want_loss:.6f} ({lerr:.3e}, limit "
                 f"{CUDA_LOSS:g}); worst gradient {gerr[0]:.3e} ({gerr[1]}, limit "
                 f"{CUDA_GRAD:g})")
    if not (lerr <= CUDA_LOSS and gerr[0] <= CUDA_GRAD):
        bad.append(lines[-1])


def run_cuda() -> None:
    from horovod_tpu_torch import train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    n, rank, dev = hvd.size(), hvd.rank(), basics.device()
    if n != 4:
        raise RuntimeError(f"the pp world needs 4 GPUs, got {n}")
    bad, lines, peaks = [], [], []

    # pp = 4: 3 blocks per stage, 4 microbatches of one sequence.
    config = dataclasses.replace(T.TrainConfig(), batch=4)
    tokens = T.make_batch(config, 0, dev)
    pp4 = training_groups(1, 1, 4)
    ms_flat, want_loss, want = flat_grads(T, config, tokens, dev)
    ms, loss, grads, peak = pipeline_grads(T, config, tokens.reshape(4, 1, -1),
                                           pp4.pp_group, None, dev)
    peaks.append(("pp=4", peak))
    hold("pp=4, 4 microbatches", loss, want_loss, grads, want, bad, lines)
    lines.append(f"pp=4: forward + backward {ms:.2f} ms per rank against "
                 f"{ms_flat:.2f} ms for the flat model on one rank (median of "
                 f"steps 1-2 of 3)")
    del want, grads

    # pp 2 x sp 2 on ring flash: one sequence, each rank a 2048-token shard.
    config = T.TrainConfig()
    tokens = T.make_batch(config, 0, dev)
    ppsp = training_groups(1, 1, 2, 2)
    t_local = config.seq // 2
    shard = tokens[:, ppsp.sp_rank * t_local:(ppsp.sp_rank + 1) * t_local]
    ms_flat, want_loss, want = flat_grads(T, config, tokens, dev, sp=2)
    ms, loss, grads, peak = pipeline_grads(T, config, shard.reshape(1, 1, -1).contiguous(),
                                           ppsp.pp_group, ppsp.sp_group, dev)
    peaks.append(("pp 2 x sp 2", peak))
    # Each sp rank's loss is its shard's mean and its gradients its shard's
    # share of the mean's: summed over the ring they are the whole's.
    loss_t = torch.tensor(loss, device=dev)
    dist.all_reduce(loss_t, group=ppsp.sp_group)
    every = [None] * 2
    dist.all_gather_object(every, grads, group=ppsp.sp_group)
    grads = {k: (every[0][k] + every[1][k]) / 2 for k in every[0]}
    hold("pp 2 x sp 2, ring flash", loss_t.item() / 2, want_loss, grads, want, bad,
         lines)
    lines.append(f"pp 2 x sp 2: forward + backward {ms:.2f} ms per rank against "
                 f"{ms_flat:.2f} ms for the flat model on the whole sequence")
    every = [None] * n
    dist.all_gather_object(every, peaks)
    if rank == 0:
        for r, rows in enumerate(every):
            lines.append(f"rank {r}: " + "; ".join(
                f"{k} peak {v:.3f} GB, launches per step {c}" for k, (v, c) in rows))
        cards = os.popen("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader").read()
        print(f"cards (name, power limit):\n{cards}" + "\n".join(lines))
    if bad:
        raise AssertionError(f"pp world: {bad}")
    if rank == 0:
        print(f"ok pp world {n}")


def main() -> None:
    torch.set_num_threads(1)
    mode = os.environ["PP_MODE"]
    hvd.init(device="cuda" if mode == "cuda" else "cpu")
    try:
        run_cuda() if mode == "cuda" else run_cpu()
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
