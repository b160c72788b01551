"""TransformerLM training throughput (tokens/s): the port of the JAX
package's ``examples/transformer_benchmark.py``.

    python -m horovod_tpu_torch.transformer_benchmark --seq-len 4096
    python -m horovod_tpu_torch.transformer_benchmark --scan-steps 8 --json
    python -m horovod_tpu_torch.transformer_benchmark --device cpu --dim 32 \\
        --heads 4 --layers 2 --vocab 64 --seq-len 64
    python -m horovod_tpu_torch.transformer_benchmark --scan-steps 4 \\
        --sweep-blocks

A full training step of ``train.TrainConfig``'s model: forward, loss,
backward and ``DistributedOptimizer`` (bucket allreduces, then Adam), bf16
activations and float32 parameters, on batches drawn from a
``data.DeviceCache``. ``--scan-steps K > 1`` runs K steps per dispatch as
one CUDA graph replayed K times (``loop.make_scan_train_loop``, the
counterpart of the JAX example's ``lax.scan``); otherwise each step is a
dispatch of its own, eager. ``--remat``, ``--loss-chunk`` and
``--bf16-logits`` are the model's long-context options. The defaults are
``TrainConfig``'s: 8 heads of 128 (the JAX example's default is 16 of 64).
``--attention dense`` runs the plain causal attention instead of the flash
kernels. ``--block-q`` and ``--block-k`` are the flash kernels' tile
ceilings (``ops/flash_attention.effective_blocks``; default: each kernel's
own tiles), and each run prints the tiles every kernel took.
``--sweep-blocks`` measures the model at today's tiles and then at each
(block_q, block_k) of ``--sweep-qs`` x ``--sweep-ks`` with block_k <=
block_q, as the JAX example's sweep does: one row per distinct set of
effective tiles, labelled with them, and a ``best:`` line. A built tile
that fails to launch raises; the sweep does not record it as data. The
JAX example's ``--nominal-tflops`` (a TPU data-sheet figure) is not
carried over.

The rate is the median-window one of ``autotune.measure_steps_per_s``,
the JAX package's method: ``--num-iters`` dispatches per window, one host
sync at each window's end, the median of 3 windows after
``--num-warmup`` dispatches. MFU is against the card's dense bf16 peak as
``utils/roofline.device_peaks`` reads it from the device (SMs x SM clock x
4096 FLOP per clock), or ``--peak-tflops``; both peaks are printed with
their inputs beside NVIDIA's data-sheet 989 TFLOP/s, and the card's name
and power limit. On the CPU there is no MFU. ``--profile`` then runs
``utils/roofline.profile_device_ops`` on the step and prints its report
(a graphed step's work is counted from one eager step's profile and the
capture's launches). Run it with one process per card (torchrun or the
horovod launcher) for data parallelism, and ``--sp N`` for rings of N
cards.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import gc
from typing import Optional

import torch

from .autotune import measure_steps_per_s
from .common import basics
from .loop import make_scan_train_loop
from .ops.flash_attention import TILE_PAIRS, effective_blocks
from .train import TrainConfig, make_cache, setup
from .utils import roofline


def model_flops_per_token(args) -> float:
    """Training FLOPs per token, PaLM-appendix convention: 6 N over the
    matmul parameters (N without the embedding table, a gather, but with
    the LM head) plus 12 L dim T for the attention products (no causal
    discount)."""
    d, L, T = args.dim, args.layers, args.seq_len
    kv = args.kv_heads if args.kv_heads else args.heads
    head_dim = d // args.heads
    per_block = (d * d                      # q proj
                 + 2 * d * kv * head_dim    # k, v proj (GQA-sized)
                 + d * d                    # o proj
                 + 2 * d * 4 * d)           # mlp in/out (mlp_ratio 4)
    n_matmul = L * per_block + d * args.vocab  # blocks + lm_head
    return 6.0 * n_matmul + 12.0 * L * d * T


def card() -> tuple[str, Optional[str]]:
    """(the card's name, its power limit as nvidia-smi reports it)."""
    name = torch.cuda.get_device_name(basics.device())
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={basics.device().index or 0}"],
            capture_output=True, text=True, timeout=30)
        limit = out.stdout.strip().split(",")[-1].strip() or None
    except (OSError, subprocess.TimeoutExpired):
        limit = None
    return name, limit


def parse_args(argv=None):
    base = TrainConfig()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dim", type=int, default=base.dim)
    parser.add_argument("--heads", type=int, default=base.heads)
    parser.add_argument("--kv-heads", type=int, default=None)
    parser.add_argument("--layers", type=int, default=base.layers)
    parser.add_argument("--vocab", type=int, default=base.vocab)
    parser.add_argument("--seq-len", type=int, default=base.seq)
    parser.add_argument("--batch-size", type=int, default=base.batch,
                        help="sequences per card (with --sp: per ring)")
    parser.add_argument("--attention", choices=["dense", "flash"],
                        default=base.attention)
    parser.add_argument("--block-q", type=int, default=None,
                        help="flash kernel q tile ceiling (default: each "
                             "kernel's own)")
    parser.add_argument("--block-k", type=int, default=None,
                        help="flash kernel k tile ceiling (default: each "
                             "kernel's own)")
    parser.add_argument("--sweep-blocks", action="store_true",
                        help="measure today's tiles and a grid of flash "
                             "(block_q, block_k) ceilings at this config and "
                             "print the table (a new model and graph per row)")
    parser.add_argument("--sweep-qs", default="64,128",
                        help="comma-separated block_q grid for --sweep-blocks")
    parser.add_argument("--sweep-ks", default="64,128",
                        help="comma-separated block_k grid for --sweep-blocks")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each block in the backward pass")
    parser.add_argument("--loss-chunk", type=int, default=0,
                        help=">0: the loss over sequence chunks of this many "
                             "tokens, so the (T, vocab) logits never exist")
    parser.add_argument("--bf16-logits", action="store_true",
                        help="run the LM head in bf16 (the loss upcasts)")
    parser.add_argument("--scan-steps", type=int, default=1,
                        help=">1: this many steps per dispatch, one CUDA "
                             "graph replayed (eager on the CPU)")
    parser.add_argument("--num-warmup", type=int, default=3)
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--sp", type=int, default=None,
                        help="ring size for sequence parallelism")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--json", action="store_true",
                        help="also print a machine-readable JSON line")
    parser.add_argument("--profile", action="store_true",
                        help="after measuring, profile the step and print "
                             "its roofline (horovod_tpu_torch/utils/"
                             "roofline.py)")
    parser.add_argument("--peak-tflops", type=float, default=None,
                        help="the dense bf16 peak MFU divides by (default: "
                             "read from the device)")
    args = parser.parse_args(argv)
    if args.bf16_logits and args.loss_chunk:
        parser.error("--bf16-logits does not reach the --loss-chunk path "
                     "(chunked_lm_loss does its own float32 head product); "
                     "drop one of the two flags")
    if args.scan_steps < 1:
        parser.error("--scan-steps must be >= 1")
    return args


def config_of(args, block_q=None, block_k=None) -> TrainConfig:
    return TrainConfig(
        vocab=args.vocab, dim=args.dim, heads=args.heads,
        kv_heads=args.kv_heads, layers=args.layers, seq=args.seq_len,
        batch=args.batch_size, sp=args.sp, attention=args.attention,
        remat=args.remat, loss_chunk=args.loss_chunk,
        logits_dtype="bfloat16" if args.bf16_logits else "float32",
        steps_per_dispatch=args.scan_steps if args.scan_steps > 1 else None,
        block_q=block_q, block_k=block_k)


def tiles(args, block_q=None, block_k=None) -> dict:
    """{kernel: (q extent, k extent)} the model's flash kernels run for
    these ceilings: the ring kernels under ``--sp``, else B1-B3 (bf16, the
    model's activations, at its head dim)."""
    t = args.seq_len // (args.sp or 1)
    eff = effective_blocks(t, args.dim // args.heads, torch.bfloat16,
                           block_q, block_k)
    names = [("ring_" + k if args.sp else k) for k in TILE_PAIRS]
    return {k: eff[k] for k in names}


def tiles_label(eff: dict) -> str:
    return ", ".join(f"{k} {q}/{kk}" for k, (q, kk) in eff.items())


def measure(args, block_q=None, block_k=None
            ) -> tuple[float, float, int, Optional[dict]]:
    """(tokens/s over all ranks, the last loss, world size, the roofline
    report with ``--profile`` or None)."""
    config = config_of(args, block_q, block_k)
    s = setup(config, args.device)
    dev = basics.device()
    cache = make_cache(config, s.sp, dev)
    ctr = [cache.counter()]

    def eager_step():
        x, y, ctr[0] = cache.sample(ctr[0])
        return s.step(x, y)

    if config.steps_per_dispatch:
        loop = make_scan_train_loop(s.step, cache, config.steps_per_dispatch,
                                    optimizer=s.opt)
        if dev.type == "cuda":
            loop.capture()
        steps_per_call = config.steps_per_dispatch
    else:
        loop, steps_per_call = eager_step, 1
    loss = [None]

    def run():
        loss[0] = loop()

    def sync():
        if loss[0] is not None:   # --num-warmup 0: nothing to fence yet
            float(loss[0])

    rate = measure_steps_per_s(run, warmup=args.num_warmup,
                               iters=args.num_iters, reps=3, sync=sync)
    rep = None
    if args.profile:
        # Every rank runs the profiled steps (they hold collectives).
        costs = None
        if loop is not eager_step and dev.type == "cuda":
            eager_step()           # the replays' work, from an eager step
            costs = roofline.profile_device_ops(eager_step, steps=1)\
                .get("kernel_costs")
        rep = roofline.profile_device_ops(run, steps=3, sync=sync, costs=costs)
    return (s.tokens_per_step * rate * steps_per_call, float(loss[0]),
            basics.size(), rep)


def peak_flops(args) -> tuple[float, str]:
    """(the dense bf16 peak MFU divides by, where it came from)."""
    if args.peak_tflops:
        return args.peak_tflops * 1e12, "--peak-tflops"
    peaks = roofline.device_peaks(basics.device())
    return peaks.bf16_flops, peaks.describe()


def sweep_blocks(args) -> list:
    """Measure today's tiles, then each (block_q, block_k) of the grid with
    block_k <= block_q, once per distinct set of effective tiles; print a
    row per set and the best. Returns the rows (ceilings, tiles, tok/s)."""
    if args.attention != "flash":
        raise SystemExit("--sweep-blocks tunes the flash kernel tiles; "
                         "the dense schedule has none (use --attention flash)")
    qs = [int(x) for x in args.sweep_qs.split(",")]
    ks = [int(x) for x in args.sweep_ks.split(",")]
    grid = [(None, None)] + [(bq, bk) for bq in qs for bk in ks if bk <= bq]
    rows, seen = [], set()
    for bq, bk in grid:
        eff = tiles(args, bq, bk)
        key = tuple(eff.values())
        if key in seen:
            continue
        seen.add(key)
        tok_s, _, _, _ = measure(args, bq, bk)
        gc.collect()
        if basics.device().type == "cuda":
            torch.cuda.empty_cache()
        rows.append(((bq, bk), eff, tok_s))
        if basics.rank() == 0:
            ceil = "default" if bq is None else f"{bq:>4}/{bk:<4}"
            print(f"  blocks {ceil:>9}: {tok_s:10.0f} tok/s  ({tiles_label(eff)})",
                  flush=True)
    if basics.rank() == 0:
        (bq, bk), eff, tok_s = max(rows, key=lambda r: r[2])
        print(f"best: block_q={bq} block_k={bk} ({tok_s:.0f} tok/s; "
              f"{tiles_label(eff)})")
    return rows


def report(args, tok_s: float, loss: float, n_dev: int,
           rep: Optional[dict] = None) -> None:
    if basics.rank() != 0:
        return
    flops_tok = model_flops_per_token(args)
    kv = args.kv_heads if args.kv_heads else args.heads
    on_card = basics.device().type == "cuda"
    peak, source = None, None
    if on_card:
        name, limit = card()
        peak, source = peak_flops(args)
        mfu = tok_s / n_dev * flops_tok / peak
        mfu_note = (f"MFU {mfu * 100:.1f}% of {peak / 1e12:.1f} TFLOP/s dense "
                    f"bf16 ({source}) on {name}, power limit {limit}")
    else:
        name, limit, mfu = "cpu", None, None
        mfu_note = "no MFU on the CPU"
    tiles_note = ""
    if args.attention == "flash":
        # The effective tiles (the flags are ceilings), as the sweep labels rows.
        tiles_note = f", tiles {tiles_label(tiles(args, args.block_q, args.block_k))}"
    print(f"Model: dim {args.dim} x {args.layers}L, heads {args.heads} "
          f"(kv {kv}), seq {args.seq_len}, attention={args.attention}, "
          f"remat={args.remat}, loss_chunk={args.loss_chunk}, "
          f"bf16_logits={args.bf16_logits}, scan_steps={args.scan_steps}"
          + tiles_note)
    print(f"Tokens/sec on {n_dev} device(s): {tok_s:.0f} "
          f"({tok_s / n_dev:.0f} per device); {mfu_note}; loss {loss:.3f}")
    if args.profile:
        print(roofline.format_report(rep) if rep is not None
              else "roofline: unavailable (no report)")
    if args.json:
        print(json.dumps({
            "metric": "torch_transformer_tokens_per_sec", "value": tok_s,
            "unit": "tok/s", "per_device": tok_s / n_dev, "mfu": mfu,
            "peak_flops": peak, "peak_source": source,
            "device": name, "power_limit": limit, "devices": n_dev,
            "seq_len": args.seq_len, "attention": args.attention,
            "block_q": args.block_q, "block_k": args.block_k,
            "remat": args.remat, "loss_chunk": args.loss_chunk,
            "bf16_logits": args.bf16_logits, "scan_steps": args.scan_steps,
            "sp": args.sp, "loss": loss}))


def main(argv=None) -> None:
    args = parse_args(argv)
    try:
        if args.sweep_blocks:
            sweep_blocks(args)
            return
        report(args, *measure(args, args.block_q, args.block_k))
    finally:
        basics.shutdown()


if __name__ == "__main__":
    main()
