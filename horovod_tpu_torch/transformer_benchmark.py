"""TransformerLM training throughput (tokens/s): the port of the JAX
package's ``examples/transformer_benchmark.py``.

    python -m horovod_tpu_torch.transformer_benchmark --seq-len 4096
    python -m horovod_tpu_torch.transformer_benchmark --scan-steps 8 --json
    python -m horovod_tpu_torch.transformer_benchmark --device cpu --dim 32 \\
        --heads 4 --layers 2 --vocab 64 --seq-len 64

A full training step of ``train.TrainConfig``'s model: forward, loss,
backward and ``DistributedOptimizer`` (bucket allreduces, then Adam), bf16
activations and float32 parameters, on batches drawn from a
``data.DeviceCache``. ``--scan-steps K > 1`` runs K steps per dispatch as
one CUDA graph replayed K times (``loop.make_scan_train_loop``, the
counterpart of the JAX example's ``lax.scan``); otherwise each step is a
dispatch of its own, eager. ``--remat``, ``--loss-chunk`` and
``--bf16-logits`` are the model's long-context options. The defaults are
``TrainConfig``'s: 8 heads of 128 (the JAX example's default is 16 of 64).

The rate is the median-window one of ``horovod_tpu.jax.autotune``'s
``measure_steps_per_s``, copied here: ``--num-iters`` dispatches per
window, one host sync at each window's end, the median of 3 windows after
``--num-warmup`` dispatches. MFU is against the H100's dense bf16 peak of
989 TFLOP/s, printed beside the card's name and power limit; on the CPU
there is no MFU. Run it with one process per card (torchrun or the horovod
launcher) for data parallelism, and ``--sp N`` for rings of N cards.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Optional

import torch

from .common import basics
from .loop import make_scan_train_loop
from .train import TrainConfig, make_cache, setup

H100_BF16_PEAK = 989e12   # FLOP/s, dense, NVIDIA's data sheet (SXM, 700 W)


def measure_steps_per_s(run_step: Callable[[], None], warmup: int = 2,
                        iters: int = 5, reps: int = 3,
                        sync: Optional[Callable[[], None]] = None) -> float:
    """Median-window step rate: ``warmup`` calls, then ``reps`` windows of
    ``iters`` calls with one ``sync`` at each window's end; the rate of the
    median window. ``run_step`` may block itself (then omit ``sync``) or
    dispatch asynchronously with ``sync`` as the window's fence."""
    fence = sync or (lambda: None)
    for _ in range(warmup):
        run_step()
    fence()
    windows = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            run_step()
        fence()
        windows.append(time.perf_counter() - t0)
    windows.sort()
    return iters / windows[len(windows) // 2]


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
    args = parser.parse_args(argv)
    if args.bf16_logits and args.loss_chunk:
        parser.error("--bf16-logits does not reach the --loss-chunk path "
                     "(chunked_lm_loss does its own float32 head product); "
                     "drop one of the two flags")
    if args.scan_steps < 1:
        parser.error("--scan-steps must be >= 1")
    return args


def config_of(args) -> TrainConfig:
    return TrainConfig(
        vocab=args.vocab, dim=args.dim, heads=args.heads,
        kv_heads=args.kv_heads, layers=args.layers, seq=args.seq_len,
        batch=args.batch_size, sp=args.sp,
        remat=args.remat, loss_chunk=args.loss_chunk,
        logits_dtype="bfloat16" if args.bf16_logits else "float32",
        steps_per_dispatch=args.scan_steps if args.scan_steps > 1 else None)


def measure(args) -> tuple[float, float, int]:
    """(tokens/s over all ranks, the last loss, world size)."""
    config = config_of(args)
    s = setup(config, args.device)
    dev = basics.device()
    cache = make_cache(config, s.sp, dev)
    if config.steps_per_dispatch:
        loop = make_scan_train_loop(s.step, cache, config.steps_per_dispatch,
                                    optimizer=s.opt)
        if dev.type == "cuda":
            loop.capture()
        steps_per_call = config.steps_per_dispatch
    else:
        ctr = [cache.counter()]

        def loop():
            x, y, ctr[0] = cache.sample(ctr[0])
            return s.step(x, y)

        steps_per_call = 1
    loss = [None]

    def run():
        loss[0] = loop()

    def sync():
        if loss[0] is not None:   # --num-warmup 0: nothing to fence yet
            float(loss[0])

    rate = measure_steps_per_s(run, warmup=args.num_warmup,
                               iters=args.num_iters, reps=3, sync=sync)
    return (s.tokens_per_step * rate * steps_per_call, float(loss[0]),
            basics.size())


def report(args, tok_s: float, loss: float, n_dev: int) -> None:
    if basics.rank() != 0:
        return
    flops_tok = model_flops_per_token(args)
    kv = args.kv_heads if args.kv_heads else args.heads
    on_card = basics.device().type == "cuda"
    if on_card:
        name, limit = card()
        mfu = tok_s / n_dev * flops_tok / H100_BF16_PEAK
        mfu_note = (f"MFU {mfu * 100:.1f}% of the H100's dense bf16 peak "
                    f"(989 TFLOP/s) on {name}, power limit {limit}")
    else:
        name, limit, mfu = "cpu", None, None
        mfu_note = "no MFU on the CPU"
    print(f"Model: dim {args.dim} x {args.layers}L, heads {args.heads} "
          f"(kv {kv}), seq {args.seq_len}, remat={args.remat}, loss_chunk={args.loss_chunk}, "
          f"bf16_logits={args.bf16_logits}, scan_steps={args.scan_steps}")
    print(f"Tokens/sec on {n_dev} device(s): {tok_s:.0f} "
          f"({tok_s / n_dev:.0f} per device); {mfu_note}; loss {loss:.3f}")
    if args.json:
        print(json.dumps({
            "metric": "torch_transformer_tokens_per_sec", "value": tok_s,
            "unit": "tok/s", "per_device": tok_s / n_dev, "mfu": mfu,
            "device": name, "power_limit": limit, "devices": n_dev,
            "seq_len": args.seq_len, "remat": args.remat, "loss_chunk": args.loss_chunk,
            "bf16_logits": args.bf16_logits, "scan_steps": args.scan_steps,
            "sp": args.sp, "loss": loss}))


def main(argv=None) -> None:
    args = parse_args(argv)
    try:
        tok_s, loss, n_dev = measure(args)
        report(args, tok_s, loss, n_dev)
    finally:
        basics.shutdown()


if __name__ == "__main__":
    main()
