"""Long-context training on the PyTorch port: sequence parallelism with
ring attention, the counterpart of ``examples/transformer_long_context.py``.

Each sequence is cut into ``sp`` shards, one per rank of a ring; attention
is exact and causal, computed blockwise while K/V travel the ring
(``ring_flash_attention``: the kernels B4-B6 on the card, their plain
versions on the CPU; ``--attention dense`` takes the plain ring), and the
gradients are averaged over the whole dp x sp world, through
``train.TrainConfig(sp=...)``. The world is ``dp`` rings of ``sp``
consecutive ranks; each ring trains on its own batch.

    torchrun --nproc-per-node 4 examples/torch_transformer_long_context.py \
        --dp 2 --seq-len 8192
    python -m horovod_tpu_torch.runner -np 2 -- python \
        examples/torch_transformer_long_context.py --dp 1 --device cpu \
        --seq-len 256 --dim 64 --layers 2 --dtype float32
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run from repo without install

import horovod_tpu_torch as hvd
from horovod_tpu_torch.train import TrainConfig, train


def main(argv=None):
    p = argparse.ArgumentParser(description="torch long-context demo")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--attention", choices=["dense", "flash"], default="flash")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    hvd.init(device=args.device)
    world = hvd.size()
    if world % args.dp:
        raise SystemExit(f"world size {world} not divisible by --dp {args.dp}")
    sp = world // args.dp
    if args.seq_len % sp:
        raise SystemExit(f"--seq-len must be divisible by sp={sp}")
    config = TrainConfig(vocab=256, dim=args.dim, heads=args.heads,
                         layers=args.layers, seq=args.seq_len, batch=2,
                         lr=args.lr, attention=args.attention,
                         dtype=args.dtype, sp=sp)
    result = train(config, args.steps)
    if hvd.rank() == 0:
        for i, loss in enumerate(result.losses):
            print(f"step {i}: loss {loss:.6f} (seq {args.seq_len} over {sp} "
                  f"sequence shards, dp {args.dp})", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
