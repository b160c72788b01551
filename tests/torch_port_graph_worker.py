"""One rank of the graphed training world that tests/test_torch_port_cuda.py
launches over NCCL, one process per GPU, n of them. It imports no JAX.

Data parallelism: ``TrainConfig(steps_per_dispatch=2)`` at full width,
two dispatches of the CUDA graph (four steps, the bucket allreduces
captured in it) against four eager steps of the same step on the same
cache draws, from the same weights, with the same ``capturable`` Adam.
Every loss and every parameter afterwards must agree within 1e-6
relative (the same kernels in the same order: bit-equal is expected), and
every rank must hold rank 0's parameters bit for bit. Prints ``ok graph
dp world <n>``.

Sequence parallelism, ``TrainConfig(sp=n, seq=4096 * n,
steps_per_dispatch=2)``: the capture records the ring's batched P2P hops.
The same comparison, printed as ``ok graph sp world <n>``.

Every rank exits non-zero on any failure. Identity and rendezvous come from
the launcher's ``HOROVOD_*`` variables.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import train  # noqa: E402
from horovod_tpu_torch.loop import make_scan_train_loop  # noqa: E402

K, DISPATCHES, LIMIT = 2, 2, 1e-6


def graphed_against_eager(config: train.TrainConfig, label: str) -> None:
    n, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    s = train.setup(config, "cuda")
    cache = train.make_cache(config, s.sp, dev)
    loop = make_scan_train_loop(s.step, cache, K, optimizer=s.opt)
    graph_losses = []
    for _ in range(DISPATCHES):
        loop()
        graph_losses += loop.losses.tolist()
    graph_params = [p.detach().clone() for p in s.model.parameters()]
    del loop, s

    e = train.setup(config, "cuda")
    ctr, eager_losses = cache.counter(), []
    for _ in range(K * DISPATCHES):
        x, y, ctr = cache.sample(ctr)
        eager_losses.append(e.step(x, y).item())
    for got, want in zip(graph_losses, eager_losses):
        assert abs(got - want) <= LIMIT * abs(want), (label, graph_losses, eager_losses)
    worst = 0.0
    for (name, p), g in zip(e.model.named_parameters(), graph_params):
        err = (g - p).abs().max().item() / p.abs().max().clamp_min(1e-30).item()
        assert err <= LIMIT, (label, name, err)
        worst = max(worst, err)
        root = g.clone()
        hvd.broadcast(root, 0)
        assert torch.equal(root, g), (label, name, "ranks differ")
    if rank == 0:
        print(f"ok graph {label} world {n}: losses graph {graph_losses} eager "
              f"{eager_losses}; largest parameter difference {worst:.3e} of "
              f"its max (limit {LIMIT:g})", flush=True)
    torch.distributed.barrier()


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device="cuda")
    n = hvd.size()
    try:
        graphed_against_eager(train.TrainConfig(steps_per_dispatch=K), "dp")
        graphed_against_eager(
            train.TrainConfig(sp=n, seq=4096 * n, steps_per_dispatch=K), "sp")
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
