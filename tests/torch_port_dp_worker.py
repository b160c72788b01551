"""One rank of the data-parallel world that tests/test_torch_port_dp.py
launches: a flash TransformerLM whose ranks start from different random
weights and see different batches.

It checks, on every rank, that ``broadcast_parameters`` gives all ranks
rank 0's weights; that after each ``DistributedOptimizer.step`` every
parameter's ``.grad`` holds the mean over ranks of the local gradients
(gathered with ``allgather``): to 1e-5 of the largest mean with a
full-width wire (sums in another order), to 1e-2 of it with the bf16 wire
(bf16 rounding, 2^-8); and that the parameters stay identical on every
rank. Exits non-zero on any failure.

Environment: ``DP_DEVICE`` (cuda or cpu), ``DP_WIRES`` (comma-separated,
from none and bf16; each runs in turn in the same world), plus the
launcher's ``HOROVOD_*`` identity and rendezvous.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import convert  # noqa: E402
from horovod_tpu_torch.models.transformer import (TransformerLM,  # noqa: E402
                                                  init_weights, lm_loss)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def run(wire: str) -> None:
    dev, rank, size = hvd.device(), hvd.rank(), hvd.size()
    model = TransformerLM(vocab=64, dim=64, heads=2, layers=2,
                          attention="flash", dtype=torch.float32).to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(100 + rank))
    named = convert.jax_ordered(model.named_parameters())
    hvd.broadcast_parameters(named, root_rank=0)
    gathered = hvd.allgather(_flat(p for _, p in named)[None])
    assert torch.equal(gathered[rank], gathered[0]), "broadcast_parameters"
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam([p for _, p in named], lr=1e-3), named,
        compression=hvd.Compression.by_name(wire), fusion_threshold=20000)
    assert opt.plan.num_buckets > 1
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    gen = torch.Generator(device="cpu").manual_seed(rank)
    tokens = torch.randint(0, 64, (2, 64), generator=gen).to(dev)
    for step in range(2):
        opt.zero_grad()
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        local = _flat(p.grad for _, p in named)
        opt.step()
        want = hvd.allgather(local[None]).mean(dim=0)
        got = _flat(p.grad for _, p in named)
        tol = (1e-5 if wire == "none" else 1e-2) * want.abs().max().item()
        err = (got - want).abs().max().item()
        assert err <= tol, f"step {step}: reduced grad off by {err} > {tol}"
        params = hvd.allgather(_flat(p for _, p in named)[None])
        assert all(torch.equal(params[r], params[0]) for r in range(size)), \
            f"step {step}: parameters differ across ranks"
    if rank == 0:
        print(f"ok world {size} on {dev.type} wire {wire}", flush=True)


def main() -> None:
    torch.set_num_threads(1)
    hvd.init(device=os.environ["DP_DEVICE"])
    for wire in os.environ["DP_WIRES"].split(","):
        run(wire)
    hvd.shutdown()


if __name__ == "__main__":
    main()
