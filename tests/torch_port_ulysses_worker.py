"""One rank of the Ulysses world that tests/test_torch_port_ulysses.py (gloo,
on the CPU) and tests/test_torch_port_cuda.py (NCCL, one process per GPU)
launch. It imports no JAX: the CPU test computes the JAX package's side and
hands inputs over in an .npz file.

``ULY_DEVICE=cpu``: a world of 4, one sequence-parallel group of all four.
Reads ``ULY_IN`` and, per case of its ``cases`` (impl, GQA or not), runs
``ulysses_attention`` on this rank's sequence shard of q, k, v and writes
``ULY_OUT.<rank>.npz``: the output shard and the gradients of
sum(out * w) for its q, k and v shards; then the three inputs the
reference rejects (heads that do not divide by 4, GQA kv heads that do
not, an unknown impl), each error's message.

``ULY_DEVICE=cuda``: n ranks, one per GPU, at (1, 16384, 8, 128) bf16:
``ulysses_attention(impl="flash")`` forward and backward on each rank's
shard (one launch of each of B1-B3 per rank), gathered on rank 0 and held
against one whole-sequence ``flash_attention`` there: bit for bit, or else
within the bf16 kernel rules of tests/test_torch_port_cuda.py. Then the
same layer's forward + backward, Ulysses flash against
``ring_flash_attention`` at sp = n, timed on the host clock around calls
that end in a synchronize (median of 5 after 2 of warm-up). Rank 0 prints
the times and ``ok ulysses world <n>``.

Every rank exits non-zero on any failure. Identity and rendezvous come from
the launcher's ``HOROVOD_*`` variables.
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
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402
from horovod_tpu_torch.ops.ring_attention import ulysses_attention  # noqa: E402
from horovod_tpu_torch.ops.ring_flash import ring_flash_attention  # noqa: E402
from horovod_tpu_torch.parallel.mesh import dp_sp_groups  # noqa: E402

CUDA_LAYER = (1, 16384, 8, 8, 128)      # (B, T whole, H, Hkv, D)


def _shard(x: torch.Tensor, ring) -> torch.Tensor:
    return x.chunk(ring.sp_size, dim=1)[ring.sp_rank].contiguous()


def run_cpu() -> None:
    data = np.load(os.environ["ULY_IN"])
    ring = dp_sp_groups(hvd.size())
    res = {}
    for case, impl in json.loads(str(data["cases"])).items():
        q, k, v, w = (_shard(torch.tensor(data[f"{case}_{x}"]), ring) for x in "qkvw")
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = ulysses_attention(*leaves, ring.group, impl=impl)
        (out * w).sum().backward()
        res[f"{case}_out"] = out.detach().numpy()
        for name, leaf in zip("qkv", leaves):
            res[f"{case}_d{name}"] = leaf.grad.numpy()
    for case in ("bad_heads", "bad_gqa", "bad_impl"):
        q, k = torch.tensor(data[f"{case}_q"]), torch.tensor(data[f"{case}_k"])
        try:
            ulysses_attention(_shard(q, ring), _shard(k, ring), _shard(k, ring),
                              ring.group, impl=str(data[f"{case}_impl"]))
        except ValueError as e:
            res[f"{case}_error"] = np.array(str(e))
    np.savez(f"{os.environ['ULY_OUT']}.{hvd.rank()}.npz", **res)


def _gather_seq(x: torch.Tensor, ring) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(ring.sp_size)]
    dist.all_gather(parts, x.contiguous(), group=ring.group)
    return torch.cat(parts, dim=1)


def _held(name, got, want) -> str:
    """'bit-equal', or within the bf16 kernel rules; raises past them."""
    if torch.equal(got, want):
        return "bit-equal"
    g, w = got.float(), want.float()
    row_rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    err = (g - w).abs()
    if not (bool((err <= 2.0 ** -7 * w.abs() + 1e-2 * row_rms).all())
            and (g - w).norm().item() <= 1e-2 * w.norm().item()):
        raise AssertionError(f"{name}: max abs err {err.max().item()}")
    return f"within the bf16 rules (max abs err {err.max().item():.3e})"


def _fwd_bwd_s(fn, q, k, v, w, dev) -> float:
    times = []
    for i in range(7):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        fn(*leaves).backward(w)
        torch.cuda.synchronize(dev)
        if i >= 2:
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def run_cuda() -> None:
    rank, dev = hvd.rank(), hvd.device()
    ring = dp_sp_groups(hvd.size())
    b, t, h, hkv, d = CUDA_LAYER
    gen = torch.Generator(device=dev).manual_seed(2024)
    full = [torch.randn(b, t, hh, d, generator=gen, device=dev).to(torch.bfloat16)
            for hh in (h, hkv, hkv, h)]
    q, k, v, w = (_shard(x, ring) for x in full)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.reset_launches()
    out = ulysses_attention(*leaves, ring.group, impl="flash")
    out.backward(w)
    torch.cuda.synchronize(dev)
    if fa.launches != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
        raise AssertionError(f"launches {fa.launches}")
    got = [_gather_seq(x, ring) for x in (out.detach(), *(l.grad for l in leaves))]
    if rank == 0:
        ref_leaves = [x.clone().requires_grad_(True) for x in full[:3]]
        ref = fa.flash_attention(*ref_leaves)
        ref.backward(full[3])
        want = [ref.detach(), *(l.grad for l in ref_leaves)]
        verdicts = [f"{n} {_held(n, g, r)}" for n, g, r in
                    zip(("out", "dq", "dk", "dv"), got, want)]
        print(f"Ulysses flash over {ring.sp_size} cards vs whole-sequence "
              f"flash_attention {CUDA_LAYER}: " + ", ".join(verdicts), flush=True)
        del ref_leaves, ref, want
    del got, out, leaves
    torch.cuda.empty_cache()
    uly = _fwd_bwd_s(lambda a, b_, c: ulysses_attention(a, b_, c, ring.group,
                                                         impl="flash"), q, k, v, w, dev)
    rng = _fwd_bwd_s(lambda a, b_, c: ring_flash_attention(a, b_, c, ring.group),
                     q, k, v, w, dev)
    if rank == 0:
        print(f"forward + backward of the layer at sp={ring.sp_size}, T {t}, "
              f"median of 5 (s): ulysses flash {uly:.6f}, ring flash {rng:.6f}",
              flush=True)
        print(f"ok ulysses world {ring.sp_size}", flush=True)
    dist.barrier()


def main() -> None:
    torch.set_num_threads(1)
    device = os.environ["ULY_DEVICE"]
    hvd.init(device=device)
    try:
        run_cpu() if device == "cpu" else run_cuda()
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
