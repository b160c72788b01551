"""One rank of the sequence-parallel world that tests/test_torch_port_ring.py
(gloo, on the CPU) and tests/test_torch_port_cuda.py (NCCL, one process per
GPU) launch. It imports no JAX: the CPU test computes the JAX package's side
and hands inputs over in an .npz file.

``RING_DEVICE=cpu``: a world of 4. Reads ``RING_IN`` and writes this rank's
results to ``RING_OUT.<rank>.npz``:

- ``ring_flash_attention`` on one ring of 4 (contiguous, zigzag, GQA 4 over
  2): this rank's output shard and the gradients of sum(out * w) for its
  q, k, v shards;
- ``ring_attention`` (dense), the same;
- the sequence-parallel flash TransformerLM's logits on its shard, from
  weights converted from the JAX model;
- one dp=2 × sp=2 training step from the same weights: the world-averaged
  loss and the parameters after Adam, in flax's layout.

``RING_DEVICE=cuda``: a world of one process per GPU, n of them, runs
``TrainConfig(sp=n)`` at full width with the global sequence 4096 * n for
one step. Rank 0 then runs one step of slice 1's flash model on the whole
sequence, from the same weights, with the same targets (each shard's own
roll, concatenated), and checks the loss to 1e-3 relative and every
gradient to 3e-2 relative norm error. It prints ``ok sp world <n>``.

Every rank exits non-zero on any failure. Identity and rendezvous come from
the launcher's ``HOROVOD_*`` variables.
"""

import dataclasses
import json
import math
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import convert, train  # noqa: E402
from horovod_tpu_torch.models.transformer import TransformerLM  # noqa: E402
from horovod_tpu_torch.ops.ring_attention import ring_attention, zigzag_shard  # noqa: E402
from horovod_tpu_torch.ops.ring_flash import ring_flash_attention  # noqa: E402
from horovod_tpu_torch.parallel.mesh import dp_sp_groups  # noqa: E402

ATTENTION = {"flash": ring_flash_attention, "dense": ring_attention}


def _flax_tree(data, prefix: str) -> dict:
    """Nested dict of the arrays saved under ``prefix/a/b/...``."""
    tree: dict = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def _shard(x: torch.Tensor, ring, zigzag: bool) -> torch.Tensor:
    """This rank's piece of a full (B, T, ...) tensor."""
    if zigzag:
        x = zigzag_shard(x, ring.sp_size)
    return x.chunk(ring.sp_size, dim=1)[ring.sp_rank].contiguous()


def run_cpu(data, out_path: str) -> None:
    rank = hvd.rank()
    ring = dp_sp_groups(4)
    res = {}
    for case, (kind, zigzag) in json.loads(str(data["attention_cases"])).items():
        fn = ATTENTION[kind]
        q, k, v, w = (_shard(torch.tensor(data[f"{case}_{x}"]), ring, zigzag)
                      for x in "qkvw")
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves, ring.group, zigzag)
        (out * w).sum().backward()
        res[f"{case}_out"] = out.detach().numpy()
        for name, leaf in zip("qkv", leaves):
            res[f"{case}_d{name}"] = leaf.grad.numpy()

    cfg = json.loads(str(data["model_config"]))
    model = TransformerLM(**cfg, dtype=torch.float32, attention="flash",
                          sp_group=ring.group)
    model.load_state_dict(convert.transformer_state_dict_from_jax(
        _flax_tree(data, "model_params"), model.state_dict().keys()))
    tokens = _shard(torch.tensor(data["model_tokens"], dtype=torch.long), ring, False)
    t_local = tokens.shape[1]
    positions = torch.arange(ring.sp_rank * t_local, (ring.sp_rank + 1) * t_local)[None]
    with torch.no_grad():
        res["model_logits"] = model(tokens, positions).numpy()

    config = train.TrainConfig(**json.loads(str(data["train_config"])))
    dpsp = dp_sp_groups(config.sp)
    model = train.build_model(config, hvd.device(), dpsp.group)
    model.load_state_dict(convert.transformer_state_dict_from_jax(
        _flax_tree(data, "train_params"), model.state_dict().keys()))
    named = convert.jax_ordered(model.named_parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam([p for _, p in named], lr=config.lr), named)
    tokens, positions = train.make_shard(config, dpsp, hvd.device())
    loss = train.make_train_step(model, opt, positions)(tokens)
    res["train_loss"] = np.float64(hvd.metric_average(loss.item()))
    for name, p in named:
        res[f"train_param/{name}"] = convert.to_flax_layout(name, p)
    np.savez(f"{out_path}.{rank}.npz", **res)


def _relnorm(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def run_cuda() -> None:
    n, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    torch.backends.cuda.matmul.allow_tf32 = False
    config = train.TrainConfig(sp=n, seq=4096 * n)
    ring = dp_sp_groups(n)
    model = train.build_model(config, dev, ring.group)
    named = convert.jax_ordered(model.named_parameters())
    hvd.broadcast_parameters(named, root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam([p for _, p in named], lr=config.lr), named)
    tokens, positions = train.make_shard(config, ring, dev)
    loss = hvd.metric_average(train.make_train_step(model, opt, positions)(tokens).item())
    # After the step every .grad holds the world's average.
    grads = {name: p.grad.detach().clone() for name, p in named}
    del model, opt
    if rank == 0:
        ref = train.build_model(dataclasses.replace(config, sp=None), dev)
        full = train.make_batch(config, 0, dev)
        targets = torch.cat([torch.roll(s, -1, dims=1)
                             for s in full.chunk(n, dim=1)], dim=1)
        logits = ref(full)
        ref_loss = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                                   targets.reshape(-1))
        ref_loss.backward()
        rel = abs(loss - ref_loss.item()) / abs(ref_loss.item())
        assert math.isfinite(loss) and rel <= 1e-3, (loss, ref_loss.item())
        worst = max((_relnorm(grads[name], p.grad), name)
                    for name, p in ref.named_parameters())
        assert worst[0] <= 3e-2, worst
        print(f"ok sp world {n}: loss ring {loss:.6f} whole sequence "
              f"{ref_loss.item():.6f} rel {rel:.3e}; worst gradient "
              f"{worst[1]} {worst[0]:.3e}", flush=True)
    torch.distributed.barrier()


def main() -> None:
    torch.set_num_threads(1)
    device = os.environ["RING_DEVICE"]
    hvd.init(device=device)
    try:
        if device == "cpu":
            run_cpu(np.load(os.environ["RING_IN"]), os.environ["RING_OUT"])
        else:
            run_cuda()
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
