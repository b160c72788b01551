"""One rank of the hierarchical world that tests/test_torch_port_hierarchical.py
(gloo, on the CPU) and tests/test_torch_port_cuda.py (NCCL, one process per
GPU) launch. It imports no JAX: the CPU test computes the JAX package's side
and hands inputs over in an .npz file.

``HIER_DEVICE=cpu``: a world of 4 with ``HOROVOD_LOCAL_SIZE=2``, so
``hierarchical_groups()`` lays it out as dcn 2 x ici 2. Reads ``HIER_IN``
(each input with a leading dim of 4, one row per rank) and writes this
rank's results to ``HIER_OUT.<rank>.npz``:

- the layout: each group's global ranks;
- ``allreduce``, ``broadcast`` (root 1 of the group) and ``allgather`` over
  the ICI group; ``grouped_allreduce`` of a list and a dict over the world;
  ``reducescatter`` over ICI and, averaged, over the world; ``alltoall``
  over the world and over ICI; ``hierarchical_allgather``;
  ``sparse_allreduce`` over the world; ``hierarchical_allreduce`` averaged,
  summed, and with a bf16 DCN wire;
- ``fused_allreduce_(hierarchical=True)`` on the mixed-dtype tree, per case
  of ``FUSED_CASES`` (compression, dcn_compression, dcn_threshold, and
  HOROVOD_DCN_COMPRESSION, set for the case alone) and op:
  SUM on every leaf, AVERAGE on the float leaves; plus the padded buffer
  lengths and the ICI and DCN wire dtypes the plan gives each bucket;
- the graft demo's step: ResNet-18 (10 classes, 32 x 32, 2 images per
  rank) with eval-mode BatchNorm, SGD 0.01 in
  ``DistributedOptimizer(hierarchical=True, fusion_threshold=1 << 20)``,
  in float64, from the JAX weights: the world-averaged loss and the
  parameters after the step in flax's layout, once with ``dcn_compression
  ="none"`` and once with the world's ``HOROVOD_DCN_COMPRESSION=bf16``.

``HIER_DEVICE=cuda``: one process per GPU, 4 of them, laid out as dcn 2 x
ici 2 with ``hierarchical_groups(ici_size=2)``. Full-width ResNet-50 (bf16,
channels-last, 128 images per card) from the same seed takes 3 steps
flat, flat again, hierarchical, and hierarchical with a bf16 DCN wire;
every loss and the parameters' updates of the last three runs are held to
the flat run's: loss 1e-2 relative (phase 10's bf16 limit), the updates of
all parameters together 3e-2 relative norm, as sums in another order
(read on four H100s: 3.65e-4 for the ladder at full width and 9.13e-3 with
the bf16 DCN wire; the limit is about three times the larger, so a fault
of moderate size still fails). The worst single tensor
is printed, not held: a tensor whose first gradient is 0 (each residual
branch's convolutions, behind a BatchNorm scale of 0) has an update of a
few later steps' tiny gradients, whose relative error is large whatever
the sum order; the second flat run shows what the card's own run-to-run
differences give. Rank 0 prints the img/s of each (median of steps 1-2)
and ``ok hier world <n>``.

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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import convert  # noqa: E402
from horovod_tpu_torch.compression import Compression  # noqa: E402
from horovod_tpu_torch.parallel import collectives as C  # noqa: E402
from horovod_tpu_torch.parallel import fusion  # noqa: E402
from horovod_tpu_torch.parallel.mesh import hierarchical_groups  # noqa: E402
from horovod_tpu_torch.train_cnn import (CNNConfig, build_cnn,  # noqa: E402
                                         make_cnn_train_step, make_images)

# name: (compression, dcn_compression, dcn_threshold,
# HOROVOD_DCN_COMPRESSION); the threshold is 64 MiB but for the capped case.
FUSED_CASES = {
    "plain": ("none", None, 0, ""),
    "dcn_bf16": ("none", "bf16", 0, ""),
    "dcn_capped": ("none", None, 1024, ""),
    "adaptive": ("adaptive", None, 0, ""),
    "dcn_env_bf16": ("none", None, 0, "bf16"),
    "adaptive_env_fp16": ("adaptive", None, 0, "fp16"),
}
THRESHOLD = 64 << 20
OPS = {"sum": C.ReduceOp.SUM, "average": C.ReduceOp.AVERAGE}
CUDA_STEPS = 3


def _flax_tree(data, prefix: str) -> dict:
    tree: dict = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def _dtype_name(dtype) -> str:
    return "none" if dtype is None else str(dtype).removeprefix("torch.")


def collectives(data, rank: int, groups) -> dict:
    def mine(name):
        return torch.from_numpy(np.ascontiguousarray(data[name][rank]))

    x = mine("x")
    res = {"ici_ranks": np.array([torch.distributed.get_global_rank(
               groups.ici_group, r) for r in range(groups.ici_size)]),
           "dcn_ranks": np.array([torch.distributed.get_global_rank(
               groups.dcn_group, r) for r in range(groups.dcn_size)]),
           "ici_allreduce": C.allreduce(x, group=groups.ici_group).numpy(),
           "ici_broadcast": C.broadcast(x.clone(), 1, groups.ici_group).numpy(),
           "ici_allgather": C.allgather(x, groups.ici_group).numpy()}
    grouped = C.grouped_allreduce([x, mine("ints")], C.ReduceOp.SUM)
    res["grouped_list_x"], res["grouped_list_ints"] = (t.numpy() for t in grouped)
    res["grouped_dict_x"] = C.grouped_allreduce({"x": x})["x"].numpy()
    res["rs_ici"] = C.reducescatter(x, groups.ici_group).numpy()
    res["rs_world_avg"] = C.reducescatter(x, average=True).numpy()
    a2a = mine("a2a")
    res["a2a_world"] = C.alltoall(a2a, None, 1, 0).numpy()
    res["a2a_ici"] = C.alltoall(a2a, groups.ici_group, 0, 2).numpy()
    res["hier_allgather"] = C.hierarchical_allgather(mine("ints"), groups).numpy()
    values, indices = C.sparse_allreduce(mine("values"), mine("indices"))
    res["sparse_values"], res["sparse_indices"] = values.numpy(), indices.numpy()
    res["hier_avg"] = C.hierarchical_allreduce(x, groups).numpy()
    res["hier_sum"] = C.hierarchical_allreduce(x, groups, average=False).numpy()
    res["hier_bf16"] = C.hierarchical_allreduce(
        x, groups, dcn_wire_dtype=torch.bfloat16).numpy()
    return res


def fused(data, rank: int, groups) -> dict:
    names = json.loads(str(data["tree_names"]))
    res = {}
    world_env = os.environ["HOROVOD_DCN_COMPRESSION"]
    for case, (comp, dcn_comp, dcn_threshold, env) in FUSED_CASES.items():
        os.environ["HOROVOD_DCN_COMPRESSION"] = env
        for op_name, op in OPS.items():
            keep = [n for n in names
                    if op_name == "sum" or data[f"tree/{n}"].dtype.kind == "f"]
            leaves = [torch.from_numpy(np.ascontiguousarray(data[f"tree/{n}"][rank]))
                      for n in keep]
            threshold = fusion.dcn_capped_threshold(THRESHOLD, dcn_threshold,
                                                    groups.ici_size)
            plan = fusion.build_plan(leaves, threshold, pad_to=groups.ici_size)
            tag = f"{case}/{op_name}"
            res[f"{tag}/buckets"] = np.array(json.dumps(
                [[d.index for d in b] for b in plan.buckets]))
            buffers = fusion.fuse(leaves, plan)
            res[f"{tag}/padded"] = np.array([b.numel() for b in buffers])
            ici, dcn = fusion.tier_wires(plan, op, Compression.by_name(comp),
                                         None, True, dcn_comp)
            res[f"{tag}/tiers"] = np.array(json.dumps(
                [[_dtype_name(w or b.dtype), None if d is None else _dtype_name(d)]
                 for b, w, d in zip(buffers, ici, dcn)]))
            fusion.fused_allreduce_(leaves, plan, op, Compression.by_name(comp),
                                    hierarchical=True, groups=groups,
                                    dcn_compression=dcn_comp)
            for n, t in zip(keep, leaves):
                res[f"{tag}/leaf/{n}"] = t.numpy()
    os.environ["HOROVOD_DCN_COMPRESSION"] = world_env
    return res


def graft_step(data, rank: int) -> dict:
    """The step of __graft_entry__._resnet_dp_step, in float64."""
    config = CNNConfig(**json.loads(str(data["graft_config"])))
    params, stats = _flax_tree(data, "graft_params"), _flax_tree(data, "graft_stats")
    x = torch.from_numpy(data["graft_x"][rank]).permute(0, 3, 1, 2)
    y = torch.from_numpy(data["graft_y"][rank]).long()
    res = {}
    for wire in ("none", "bf16"):
        model = build_cnn(config, "cpu").double()
        model.load_state_dict(convert.cnn_state_dict_from_jax(
            params, stats, model.state_dict().keys()))
        named = convert.jax_ordered(model.named_parameters(), convert.cnn_param_path)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=0.01), named,
            hierarchical=True, fusion_threshold=1 << 20,
            dcn_compression="none" if wire == "none" else None)
        dcn_wires = {_dtype_name(w) for w in opt.wires[1]} - {"none"}
        if dcn_wires != ({"bfloat16"} if wire == "bf16" else set()) \
                or opt.groups.ici_size != 2:
            raise AssertionError(f"{wire}: DCN wires {dcn_wires}, "
                                 f"ici {opt.groups.ici_size}")
        res[f"{wire}/padded"] = np.array([b.numel() for b in fusion.fuse(
            [p.detach() for _, p in named], opt.plan)])
        model.eval()
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        res[f"{wire}/loss"] = np.float64(hvd.metric_average(loss.item()))
        for name, p in named:
            res[f"{wire}/param/{name}"] = convert.to_flax_layout(
                name, p, convert.cnn_param_path)
    return res


def run_cpu() -> None:
    rank = hvd.rank()
    data = np.load(os.environ["HIER_IN"])
    groups = hierarchical_groups()
    res = {**collectives(data, rank, groups), **fused(data, rank, groups),
           **graft_step(data, rank)}
    np.savez(f"{os.environ['HIER_OUT']}.{rank}.npz", **res)


def _relnorm(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).double().norm() / want.double().norm().clamp_min(1e-30)).item()


def run_cuda() -> None:
    """Flat, hierarchical and hierarchical with a bf16 DCN wire; 3 steps
    each from the same weights and batches."""
    rank, size, dev = hvd.rank(), hvd.size(), hvd.device()
    groups = hierarchical_groups(ici_size=2)
    config = CNNConfig()
    images, labels = make_images(config, rank, dev)
    runs = {}
    for label, hier, dcn in (("flat", False, None), ("flat, again", False, None),
                             ("hierarchical", True, None),
                             ("hierarchical, DCN bf16", True, "bf16")):
        model = build_cnn(config, dev)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        named = convert.jax_ordered(model.named_parameters(), convert.cnn_param_path)
        init = {n: p.detach().clone() for n, p in named}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=config.lr * size,
                            momentum=config.momentum), named,
            hierarchical=hier, groups=groups if hier else None,
            dcn_compression=dcn)
        step = make_cnn_train_step(model, opt)
        losses, times = [], []
        for _ in range(CUDA_STEPS):
            t0 = time.perf_counter()
            losses.append(hvd.metric_average(step(images, labels).item()))
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        runs[label] = (losses, {n: p.detach() - init[n] for n, p in named},
                       config.batch * size / statistics.median(times[1:]),
                       opt.plan.num_buckets)
        del model, opt, step
        torch.cuda.empty_cache()
    flat_losses, flat_updates, _, _ = runs["flat"]
    names = list(flat_updates)

    def cat(updates):
        return torch.cat([updates[n].reshape(-1) for n in names])

    for label in ("flat, again", "hierarchical", "hierarchical, DCN bf16"):
        losses, updates, _, _ = runs[label]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, flat_losses))
        every = _relnorm(cat(updates), cat(flat_updates))
        worst = max((_relnorm(updates[n], u), n) for n, u in flat_updates.items())
        if not (rel <= 1e-2 and every <= 3e-2):
            raise AssertionError(f"{label}: loss {rel}, updates {every}")
        if rank == 0:
            print(f"{label} vs flat: loss {rel:.3e} relative (limit 1e-2), "
                  f"all updates {every:.3e} relative norm (limit 3e-2); worst "
                  f"single tensor {worst[1]} {worst[0]:.3e}", flush=True)
    if rank == 0:
        print("img/s over {} cards, median of steps 1-2: ".format(size) + "; ".join(
            f"{label} {r[2]:.1f} ({r[3]} buckets)" for label, r in runs.items()),
            flush=True)
        print(f"ok hier world {size}", flush=True)
    torch.distributed.barrier()


def main() -> None:
    torch.set_num_threads(1)
    device = os.environ["HIER_DEVICE"]
    hvd.init(device=device)
    try:
        run_cpu() if device == "cpu" else run_cuda()
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
