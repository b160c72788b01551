"""One rank of the checkpoint world that tests/test_torch_port_checkpoint.py
launches on the CPU (gloo, 2 ranks). It imports no JAX: the test computes
the JAX package's side itself. Each rank writes its results to
``CKPT_OUT.<rank>.json``; ``CKPT_DIR`` is a directory both ranks share.

In order:

1. the cross-rank digest: the same state on both ranks passes; a state
   that differs on rank 1 raises on every rank (the message is reported);
2. the ``save`` barrier: rank 0's commit holds 2 s at its stage
   (``HOROVOD_CKPT_TEST_STALL=stage``); rank 1's ``save`` must not return
   before the checkpoint is in place;
3. ``broadcast_resume_state``: rank 0's int, float, numpy scalar, bf16 and
   int64 tensors and a nested list, each leaf reported with its type;
4. ``save_sharded`` under ``('batch', 'shard') = 1 x 2`` of the leaves in
   ``CKPT_IN`` (an .npz: ``leaf<i>`` and ``mu<i>``, with the plan's
   threshold in ``CKPT_THRESHOLD``), then ``restore_sharded`` into 2 x 1 and
   into 1 x 2 (rows first filled with NaN: the pad must come back 0), and
   ``restore`` into the flat leaves; every restored leaf is reported;
5. the digest's bounded wait: with ``HOROVOD_CKPT_VERIFY_TIMEOUT=5`` only
   rank 0 calls it, and must raise within the bound.

With ``CKPT_MODE=cuda`` (tests/test_torch_port_cuda.py, four GPUs, one
rank each, NCCL) it checks the same contract on the cards instead, and
raises on any difference: ``save`` of device tensors (rank 0 writes, the
barrier with ``device_ids``) and ``restore(verify=True)`` in place, bit
for bit; a rank whose read is perturbed makes every rank raise the
divergence; ``broadcast_resume_state``, ``broadcast_object`` and
``allgather_object``; ``save_sharded`` at ``('batch', 'shard') = 2 x 2``
restored into 1 x 4 (rows first filled with NaN: each row bit-equal to
``shard_params`` of the full leaves, pad 0) and into the flat leaves; then
a sub-world ``init(comm=[1, 3])`` at ``CKPT_SUB_PORT``: ranks 0 and 2 get
the ``ValueError``, ranks 1 and 3 re-index to 0 and 1 of 2 with local rank
0, stay on the GPU of their launched local rank, allreduce over the two,
and save and restore with the digest. Rank 0 prints ``ok ckpt world 4``.

Every rank exits non-zero on a failure the test does not expect.
"""

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import checkpoint as ck  # noqa: E402
from horovod_tpu_torch.parallel import sharded as sh  # noqa: E402
from horovod_tpu_torch.parallel.mesh import sharded_groups  # noqa: E402


def digest(rank: int) -> dict:
    ck._verify_cross_rank_digest({"w": torch.arange(8.0)}, "same")
    try:
        ck._verify_cross_rank_digest({"w": torch.full((8,), float(rank))}, "diff")
        return {"diverged": None}
    except hvd.HorovodInternalError as e:
        return {"diverged": str(e)}


def save_barrier(rank: int, path: str) -> dict:
    if rank == 0:
        os.environ.update(HOROVOD_CKPT_TEST_STALL="stage",
                          HOROVOD_CKPT_TEST_STALL_S="2")
    t0 = time.monotonic()
    try:
        ck.save(path, {"w": torch.arange(4.0)}, step=1)
    finally:
        os.environ.pop("HOROVOD_CKPT_TEST_STALL", None)
    return {"save_s": time.monotonic() - t0,
            "in_place": os.path.exists(os.path.join(path, "step_1", ck.STATE_FILE))}


def resume_state(rank: int) -> dict:
    state = {"epoch": 3 if rank == 0 else 0, "lr": 0.5 if rank == 0 else 0.1,
             "np": np.int64(7 if rank == 0 else 1),
             "bf16": torch.full((2,), 1.5 if rank == 0 else -1.0, dtype=torch.bfloat16),
             "i64": torch.arange(3) * (rank + 1), "nested": [rank, ("a", rank * 2)]}
    out = ck.broadcast_resume_state(state)
    return {k: [type(v).__name__,
                str(v.dtype) if torch.is_tensor(v) else None,
                v.tolist() if torch.is_tensor(v) else
                (v.item() if isinstance(v, np.generic) else v)]
            for k, v in out.items()}


def rows_like(rows, fill):
    return sh.ShardedBuckets([torch.full_like(r.detach(), fill) for r in rows])


def sharded(rank: int, path: str, data, threshold: int) -> dict:
    n = len([k for k in data if k.startswith("leaf")])
    leaves = [torch.from_numpy(data[f"leaf{i}"]) for i in range(n)]
    mu = [torch.from_numpy(data[f"mu{i}"]) for i in range(n)]
    layout = sharded_groups(1, 2)
    plan = sh.build_shard_plan(leaves, 2, threshold, 1)
    state = {"params": sh.shard_params(leaves, plan, layout.shard_rank),
             "mu": sh.shard_params(mu, plan, layout.shard_rank),
             "step": torch.tensor(3.0)}
    ck.save_sharded(path, state, plan, step=2, layout=layout)
    out = {"padded": list(plan.padded_sizes), "raw": list(plan.raw_sizes)}

    # 2 x 1: each rank holds whole buckets.
    layout2 = sharded_groups(2, 1)
    plan2 = sh.build_shard_plan(leaves, 1, threshold, 1)
    tmpl = {"params": rows_like(sh.shard_params(leaves, plan2, 0), 0.0),
            "mu": rows_like(sh.shard_params(mu, plan2, 0), 0.0),
            "step": torch.tensor(0.0)}
    got = ck.restore_sharded(path, tmpl, plan2, step=2, layout=layout2)
    out["2x1"] = {k: [t.tolist() for t in sh.unshard_params([got[k]], plan2)]
                  for k in ("params", "mu")}
    out["2x1_step"] = got["step"].item()

    # flat: the full leaves.
    flat = {"params": [torch.zeros_like(t) for t in leaves],
            "mu": [torch.zeros_like(t) for t in mu], "step": torch.tensor(0.0)}
    got = ck.restore(path, template=flat, step=2)
    out["flat"] = {k: [t.tolist() for t in got[k]] for k in ("params", "mu")}

    # 1 x 2 again, into rows full of NaN: the pad comes back 0.
    tmpl = {"params": rows_like(state["params"], float("nan")),
            "mu": rows_like(state["mu"], float("nan")), "step": torch.tensor(0.0)}
    got = ck.restore_sharded(path, tmpl, plan, step=2, layout=layout)
    out["1x2_rows_equal"] = all(
        torch.equal(a, b) for k in ("params", "mu")
        for a, b in zip(got[k], state[k]))
    out["1x2_same_tensors"] = all(a is b for k in ("params", "mu")
                                  for a, b in zip(got[k], tmpl[k]))
    return out


def bounded_wait(rank: int) -> dict:
    os.environ["HOROVOD_CKPT_VERIFY_TIMEOUT"] = "5"
    out = {}
    if rank == 0:
        t0 = time.monotonic()
        try:
            ck._verify_cross_rank_digest({"w": torch.ones(2)}, "alone")
            out["timeout"] = None
        except hvd.HorovodInternalError as e:
            out["timeout"] = str(e)
        out["timeout_s"] = time.monotonic() - t0
    dist.barrier()
    return out


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def cuda_restore(rank: int, dev, path: str) -> None:
    rng = np.random.default_rng(0)
    full = {"w": torch.from_numpy(rng.standard_normal((1024, 1031)).astype(np.float32)).to(dev),
            "b": torch.from_numpy(rng.standard_normal(4097).astype(np.float32)).to(
                dev, torch.bfloat16),
            "i": torch.arange(7, device=dev) * 3, "step": 5}
    if rank == 0:
        os.environ.update(HOROVOD_CKPT_TEST_STALL="stage", HOROVOD_CKPT_TEST_STALL_S="2")
    try:
        ck.save(path, full, step=1)
    finally:
        os.environ.pop("HOROVOD_CKPT_TEST_STALL", None)
    if not os.path.exists(os.path.join(path, "step_1", ck.STATE_FILE)):
        raise AssertionError(f"rank {rank}: save returned before rank 0's commit")
    tmpl = {k: torch.zeros_like(v) if torch.is_tensor(v) else 0 for k, v in full.items()}
    ptrs = [tmpl[k].data_ptr() for k in ("w", "b", "i")]
    got = ck.restore(path, template=tmpl, step=1)
    if got["step"] != 5 or [got[k].data_ptr() for k in ("w", "b", "i")] != ptrs or \
            not all(_same(got[k], full[k]) for k in ("w", "b", "i")):
        raise AssertionError(f"rank {rank}: restore(verify=True) is not the saved state")

    real = ck._load

    def stale(target):  # the last rank reads one element more
        state = real(target)
        state["w"][3, 5] += 1.0
        return state

    if rank == dist.get_world_size() - 1:
        ck._load = stale
    try:
        ck.restore(path, template=tmpl, step=1)
        raise AssertionError(f"rank {rank}: a perturbed rank passed the digest")
    except hvd.HorovodInternalError as e:
        if "diverged across ranks" not in str(e):
            raise
    finally:
        ck._load = real


def cuda_objects(rank: int, dev) -> None:
    state = {"epoch": 3 if rank == 0 else 0, "np": np.int64(7 if rank == 0 else 1),
             "bf16": torch.full((2,), 1.5 if rank == 0 else -1.0, dtype=torch.bfloat16,
                                device=dev),
             "host": torch.arange(3) * (rank + 1)}
    out = ck.broadcast_resume_state(state)
    if not (type(out["epoch"]) is int and out["epoch"] == 3 and out["np"] == 7
            and out["bf16"].device == dev and out["bf16"].dtype == torch.bfloat16
            and out["bf16"].tolist() == [1.5, 1.5] and out["host"].device.type == "cpu"
            and out["host"].tolist() == [0, 1, 2]):
        raise AssertionError(f"rank {rank}: broadcast_resume_state gave {out}")
    if hvd.broadcast_object({"from": rank}, root_rank=2) != {"from": 2}:
        raise AssertionError(f"rank {rank}: broadcast_object")
    if hvd.allgather_object(rank * 10) != [r * 10 for r in range(hvd.size())]:
        raise AssertionError(f"rank {rank}: allgather_object")


def cuda_sharded(rank: int, dev, path: str) -> dict:
    rng = np.random.default_rng(1)
    shapes = [(1024, 1024), (4097,), (513, 77), (3,), (257, 129)]
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
              for s in shapes]
    mu = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
          for s in shapes]
    threshold = 1 << 20
    layout = sharded_groups(2, 2)
    plan = sh.build_shard_plan(leaves, 2, threshold, 1)
    state = {"params": sh.shard_params(leaves, plan, layout.shard_rank),
             "mu": sh.shard_params(mu, plan, layout.shard_rank),
             "step": torch.tensor(3.0, device=dev)}
    ck.save_sharded(path, state, plan, step=2, layout=layout)

    layout4 = sharded_groups(1, 4)
    plan4 = sh.build_shard_plan(leaves, 4, threshold, 1)
    want = {"params": sh.shard_params(leaves, plan4, layout4.shard_rank),
            "mu": sh.shard_params(mu, plan4, layout4.shard_rank)}
    tmpl = {k: rows_like(want[k], float("nan")) for k in want}
    tmpl["step"] = torch.tensor(0.0, device=dev)
    got = ck.restore_sharded(path, tmpl, plan4, step=2, layout=layout4)
    if got["step"].item() != 3.0 or not all(
            a is b and _same(a, w) for k in want
            for a, b, w in zip(got[k], tmpl[k], want[k])):
        raise AssertionError(f"rank {rank}: 2x2 -> 1x4 restore")

    flat = {"params": [torch.zeros_like(t) for t in leaves],
            "mu": [torch.zeros_like(t) for t in mu], "step": torch.tensor(0.0, device=dev)}
    got = ck.restore(path, template=flat, step=2)
    if not all(_same(a, b) for k, src in (("params", leaves), ("mu", mu))
               for a, b in zip(got[k], src)):
        raise AssertionError(f"rank {rank}: 2x2 -> flat restore")
    return {"buckets": plan.num_buckets, "buckets_1x4": plan4.num_buckets}


def cuda_subworld(launched: int, path: str) -> None:
    os.environ["HOROVOD_COORD_ADDR"] = f"127.0.0.1:{os.environ['CKPT_SUB_PORT']}"
    comm = [1, 3]
    try:
        hvd.init(comm=comm)
    except ValueError as e:
        if launched in comm or hvd.is_initialized() or "not a member" not in str(e):
            raise
        return
    dev = torch.device("cuda", launched)
    place = (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size())
    if place != (comm.index(launched), 2, 0, 1) or hvd.device() != dev or \
            torch.cuda.current_device() != launched:
        raise AssertionError(f"launched rank {launched}: sub-world place {place}, "
                             f"device {hvd.device()}")
    total = hvd.allreduce(torch.tensor([launched + 1.0], device=dev), hvd.ReduceOp.SUM)
    if total.item() != 6.0:
        raise AssertionError(f"launched rank {launched}: member sum {total.item()}")
    w = torch.arange(12.0, device=dev)
    ck.save(path, {"w": w}, step=1)
    tmpl = {"w": torch.zeros_like(w)}
    ck.restore(path, template=tmpl, step=1)
    if not torch.equal(tmpl["w"], w):
        raise AssertionError(f"launched rank {launched}: sub-world restore")
    hvd.shutdown()


def cuda_main() -> None:
    hvd.init()
    rank, dev = hvd.rank(), hvd.device()
    if dev != torch.device("cuda", int(os.environ["HOROVOD_LOCAL_RANK"])):
        raise AssertionError(f"rank {rank} on {dev}")
    shared = os.environ["CKPT_DIR"]
    t0 = time.monotonic()
    cuda_restore(rank, dev, os.path.join(shared, "plain"))
    cuda_objects(rank, dev)
    plans = cuda_sharded(rank, dev, os.path.join(shared, "sharded"))
    n = hvd.size()
    hvd.shutdown()
    cuda_subworld(rank, os.path.join(shared, "sub"))
    if rank == 0:
        print(f"save/restore with the digest (one rank perturbed: every rank "
              f"raised), the objects, save_sharded 2x2 ({plans['buckets']} buckets) "
              f"into 1x4 ({plans['buckets_1x4']} buckets) and flat, init(comm=[1, 3]) "
              f"on cuda:1 and cuda:3: {time.monotonic() - t0:.1f} s")
        print(f"ok ckpt world {n}")


def main() -> None:
    if os.environ.get("CKPT_MODE") == "cuda":
        cuda_main()
        return
    hvd.init(device="cpu")
    rank = hvd.rank()
    shared = os.environ["CKPT_DIR"]
    out = {"digest": digest(rank)}
    out["barrier"] = save_barrier(rank, os.path.join(shared, "barrier"))
    out["resume"] = resume_state(rank)
    out["sharded"] = sharded(rank, os.path.join(shared, "sharded"),
                             np.load(os.environ["CKPT_IN"]),
                             int(os.environ["CKPT_THRESHOLD"]))
    out.update(bounded_wait(rank))
    hvd.shutdown()
    with open(f"{os.environ['CKPT_OUT']}.{rank}.json", "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
