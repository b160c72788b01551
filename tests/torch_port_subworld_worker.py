"""One rank of the sub-world that tests/test_torch_port_subworld.py
launches on the CPU (gloo): a launched world of three in which each rank
calls ``init(device="cpu", comm=SUB_COMM)``. A non-member reports the
``ValueError`` it gets; a member reports its re-indexed place, the sum of
the members' launched ranks plus one (an allreduce over the members only),
``allgather_object`` of its launched rank and ``broadcast_object`` of
sub-rank 0's. The last line of stdout is one JSON object.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402


def main() -> None:
    launched = int(os.environ["HOROVOD_RANK"])
    comm = [int(r) for r in os.environ["SUB_COMM"].split(",")]
    try:
        hvd.init(device="cpu", comm=comm)
    except ValueError as e:
        print(json.dumps({"member": False, "error": str(e),
                          "initialized": hvd.is_initialized()}))
        return
    total = hvd.allreduce(torch.tensor([launched + 1.0]), hvd.ReduceOp.SUM)
    out = {"member": True,
           "place": [hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
                     hvd.cross_rank(), hvd.cross_size()],
           "sum": total.item(),
           "gathered": hvd.allgather_object(launched),
           "root": hvd.broadcast_object({"from": launched}, root_rank=0)}
    hvd.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
