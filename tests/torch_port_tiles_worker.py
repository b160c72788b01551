"""One rank of the 2-rank gloo ring that tests/test_torch_port_flash_tiles.py
launches. It imports no JAX: the test computes the JAX package's side and
hands the inputs over in an .npz file (``TILES_IN``).

For every case of ``cases`` (a JSON object: name -> [zigzag, block_q,
block_k]) it runs ``ring_flash_attention`` on this rank's shard of the
case's q, k, v with those tile ceilings and writes, to
``TILES_OUT.<rank>.npz``, its output shard and the gradients of sum(out *
w) for its q, k, v shards. Identity and rendezvous come from the
launcher's ``HOROVOD_*`` variables; any failure exits non-zero.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.ops.ring_attention import zigzag_shard  # noqa: E402
from horovod_tpu_torch.ops.ring_flash import ring_flash_attention  # noqa: E402
from horovod_tpu_torch.parallel.mesh import dp_sp_groups  # noqa: E402


def main() -> None:
    hvd.init(device="cpu")
    data = np.load(os.environ["TILES_IN"])
    ring = dp_sp_groups(hvd.size())
    res = {}
    for case, (zigzag, block_q, block_k) in json.loads(str(data["cases"])).items():
        def shard(x):
            x = torch.tensor(x)
            if zigzag:
                x = zigzag_shard(x, ring.sp_size)
            return x.chunk(ring.sp_size, dim=1)[ring.sp_rank].contiguous()

        q, k, v, w = (shard(data[f"{case}_{x}"]) for x in "qkvw")
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = ring_flash_attention(*leaves, ring.group, zigzag,
                                   block_q=block_q, block_k=block_k)
        (out * w).sum().backward()
        res[f"{case}_out"] = out.detach().numpy()
        for name, leaf in zip(("dq", "dk", "dv"), leaves):
            res[f"{case}_{name}"] = leaf.grad.numpy()
    np.savez(f"{os.environ['TILES_OUT']}.{hvd.rank()}.npz", **res)
    hvd.shutdown()


if __name__ == "__main__":
    main()
