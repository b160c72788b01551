"""One rank of the callbacks world that tests/test_torch_port_callbacks.py
launches on the CPU (gloo, 2 ranks). It imports no JAX. Rank r starts
from its own model (drawn from seed r) and its own momentum SGD state;
then, in order:

- ``BroadcastGlobalVariablesCallback(model, optimizer=opt)`` at train
  begin: every rank must hold rank 0's parameters and momentum buffers
  (reported as sums);
- two epochs of ``MetricAverageCallback`` (logs ``{"loss": r + 1,
  "acc": [r, 2 r]}``) and ``MetricsCallback`` (``steps`` 10), then
  ``MetricsCallback.on_train_end``: rank 0's pod snapshot, written to
  ``CB_OUT.pod.json``, and every rank's own snapshot;
- ``average_metrics`` of a tensor and a numpy value.

Each rank writes ``CB_OUT.<rank>.json``.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import callbacks  # noqa: E402


def main() -> None:
    hvd.init(device="cpu")
    rank = hvd.rank()
    torch.manual_seed(rank)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(5, 3)).square().sum().backward()
    opt.step()
    out = {}
    callbacks.BroadcastGlobalVariablesCallback(model, optimizer=opt).on_train_begin()
    out["params"] = [p.detach().double().sum().item() for p in model.parameters()]
    out["buffers"] = [opt.state[p]["momentum_buffer"].double().sum().item()
                      for p in model.parameters()]
    avg, met = callbacks.MetricAverageCallback(), callbacks.MetricsCallback(
        snapshot_path=os.environ["CB_OUT"] + ".pod.json")
    out["logs"] = []
    for epoch in range(2):
        met.on_epoch_begin(epoch)
        logs = {"loss": float(rank + 1), "acc": np.array([rank, 2.0 * rank]),
                "steps": 10}
        avg.on_epoch_end(epoch, logs)
        met.on_epoch_end(epoch, logs)
        out["logs"].append({k: v.tolist() if isinstance(v, np.ndarray) else v
                            for k, v in logs.items()})
    # The snapshot this rank hands on_train_end's gather: taken after the
    # gather, it would also count the gather itself.
    out["snapshot"] = hvd.metrics.snapshot()
    met.on_train_end()
    out["pod_on_rank"] = met.pod_snapshot is not None
    mixed = callbacks.average_metrics({"t": torch.tensor([1.0, 3.0]) * (rank + 1),
                                       "n": np.float32(rank)})
    out["mixed"] = {"t": [str(mixed["t"].dtype), mixed["t"].tolist()],
                    "n": [type(mixed["n"]).__name__, float(mixed["n"])]}
    hvd.shutdown()
    with open(f"{os.environ['CB_OUT']}.{rank}.json", "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
