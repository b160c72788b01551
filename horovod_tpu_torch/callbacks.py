"""Training-loop callbacks — the reference's Keras-callback set
(horovod/_keras/callbacks.py) for a PyTorch loop: the counterpart of
``horovod_tpu.callbacks``.

- :func:`warmup_schedule`: the gradual warmup as a plain ``step -> lr``
  callable, the values of the JAX package's optax schedule;
- :func:`average_metrics` and :class:`MetricAverageCallback`: epoch-end
  metrics averaged over the ranks;
- :class:`BroadcastGlobalVariablesCallback`: root's model and optimizer
  state at train begin (``broadcast_parameters`` /
  ``broadcast_optimizer_state``);
- :class:`MetricsCallback`: epochs and steps per second in the port's
  ``metrics.registry()``, and at train end every rank's snapshot gathered
  (``allgather_object``) and merged pod-wide on rank 0;
- :class:`LearningRateScheduleCallback` and
  :class:`LearningRateWarmupCallback`: the lr of a ``torch.optim``
  optimizer per epoch, warmup factor ``1 + epoch * (size - 1) / warmup``,
  with momentum correction (each ``momentum_buffer`` scaled by new lr /
  old lr).

The callbacks take the Keras protocol (on_train_begin/end,
on_epoch_begin/end), which any loop can drive.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import metrics as hvd_metrics
from . import optimizer as hvd_opt
from .common import basics
from .parallel import collectives
from .parallel.collectives import ReduceOp


def warmup_schedule(base_lr: float, warmup_epochs: float, steps_per_epoch: int,
                    size: Optional[int] = None,
                    after: Optional[Callable[[int], float]] = None
                    ) -> Callable[[int], float]:
    """``step -> lr``: the reference's gradual warmup (Goyal et al.;
    _keras/callbacks.py:145-161), from base_lr to size * base_lr over
    ``warmup_epochs``, then ``after(step - warmup_steps)`` or size * base_lr
    held. Set it on the optimizer each step (``group["lr"] = sched(step)``)."""
    n = size if size is not None else basics.size()
    if warmup_epochs <= 0:
        # no warmup: constant target (or the post schedule) from step 0
        def no_warmup(step):
            return after(step) if after is not None else base_lr * n

        return no_warmup
    warmup_steps = max(int(warmup_epochs * steps_per_epoch), 1)

    def schedule(step):
        # reference: lr = base * 1/size * (epoch*(size-1)/warmup + 1), where
        # base is already scaled by size; with unscaled base_lr this is
        # base_lr * (1 + epoch*(size-1)/warmup), capped at base_lr*size.
        if step < warmup_steps:
            epoch = step / steps_per_epoch
            return min(base_lr * (1.0 + epoch * (n - 1) / warmup_epochs), base_lr * n)
        return after(step - warmup_steps) if after is not None else base_lr * n

    return schedule


def average_metrics(metrics: Dict[str, Any], name_prefix: str = "metric.") -> Dict[str, Any]:
    """Each metric averaged over the ranks in float64, one allreduce per
    key in sorted order (the reference's MetricAverageCallback at epoch
    end). A Python scalar comes back as its type, a tensor as a float64
    tensor on its device, anything else as a float64 numpy array.
    ``name_prefix`` is accepted as the JAX package's is."""
    dev = basics.device()
    out = {}
    for key in sorted(metrics.keys()):
        v = metrics[key]
        t = (v.detach() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
        red = collectives.allreduce_(t.to(dev, torch.float64, copy=True),
                                     ReduceOp.AVERAGE)
        if np.isscalar(v):
            out[key] = type(v)(red.item())
        elif torch.is_tensor(v):
            out[key] = red.to(v.device)
        else:
            out[key] = red.cpu().numpy()
    return out


class Callback:
    """Keras-protocol callback base: any loop can drive these."""

    def on_train_begin(self, logs: Optional[dict] = None) -> None: ...

    def on_train_end(self, logs: Optional[dict] = None) -> None: ...

    def on_epoch_begin(self, epoch: int, logs: Optional[dict] = None) -> None: ...

    def on_epoch_end(self, epoch: int, logs: Optional[dict] = None) -> None: ...


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast model (and optimizer) state from root at train begin
    (reference _keras/callbacks.py:20-30): the checkpoint-resume
    consistency contract."""

    def __init__(self, model, root_rank: int = 0, optimizer=None) -> None:
        self.model = model
        self.optimizer = optimizer
        self.root_rank = root_rank

    def on_train_begin(self, logs: Optional[dict] = None) -> None:
        if self.model is not None:
            hvd_opt.broadcast_parameters(self.model.state_dict(), self.root_rank)
        if self.optimizer is not None:
            hvd_opt.broadcast_optimizer_state(self.optimizer, self.root_rank)


class MetricAverageCallback(Callback):
    """Replace epoch-end metrics with their cross-rank average in place
    (reference _keras/callbacks.py:33-67)."""

    def on_epoch_end(self, epoch: int, logs: Optional[dict] = None) -> None:
        if logs:
            logs.update(average_metrics(logs, name_prefix=f"ep{epoch}.metric."))


class MetricsCallback(Callback):
    """The telemetry registry through the training loop:

    - per epoch: a ``horovod_steps_per_sec`` gauge (from ``logs['steps']``
      when the loop provides it, else epochs/sec) and an epoch counter;
    - at train end: every rank's snapshot is gathered
      (``allgather_object``) and rank 0 merges them into the pod-wide view
      (``metrics.merge_snapshots``), stored on ``self.pod_snapshot`` and
      optionally written to ``snapshot_path``.
    """

    def __init__(self, snapshot_path: Optional[str] = None,
                 aggregate: bool = True) -> None:
        self.snapshot_path = snapshot_path
        self.aggregate = aggregate
        self.pod_snapshot: Optional[dict] = None
        self._epoch_t0: Optional[float] = None
        self._clock = time.monotonic

    def on_epoch_begin(self, epoch: int, logs: Optional[dict] = None) -> None:
        self._epoch_t0 = self._clock()

    def on_epoch_end(self, epoch: int, logs: Optional[dict] = None) -> None:
        reg = hvd_metrics.registry()
        reg.counter("horovod_epochs_total",
                    help="training epochs completed").inc()
        if self._epoch_t0 is None:
            return
        dt = max(self._clock() - self._epoch_t0, 1e-9)
        steps = (logs or {}).get("steps")
        rate = (steps / dt) if steps else (1.0 / dt)
        reg.gauge("horovod_steps_per_sec",
                  help="training steps (or epochs, when the loop reports "
                       "no step count) per second, latest epoch").set(rate)

    def on_train_end(self, logs: Optional[dict] = None) -> None:
        snap = hvd_metrics.snapshot()
        if self.aggregate and basics.size() > 1:
            snaps = collectives.allgather_object(snap, name="metrics.final_snapshot")
        else:
            snaps = [snap]
        if basics.rank() == 0:
            self.pod_snapshot = hvd_metrics.merge_snapshots(snaps)
            if self.snapshot_path:
                with open(self.snapshot_path, "w") as f:
                    json.dump(self.pod_snapshot, f, indent=2)


class LearningRateScheduleCallback(Callback):
    """Multiply the optimizer lr by ``multiplier(epoch)`` within
    [start_epoch, end_epoch) (reference _keras/callbacks.py:70-127), at
    epoch granularity. ``optimizer``: a ``torch.optim`` optimizer."""

    def __init__(self, optimizer, multiplier: Callable[[float], float],
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 momentum_correction: bool = True) -> None:
        self.optimizer = optimizer
        self.multiplier = multiplier
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.momentum_correction = momentum_correction
        self._base_lrs = [g["lr"] for g in optimizer.param_groups]

    def _adjust(self, epoch: float) -> None:
        mult = self.multiplier(epoch)
        old_lrs = [g["lr"] for g in self.optimizer.param_groups]
        for group, base in zip(self.optimizer.param_groups, self._base_lrs):
            group["lr"] = base * mult
        # Momentum correction (reference _keras/callbacks.py:106-118): scale
        # the momentum buffer by new_lr/old_lr so the effective update stays
        # smooth across lr changes.
        if self.momentum_correction:
            for group, old in zip(self.optimizer.param_groups, old_lrs):
                if "momentum" not in group or old == 0:
                    continue
                scale = group["lr"] / old
                for p in group["params"]:
                    state = self.optimizer.state.get(p)
                    if state and state.get("momentum_buffer") is not None:
                        state["momentum_buffer"].mul_(scale)

    def on_epoch_begin(self, epoch: int, logs: Optional[dict] = None) -> None:
        if epoch < self.start_epoch:
            return
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return
        self._adjust(float(epoch))


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual warmup from lr to lr*size over ``warmup_epochs`` (reference
    _keras/callbacks.py:131-168, Goyal et al. 2017)."""

    def __init__(self, optimizer, warmup_epochs: float = 5, verbose: bool = False,
                 size: Optional[int] = None, momentum_correction: bool = True) -> None:
        self.size = size if size is not None else basics.size()
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

        def multiplier(epoch: float) -> float:
            if epoch >= warmup_epochs:
                return float(self.size)
            return 1.0 + epoch * (self.size - 1) / warmup_epochs

        super().__init__(optimizer, multiplier, start_epoch=0,
                         end_epoch=None, momentum_correction=momentum_correction)

    def on_epoch_end(self, epoch: int, logs: Optional[dict] = None) -> None:
        if self.verbose and epoch < self.warmup_epochs and basics.rank() == 0:
            lr = self.optimizer.param_groups[0]["lr"]
            print(f"Epoch {epoch + 1}: warmup lr -> {lr:.6f}")
